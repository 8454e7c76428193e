"""The port's DP entry points (ops/parse_torch.py) on the CPU, the plain
forms of the lane preparation and the DP: ``optimize_matches`` and
``optimize_matches_batch`` against the JAX scan DP (parse_jax), the
tiled wavefront DP and its batched scan and wavefront forms
(parse_wavefront), with blocks that start past the window's history,
one lane longer than 2^20 and one of 2^21 random bytes whose parse costs
more than 2^24 bits. Choices are integers: exact equality."""

import numpy as np
import pytest
import torch

from zultra_tpu import native
from zultra_tpu.ops.parse_jax import optimize_matches_jax
from zultra_tpu.ops.parse_wavefront import (
    optimize_matches_wavefront,
    optimize_matches_wavefront_batch,
)
from zultra_tpu_torch import ops
from zultra_tpu_torch.corpus import lz_data, mixed_corpus, random_bytes
from zultra_tpu_torch.ops import dp_cuda, parse_torch

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _window(size: int, seed: int) -> np.ndarray:
    return np.frombuffer(mixed_corpus(size - size // 4, seed=seed)
                         + lz_data(size // 4, seed=seed + 1, alpha=6).tobytes(), np.uint8)


def _lengths(seed: int):
    """Seeded literal/length and offset code lengths, 1 to 15 bits."""
    rng = np.random.default_rng(seed)
    return (rng.integers(4, 14, 288).astype(np.int32), rng.integers(2, 12, 32).astype(np.int32))


def _job(size, start, seed):
    window = _window(size, seed)
    table = native.build_match_table(window, start).astype(np.int32)
    return (*_lengths(seed), window, table, start, size)


@pytest.mark.parametrize("size, start, seed", [(6000, 0, 1), (9000, 2500, 2), (12000, 4096, 3)])
def test_optimize_matches_equals_scan_and_wavefront(size, start, seed):
    job = _job(size, start, seed)
    got = parse_torch.optimize_matches(*job, device="cpu")
    assert got.shape == (size, 2) and got.dtype == np.int32
    assert not got[:start].any() and got[start:, 0].any()
    np.testing.assert_array_equal(got, optimize_matches_jax(*job))
    np.testing.assert_array_equal(got, optimize_matches_wavefront(*job))


@pytest.mark.parametrize("method", ["wavefront", "scan"])
def test_optimize_matches_batch_equals_wavefront_batch(method):
    """Three blocks of different lengths and code lengths in one batch (the
    shorter lanes padded), one with start 0 and two past their history."""
    jobs = [_job(7000, 1000, 4), _job(3000, 0, 5), _job(10000, 6000, 6)]
    got = parse_torch.optimize_matches_batch(jobs, device="cpu")
    want = optimize_matches_wavefront_batch(jobs, method=method)
    assert len(got) == len(want) == 3
    for g, w, job in zip(got, want, jobs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, parse_torch.optimize_matches(*job, device="cpu"))


def test_optimize_matches_empty_block_and_export():
    job = _job(4000, 0, 7)
    out = parse_torch.optimize_matches(*job[:4], 4000, 4000, device="cpu")
    assert out.shape == (4000, 2) and not out.any()
    assert parse_torch.optimize_matches_batch([], device="cpu") == []
    assert ops.optimize_matches is parse_torch.optimize_matches
    with pytest.raises(ValueError):
        parse_torch.optimize_matches(*job[:4], 10, 5, device="cpu")


def test_lane_above_seq_limit_equals_scan():
    """One block of 1,123,479 positions, past 2^20 (the largest block the
    JAX package's Pallas DP takes), on the plain form, against the scan
    DP."""
    size = 1_118_479 + 5000 + 100
    window = np.frombuffer(mixed_corpus(size, seed=9), np.uint8)
    table = native.build_match_table(window, 100).astype(np.int32)
    lit, off = _lengths(9)
    got = parse_torch.optimize_matches(lit, off, window, table, 100, size, device="cpu")
    np.testing.assert_array_equal(got, optimize_matches_jax(lit, off, window, table, 100, size))


def test_random_2m_lane_equals_scan():
    """One block of 2^21 random bytes (MAX_LANE, a 2 MiB block) under
    literal codes of 10 to 14 bits: its parse costs more than 2^24 bits,
    where the Pallas DP's clamp (2^24 - 1) would act. The plain form, like
    the kernel, clamps nothing, and its choices equal the scan DP's."""
    size = dp_cuda.MAX_LANE + 100
    window = np.frombuffer(random_bytes(size, 13), np.uint8)
    table = native.build_match_table(window, 100).astype(np.int32)
    rng = np.random.default_rng(13)
    lit = rng.integers(10, 15, 288).astype(np.int32)
    off = rng.integers(2, 12, 32).astype(np.int32)
    got = parse_torch.optimize_matches(lit, off, window, table, 100, size, device="cpu")
    np.testing.assert_array_equal(got, optimize_matches_jax(lit, off, window, table, 100, size))
    literals, p = 0, 100
    while p < size:  # the chosen parse's literals cost at least 10 bits each
        step = int(got[p, 0])
        literals += step == 0
        p += max(step, 1)
    assert 10 * literals > 1 << 24
