"""The plain forms of the matchlen and byte-histogram kernels against the
JAX package's Pallas kernels, run in interpret mode on the CPU, and
against a Python lcp loop / ``np.bincount``; ``token_histogram`` against
``token_histogram_jax``. Tolerance: exact (integer counts)."""

import numpy as np
import pytest
import torch

from zultra_tpu.ops.histogram import byte_histogram_pallas, token_histogram_jax
from zultra_tpu.ops.matchlen import match_lengths_pallas
from zultra_tpu_torch import ops
from zultra_tpu_torch.ops import matchlen_cuda
from zultra_tpu_torch.ops.histogram_cuda import byte_histogram, token_histogram
from zultra_tpu_torch.ops.matchlen_cuda import match_lengths

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _lcp_loop(data: bytes, pos, prev) -> np.ndarray:
    n = len(data)
    out = []
    for i, j in zip(pos.tolist(), prev.tolist()):
        l = 0
        while i + l < n and j + l < n and data[i + l] == data[j + l] and l < 258:
            l += 1
        out.append(l)
    return np.array(out, np.int32)


def _pairs(name: str):
    """(data uint8, pos int32, prev int32) of one seeded case."""
    rng = np.random.RandomState(sum(name.encode()))
    data = rng.randint(0, 4, 3000).astype(np.uint8)
    n = len(data)
    if name == "alphabet4":
        pos = rng.randint(1, n, 300)
        prev = np.clip(pos - rng.randint(1, 500, 300), 0, None)
    elif name == "pos_eq_prev":
        pos = np.concatenate([rng.randint(0, n, 40), [0, n - 1, n - 2, n - 258, n - 259, n - 300]])
        prev = pos.copy()
    elif name == "near_end":
        pos = rng.randint(n - 258, n, 120)
        prev = np.clip(pos - rng.randint(1, 60, 120), 0, None)
        # both orders: the later index sets the cap either way
        pos, prev = np.concatenate([pos, prev]), np.concatenate([prev, pos])
    elif name == "long_run":
        data[1000:1400] = 2  # a 400-byte run: lengths cap at 258
        pos = np.concatenate([np.arange(1001, 1400, 7), [1399, 1200, 1143, 1142]])
        prev = np.concatenate([np.arange(1000, 1399, 7), [1000, 1000, 1000, 1000]])
    else:  # "P<k>": k random pairs, across the TPU's 256-pair tile
        k = int(name[1:])
        pos = rng.randint(0, n, k)
        prev = rng.randint(0, n, k)
        data[:] = rng.randint(0, 2, n)  # binary: long matches anywhere
    return data, pos.astype(np.int32), prev.astype(np.int32)


CASES = ["alphabet4", "pos_eq_prev", "near_end", "long_run", "P1", "P255", "P256", "P257"]


@pytest.mark.parametrize("name", CASES)
def test_match_lengths_equal_pallas(name):
    data, pos, prev = _pairs(name)
    got = match_lengths(torch.from_numpy(data), torch.from_numpy(pos), torch.from_numpy(prev))
    assert got.dtype == torch.int32 and got.shape == pos.shape
    want = match_lengths_pallas(data, pos, prev, interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _lcp_loop(data.tobytes(), pos, prev))
    if name == "long_run":
        assert got.max() == 258
    if name == "pos_eq_prev":
        np.testing.assert_array_equal(got.numpy(), np.minimum(len(data) - pos, 258))


def test_match_lengths_plain_chunks(monkeypatch):
    """The plain form's chunking (64 pairs per gather here) changes no
    length; a cap of 0 (pos at or past the end) gives 0."""
    data, pos, prev = _pairs("P257")
    pos[:3] = [len(data), len(data) + 5, len(data) - 1]
    want = _lcp_loop(data.tobytes(), pos, prev)
    monkeypatch.setattr(matchlen_cuda, "PLAIN_CHUNK", 64)
    got = match_lengths(torch.from_numpy(data), torch.from_numpy(pos), torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:2].tolist() == [0, 0]


@pytest.mark.parametrize("n_symbols", [256, 200, 300])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 10000])
def test_byte_histogram_equals_pallas(n, n_symbols):
    data = np.random.RandomState(n + n_symbols).randint(0, 256, n).astype(np.uint8)
    got = byte_histogram(torch.from_numpy(data), n_symbols)
    assert got.dtype == torch.int64 and got.shape == (n_symbols,)
    want = byte_histogram_pallas(data, n_symbols, interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.bincount(data[data < n_symbols], minlength=n_symbols)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_symbols,lo,hi", [(288, 0, 288), (30, -3, 40)])
def test_token_histogram_equals_jax(n_symbols, lo, hi):
    """In-range symbols, and symbols outside [0, n_symbols) that count
    nowhere (an all-zero one-hot row)."""
    syms = np.random.RandomState(n_symbols).randint(lo, hi, 5000).astype(np.int32)
    got = token_histogram(torch.from_numpy(syms), n_symbols)
    want = np.asarray(token_histogram_jax(syms, n_symbols))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_forms_launch_nothing():
    """CPU tensors run the plain forms: the kernels' counters stay 0, and
    both counters are listed by ``ops.launch_counts``."""
    ops.reset_launch_counts()
    data, pos, prev = _pairs("P255")
    match_lengths(torch.from_numpy(data), torch.from_numpy(pos), torch.from_numpy(prev))
    byte_histogram(torch.from_numpy(data))
    counts = ops.launch_counts()
    assert counts["matchlen"] == 0 and counts["hist"] == 0
