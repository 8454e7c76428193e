"""The plain PyTorch forms of the port's three kernels — the lazy walk,
the cost DP and the token chain — against the JAX package's functions
on the CPU, on numpy-seeded inputs. The JAX side runs as its own tests
run it: the walk and DP Pallas kernels in interpret mode, the chain as
its pointer-doubling mask and its Pallas kernel in interpret mode. Every
array is integer: tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu.constants import NMATCHES_PER_OFFSET
from zultra_tpu.matchfinder import find_all_matches
from zultra_tpu.ops.block_jax import _chain_mask, _run_dp
from zultra_tpu.ops.chain_pallas import chain_marks_pallas
from zultra_tpu.ops.dp_pallas import run_dp_pallas
from zultra_tpu.ops.walk_pallas import walk_core_kernel
from zultra_tpu_torch.corpus import lz_data
from zultra_tpu_torch.ops import chain_cuda, dp_cuda, walk_cuda
from zultra_tpu_torch.ops.matchfinder_torch import salcp_batch

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _segment(data, n):
    buf = 256 + np.arange(n, dtype=np.int32)
    buf[: len(data)] = data
    return buf


def _walk_port(buf, halo, core):
    rows = walk_cuda.walk_segments_plain(salcp_batch(torch.from_numpy(buf[None])), halo, core)[0]
    return (rows >> 16).numpy(), (rows & 0xFFFF).numpy()


@pytest.mark.parametrize("kind", ["lz", "zeros", "period3"])
def test_walk_plain_equals_pallas_walk(kind):
    """Segment layout [halo | core | tail]: rows of the core equal the
    Pallas walk's (interpret mode), including the all-zeros and
    short-period runs where the JAX staircase needs its host fallback."""
    n, halo, core = 4096, 1024, 2048
    if kind == "lz":
        data = lz_data(halo + core + 258, seed=7, alpha=64)
    elif kind == "zeros":
        data = np.zeros(halo + core + 258, np.uint8)
    else:
        data = np.tile(np.array([7, 7, 9], np.uint8), 1200)[: halo + core + 258]
    buf = _segment(data, n)
    lens_j, offs_j, _ = walk_core_kernel(jnp.asarray(buf), n, halo, core, True)
    lens_t, offs_t = _walk_port(buf, halo, core)
    np.testing.assert_array_equal(np.asarray(lens_j), lens_t)
    np.testing.assert_array_equal(np.asarray(offs_j), offs_t)


def test_walk_plain_equals_spec_walk():
    data = lz_data(3000, seed=3, alpha=40)
    ref = find_all_matches(data.copy(), 0, len(data))
    lens_t, offs_t = _walk_port(_segment(data, 3072), 0, len(data))
    np.testing.assert_array_equal(ref[:, :, 0], lens_t)
    np.testing.assert_array_equal(ref[:, :, 1], offs_t)


def _dp_case(seed, B, n_pad):
    """Random block lanes with match tables from the spec walk and code
    lengths in the planner's range (zeros replaced by 9/6)."""
    rng = np.random.default_rng(seed)
    window = np.zeros((B, n_pad), np.uint8)
    mlens = np.zeros((B, n_pad, NMATCHES_PER_OFFSET), np.int32)
    moffs = np.zeros_like(mlens)
    length = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(n_pad // 2, n_pad + 1)) if b % 3 else n_pad
        data = lz_data(ln, seed=seed * 10 + b, alpha=int(rng.integers(3, 200)), p_match=0.5)
        table = find_all_matches(data.copy(), 0, ln)
        window[b, :ln] = data
        mlens[b, :ln] = table[:, :, 0]
        moffs[b, :ln] = table[:, :, 1]
        length[b] = ln
    ll = rng.integers(4, 16, (B, 288)).astype(np.int32)
    ol = rng.integers(2, 16, (B, 32)).astype(np.int32)
    return ll, ol, window, mlens, moffs, length


@pytest.mark.parametrize("seed", [0, 1])
def test_dp_plain_equals_pallas_and_scan(seed):
    n_pad = 4096  # the scan DP's tile
    args = _dp_case(seed, 5, n_pad)
    jargs = [jnp.asarray(a) for a in args]
    want_len, want_off = run_dp_pallas(*jargs, n_pad, interpret=True)
    scan_len, scan_off = _run_dp(*jargs, n_pad)
    got_len, got_off = dp_cuda.run_dp(*[torch.from_numpy(a) for a in args])
    for want, got in ((want_len, got_len), (want_off, got_off), (scan_len, got_len),
                      (scan_off, got_off)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _chain_case(seed, B, n):
    rng = np.random.default_rng(seed)
    step = np.where(rng.random((B, n)) < 0.4, rng.integers(3, 259, (B, n)), 1).astype(np.int32)
    start = rng.integers(0, 64, B).astype(np.int32)
    length = rng.integers(0, n + 1, B).astype(np.int32)
    length[0] = n
    return step, start, length


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_plain_equals_jax(seed):
    n = 3072  # the Pallas chain kernel takes multiples of its 256-row chunk
    step, start, length = _chain_case(seed, 6, n)
    got = chain_cuda.chain_marks_plain(*map(torch.from_numpy, (step, start, length))).numpy()
    want = np.asarray(chain_marks_pallas(jnp.asarray(step), jnp.asarray(start),
                                         jnp.asarray(length), n, interpret=True))
    np.testing.assert_array_equal(want, got)
    zero = np.zeros_like(start)
    want0 = np.asarray(_chain_mask(jnp.asarray(step), jnp.asarray(length), n))
    got0 = chain_cuda.chain_marks_plain(*map(torch.from_numpy, (step, zero, length))).numpy()
    np.testing.assert_array_equal(want0, got0)
