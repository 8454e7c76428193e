"""The walk kernel's chunk-parallel schedule, as its plain model
(``walk_cuda.walk_chunks_model``: a sweep that builds each chunk's
canonical state from the tree, the park rule, then every chunk walked
from its own table), against the literal walk (``walk_segments_plain``,
every position from 0) and, on two inputs, the JAX package's Pallas walk
in interpret mode. Inputs are segments of the uniform [halo | core |
tail] layout: lz data, all zeros and a period-3 run (deep trees), random
bytes and repeated fragments, with chunk sizes of 1, 7, 64 and the whole
core, halos of 0 and not, cores that no chunk size divides and a core
shorter than a chunk; one case at the real geometry. Every array is
integer: tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu.ops.walk_pallas import walk_core_kernel
from zultra_tpu_torch.corpus import lz_data
from zultra_tpu_torch.ops import walk_cuda
from zultra_tpu_torch.ops.matchfinder_torch import HALO, SEG_CORE, TAIL, salcp_batch

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _data(kind, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "lz":
        return lz_data(m, seed=seed, alpha=16)
    if kind == "zeros":
        return np.zeros(m, np.uint8)
    if kind == "period3":
        return np.resize(np.array([7, 7, 9], np.uint8), m)
    if kind == "random":
        return rng.integers(0, 256, m).astype(np.uint8)
    return np.resize(rng.integers(0, 256, 37).astype(np.uint8), m)  # repeated fragments


def _salcp(data, n):
    buf = 256 + np.arange(n, dtype=np.int32)
    buf[: len(data)] = data[:n]
    return salcp_batch(torch.from_numpy(buf[None]))


KINDS = ["lz", "zeros", "period3", "random", "fragments"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("halo,core,chunk", [
    (0, 1500, 1), (0, 1500, 7), (0, 1500, 64), (0, 1500, 1500),
    (700, 1101, 1), (700, 1101, 7), (700, 1101, 64), (700, 1101, 1101),
    (1200, 50, 64),  # a core shorter than a chunk
])
def test_model_equals_plain(kind, halo, core, chunk):
    """n = halo + core + 258 words of ``kind`` data; 1101 and 1500 are no
    multiple of 7 or 64, so the last chunk is cut short."""
    n = halo + core + 258
    salcp = _salcp(_data(kind, n - 40, seed=len(kind) + halo + chunk), n)
    want = walk_cuda.walk_segments_plain(salcp, halo, core)
    got = walk_cuda.walk_chunks_model(salcp, halo, core, chunk)
    assert torch.equal(got, want)
    assert int(want.count_nonzero()) > 0 or kind == "random"


@pytest.mark.parametrize("kind,chunk", [("lz", 64), ("period3", 7)])
def test_model_equals_pallas_walk(kind, chunk):
    """The model's rows equal the Pallas walk's (interpret mode, as
    tests/test_torch_kernels.py runs it) on a [1024 | 2048 | 1024] segment."""
    n, halo, core = 4096, 1024, 2048
    buf = 256 + np.arange(n, dtype=np.int32)
    buf[: halo + core + 258] = _data(kind, halo + core + 258, seed=7)
    lens_j, offs_j, _ = walk_core_kernel(jnp.asarray(buf), n, halo, core, True)
    rows = walk_cuda.walk_chunks_model(salcp_batch(torch.from_numpy(buf[None])), halo, core,
                                       chunk)[0]
    np.testing.assert_array_equal(np.asarray(lens_j), (rows >> 16).numpy())
    np.testing.assert_array_equal(np.asarray(offs_j), (rows & 0xFFFF).numpy())


def test_model_real_geometry():
    """One segment as the main path cuts it (n = 65,794, halo and core of
    32,768, the kernel's chunk of 4096) on lz data: offsets above 32,768
    are skipped, and some rows reach it."""
    n = HALO + SEG_CORE + TAIL
    salcp = _salcp(lz_data(n, seed=11, alpha=8, p_match=0.5), n)
    want = walk_cuda.walk_segments_plain(salcp, HALO, SEG_CORE)
    got = walk_cuda.walk_chunks_model(salcp, HALO, SEG_CORE, walk_cuda.CHUNK)
    assert torch.equal(got, want)
    offs = want & 0xFFFF
    assert int(offs.max()) > 30000


def test_cpu_wrapper_and_scratch():
    """A CPU tensor takes the plain walk; the scratch is the phase-0 table
    and one per chunk, 2n words each, and a word per segment."""
    n = 3000
    salcp = _salcp(_data("lz", n, seed=3), n)
    assert torch.equal(walk_cuda.walk_segments(salcp, 500, 2000),
                       walk_cuda.walk_segments_plain(salcp, 500, 2000))
    assert walk_cuda.n_chunks(SEG_CORE, walk_cuda.CHUNK) == 8
    assert walk_cuda.scratch_bytes(128, 65794, SEG_CORE, 4096) == 4 * 128 * (9 * 2 * 65794 + 1)
    with pytest.raises(ValueError):
        walk_cuda.n_chunks(100, 0)
