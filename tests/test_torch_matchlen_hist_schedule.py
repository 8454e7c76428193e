"""The matchlen and byte-histogram kernels' schedules, as their plain
models (``matchlen_cuda.match_lengths_model``: a thread per pair over
the head's aligned words, a block queue, a warp per queued pair;
``histogram_cuda.byte_histogram_model``: the head, body and tail
partition of the bytes across blocks and the grid reduction), against
the plain forms and the JAX package's Pallas kernels in interpret mode.

Matchlen's edge cases: every p mod 16 and q mod 16 at every data base
mod 16; match lengths ending at K - 1, K and K + 1 of the kernel's head
width K = 16; at 258 and at the 259 cap; pos == prev; negative
indices and indices >= n; pairs whose span reaches n. The histogram's:
n = 0, 1, 15, 16, 17 and one block step of words +- 1, every base mod
16, n_symbols 1, 255, 256, 257 and 300, grids of 1 to 33 blocks, and a
buffer of one byte value. Each case asserts the counters of the paths
its model took. Every value is an integer: tolerance is exact equality.
"""

import functools

import numpy as np
import pytest
import torch

from zultra_tpu.ops.histogram import byte_histogram_pallas
from zultra_tpu.ops.matchlen import match_lengths_pallas
from zultra_tpu_torch.ops import histogram_cuda, matchlen_cuda

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


@functools.lru_cache(maxsize=None)
def _pairs():
    data, pos, prev = matchlen_cuda.edge_pairs()
    cap = np.minimum(len(data) - np.maximum(pos.astype(np.int64), prev), 259)
    return data, pos, prev, np.where((pos < 0) | (prev < 0) | (cap < 0), 0, cap)


@functools.lru_cache(maxsize=None)
def _plain():
    data, pos, prev, _ = _pairs()
    return matchlen_cuda.match_lengths_plain(*map(torch.from_numpy, (data, pos, prev)))


def _lcp_loop(data: np.ndarray, pos, prev) -> list:
    n = len(data)
    out = []
    for i, j in zip(pos.tolist(), prev.tolist()):
        length = 0
        if i >= 0 and j >= 0:
            while i + length < n and j + length < n and length < 258 \
                    and data[i + length] == data[j + length]:
                length += 1
        out.append(length)
    return out


def test_match_pairs_cover_the_edges():
    """The planted buffer holds what the cases promise: each edge length
    at every residue pair, 258 from both a 258 and a 259+ match, spans
    cut by the end, and the plain form equal to a Python lcp loop on the
    long, end, pos == prev and out-of-range pairs."""
    data, pos, prev, cap = _pairs()
    want = _plain().numpy()
    n_edge = len(matchlen_cuda.EDGE_LENGTHS) * 256
    np.testing.assert_array_equal(want[:n_edge], np.repeat(matchlen_cuda.EDGE_LENGTHS, 256))
    long = np.minimum(np.repeat(matchlen_cuda.LONG_LENGTHS, 32), 258)
    np.testing.assert_array_equal(want[n_edge : n_edge + long.size], long)
    rest = slice(n_edge, None)
    assert want[rest].tolist() == _lcp_loop(data, pos[rest], prev[rest])
    ends = slice(len(want) - 8 - 25 - 18, len(want) - 8 - 25)
    np.testing.assert_array_equal(want[ends], np.minimum(cap[ends], 258))
    np.testing.assert_array_equal(
        cap[ends], [1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 258, 259, 259, 259])
    np.testing.assert_array_equal(want[-8:], np.zeros(8))


def test_match_lengths_plain_equals_pallas():
    """The plain form against the Pallas kernel in interpret mode on
    every pair it takes (no negative index: its load is undefined)."""
    data, pos, prev, _ = _pairs()
    ok = (pos >= 0) & (prev >= 0)
    want = match_lengths_pallas(data, pos[ok], prev[ok], interpret=True)
    np.testing.assert_array_equal(_plain().numpy()[ok], want)


@pytest.mark.parametrize("first_base", [0, 4, 8, 12])
def test_match_lengths_model_every_alignment(first_base):
    """The model at every base mod 16 (four a case) equals the plain
    form; its path counts follow from the lengths: a pair is queued
    exactly when its match reaches K bytes below its cap."""
    data, pos, prev, cap = _pairs()
    args = [torch.from_numpy(a) for a in (data, pos, prev)]
    want = _plain()
    length = want.numpy()
    head = matchlen_cuda.HEAD
    for base_mod in range(first_base, first_base + 4):
        got, counts = matchlen_cuda.match_lengths_model(*args, base_mod=base_mod)
        assert torch.equal(got, want), f"base mod 16 = {base_mod}"
        assert counts["pairs"] == len(pos)
        assert counts["no_span"] == int((cap <= 0).sum())
        assert counts["queued"] == int(((length >= head) & (cap > head)).sum())
        assert counts["head_done"] + counts["queued"] + counts["no_span"] == len(pos)
        assert counts["at_258"] == int((length == 258).sum())
        assert counts["at_cap"] >= 18 + 25
        assert 0 < counts["max_block_queue"] <= matchlen_cuda.THREADS


def test_match_lengths_model_reads_stay_in_bounds():
    """A buffer of one byte value at lengths 1..40 (every pair matches to
    its cap): the model's loads stop at the aligned word of data[n - 1]
    at every base, and bytes past n never lengthen a match (the model
    fills them with the same poison on both sides)."""
    for n in range(1, 41):
        data = torch.full((n,), 7, dtype=torch.uint8)
        pos = torch.arange(n, dtype=torch.int32)
        prev = torch.zeros(n, dtype=torch.int32)
        want = matchlen_cuda.match_lengths_plain(data, pos, prev)
        assert want.tolist() == [n - i for i in range(n)]
        for base_mod in range(16):
            got, _ = matchlen_cuda.match_lengths_model(data, pos, prev, base_mod)
            assert torch.equal(got, want), (n, base_mod)


HIST_SIZES = [0, 1, 15, 16, 17, histogram_cuda.STEP * 16 - 1, histogram_cuda.STEP * 16,
              histogram_cuda.STEP * 16 + 1]


@pytest.mark.parametrize("n", HIST_SIZES)
def test_byte_histogram_model_every_base(n):
    """Every base mod 16 on grids of 1, 2 and 3 blocks: the model equals
    the plain form, and its partition adds up (head < 16, tail < 16, the
    body in whole words)."""
    data = torch.from_numpy(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    want = histogram_cuda.byte_histogram_plain(data, 256)
    for base_mod in range(16):
        for grid in (1, 2, 3):
            got, counts = histogram_cuda.byte_histogram_model(data, 256, grid, base_mod)
            assert torch.equal(got, want), (base_mod, grid)
            assert counts["head_bytes"] + counts["body_bytes"] + counts["tail_bytes"] == n
            assert counts["head_bytes"] == min((16 - base_mod) % 16, n)
            assert counts["body_bytes"] % 16 == 0 and counts["tail_bytes"] < 16
            assert counts["byte_adds"] + 16 * counts["run_words"] == n


@pytest.mark.parametrize("n_symbols", [1, 255, 256, 257, 300])
def test_byte_histogram_model_equals_pallas(n_symbols):
    """n_symbols below, at and above 256 (bins from 256 up are written
    as 0 by the last block), on one to 33 blocks, against the Pallas
    kernel in interpret mode."""
    n = 3 * histogram_cuda.STEP * 16 + 77
    data = np.random.default_rng(n_symbols).integers(0, 256, n, dtype=np.uint8)
    want = byte_histogram_pallas(data, n_symbols, interpret=True)
    x = torch.from_numpy(data)
    np.testing.assert_array_equal(histogram_cuda.byte_histogram_plain(x, n_symbols).numpy(), want)
    for grid, base_mod in ((1, 0), (2, 5), (3, 15), (4, 1), (33, 8)):
        got, counts = histogram_cuda.byte_histogram_model(x, n_symbols, grid, base_mod)
        np.testing.assert_array_equal(got.numpy(), want)
        assert counts["blocks_with_work"] == min(grid, 4)


def test_byte_histogram_model_one_value():
    """Every byte the same value (one bin takes all): every body word is
    a run, and each thread adds its run once; then runs whose value
    changes from each of a thread's words to its next (every THREADS
    words), so that it adds at every word."""
    n = 5 * histogram_cuda.STEP * 16 + 9
    data = torch.full((n,), 200, dtype=torch.uint8)
    got, counts = histogram_cuda.byte_histogram_model(data, 256, 2, 3)
    assert got[200] == n and int(got.sum()) == n
    np.testing.assert_array_equal(got.numpy(), byte_histogram_pallas(data.numpy(), 256,
                                                                      interpret=True))
    assert counts["run_words"] == counts["body_bytes"] // 16
    assert counts["run_adds"] == 2 * histogram_cuda.THREADS
    assert counts["byte_adds"] == counts["head_bytes"] + counts["tail_bytes"] == 25
    value = np.arange(n // 16 + 1) // histogram_cuda.THREADS % 2 * 9
    stripes = torch.from_numpy(np.repeat(value, 16)[:n].astype(np.uint8))
    got, counts = histogram_cuda.byte_histogram_model(stripes, 256, 3, 0)
    assert torch.equal(got, histogram_cuda.byte_histogram_plain(stripes, 256))
    assert counts["run_adds"] == counts["run_words"] == n // 16


def test_byte_histogram_grid_for():
    """The grid: one block step of words each, capped at the resident
    blocks, at least one block (n = 0 still launches once)."""
    step = histogram_cuda.STEP
    assert histogram_cuda.grid_for(0, 1056) == 1
    assert histogram_cuda.grid_for(step, 1056) == 1
    assert histogram_cuda.grid_for(step + 1, 1056) == 2
    assert histogram_cuda.grid_for((4 << 20) // 16, 1056) == 256
    assert histogram_cuda.grid_for((64 << 20) // 16, 1056) == 1056
    assert histogram_cuda.split(100, 3) == (13, 5)
    assert histogram_cuda.split(5, 3) == (5, 0)
