"""The chain kernel's segment-parallel schedule, as its plain model
(``chain_cuda.chain_segments_model``: speculate every segment from a
warm-up start below it, then resolve each lane's segments in order, with
the segment size and the warm-up as arguments), against the
pointer-doubling form (``chain_marks_plain``) and, once, the JAX
package's Pallas chain kernel in interpret mode and its doubling mask.
Inputs are the callers': greedy row-0 steps of the port's match tables
from the splitter's start, the DP's chosen steps of planner lanes with
ragged lengths, and seeded edge lanes. Every array is integer or bool:
tolerance is exact equality. Each case also asserts its status counts,
so that no case passes by re-walking everything."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu.ops.block_jax import _chain_mask
from zultra_tpu.ops.chain_pallas import chain_marks_pallas
from zultra_tpu_torch.corpus import mixed_corpus
from zultra_tpu_torch.ops import chain_cuda, dp_cuda
from zultra_tpu_torch.ops.chain_cuda import (
    ST_ANCHORED,
    ST_EXACT,
    ST_NONE,
    ST_RERUN,
    ST_UNMERGED,
)
from zultra_tpu_torch.ops.matchfinder_torch import HALO, match_tables_device_stacked

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _run(step, start, length, seg, warm):
    """The model's marks (checked equal to pointer doubling) and its
    status counts."""
    args = [torch.as_tensor(np.asarray(a, np.int32)) for a in (step, start, length)]
    got, st = chain_cuda.chain_marks(*args, status=True, seg=seg, warm=warm)
    assert torch.equal(got, chain_cuda.chain_marks_plain(*args))
    assert int(st.eq(chain_cuda.ST_SPECULATED).sum()) == 0
    vals = st.flatten().tolist()
    return st, {k: vals.count(k) for k in (ST_NONE, ST_EXACT, ST_ANCHORED, ST_RERUN, ST_UNMERGED)}


def _splitter_lanes():
    """Greedy steps of two 12 KiB windows' match tables (row 0), laid out
    as the splitter lays them: HALO history positions, then the window."""
    mbs = 12288
    corpus = np.frombuffer(mixed_corpus(2 * mbs, seed=21), np.uint8)
    spans = [(0, mbs), (mbs, 2 * mbs)]
    lens, _ = match_tables_device_stacked(corpus, spans, mbs, "cpu")
    rl = lens[:, :, 0]
    step = torch.where(rl >= 3, rl, 1).numpy()
    return step, [HALO, HALO], [HALO + mbs, HALO + mbs - 5]


@pytest.mark.parametrize("seg,warm,counts", [
    (1024, 512, {ST_NONE: 64, ST_EXACT: 2, ST_ANCHORED: 22, ST_RERUN: 0, ST_UNMERGED: 0}),
    (chain_cuda.SEG, chain_cuda.WARM, {ST_NONE: 256, ST_EXACT: 2, ST_ANCHORED: 94, ST_RERUN: 0,
                                       ST_UNMERGED: 0}),
    (300, 0, {ST_NONE: 218, ST_EXACT: 2, ST_ANCHORED: 15, ST_RERUN: 67, ST_UNMERGED: 0}),
])
def test_model_splitter_lanes(seg, warm, counts):
    """The splitter's form: start = HALO, the history below it unmarked
    (NONE); with a warm-up every segment above the first anchors; with
    none, a speculation starts on its segment's first position and most
    are re-walked, every one merging inside its segment."""
    st, c = _run(*_splitter_lanes(), seg, warm)
    assert c == counts


def _planner_lanes(seg, n=2048):
    """The DP's chosen steps (the planner's second pass on) of six lanes
    of mixed data with lengths 0, 1, seg - 1, seg, seg + 1 and n."""
    lengths = [0, 1, seg - 1, seg, seg + 1, n]
    corpus = np.frombuffer(mixed_corpus(len(lengths) * n, seed=23), np.uint8)
    lens, offs = match_tables_device_stacked(corpus, [(0, len(corpus))], len(corpus), "cpu")
    win = torch.from_numpy(corpus.copy()).view(len(lengths), n)
    ml = lens[0, HALO : HALO + len(corpus)].reshape(len(lengths), n, 8).contiguous()
    mo = offs[0, HALO : HALO + len(corpus)].reshape(len(lengths), n, 8).contiguous()
    rng = np.random.default_rng(seg)
    ll = torch.from_numpy(rng.integers(4, 16, (len(lengths), 288)).astype(np.int32))
    ol = torch.from_numpy(rng.integers(2, 16, (len(lengths), 32)).astype(np.int32))
    length = torch.tensor(lengths, dtype=torch.int32)
    best_len, _ = dp_cuda.run_dp(ll, ol, win, ml, mo, length)
    step = torch.where(best_len >= 3, best_len, 1).numpy()
    return step, [0] * len(lengths), lengths


@pytest.mark.parametrize("seg,warm,counts", [
    (1024, 512, {ST_NONE: 5, ST_EXACT: 5, ST_ANCHORED: 2, ST_RERUN: 0, ST_UNMERGED: 0}),
    (256, 0, {ST_NONE: 35, ST_EXACT: 5, ST_ANCHORED: 5, ST_RERUN: 3, ST_UNMERGED: 0}),
])
def test_model_planner_lanes_ragged(seg, warm, counts):
    """Each lane's marks stop below its length; the segments past it are
    NONE; the first segment of a lane starts at 0 and is EXACT. Without a
    warm-up, some speculations are re-walked."""
    step, start, lengths = _planner_lanes(seg)
    st, c = _run(step, start, lengths, seg, warm)
    for b, ln in enumerate(lengths):
        k = -(-ln // seg)
        assert st[b, k:].eq(ST_NONE).all()
        if k:
            assert st[b, 0] == ST_EXACT
    assert c == counts


def test_model_start_at_or_past_length():
    """start >= length: every segment NONE, nothing marked."""
    rng = np.random.default_rng(3)
    step = rng.integers(1, 9, (3, 1000))
    st, c = _run(step, [500, 999, 2000], [500, 10, 1000], 128, 64)
    assert c[ST_NONE] == 3 * 8


def test_model_start_inside_a_segment():
    """start = 2 seg + 37: the two segments below it are NONE, the one
    holding it EXACT; a few speculations are re-walked, one of them
    without merging."""
    rng = np.random.default_rng(4)
    step = np.where(rng.random((2, 4096)) < 0.3, rng.integers(3, 40, (2, 4096)), 1)
    st, c = _run(step, [2 * 256 + 37, 0], [4096, 4096], 256, 128)
    assert st[0, :2].tolist() == [ST_NONE, ST_NONE] and st[0, 2] == ST_EXACT
    assert c == {ST_NONE: 2, ST_EXACT: 2, ST_ANCHORED: 21, ST_RERUN: 6, ST_UNMERGED: 1}


def test_model_zero_run():
    """A 4 KiB zero run (greedy steps of 258 inside it) in mixed data:
    speculations inside the run land on other residues mod 258 and mostly
    do not merge; the data after it anchors again."""
    d = bytearray(mixed_corpus(8192, seed=5)[:8192])
    d[2048 : 2048 + 4096] = bytes(4096)
    corpus = np.frombuffer(bytes(d), np.uint8)
    lens, _ = match_tables_device_stacked(corpus, [(0, 8192)], 8192, "cpu")
    rl = lens[:, HALO:, 0]
    step = torch.where(rl >= 3, rl, 1).numpy()
    st, c = _run(step, [0], [8192], 512, 256)
    row = st[0].tolist()
    assert row[0] == ST_EXACT and row[-1] == ST_ANCHORED
    assert c == {ST_NONE: 0, ST_EXACT: 1, ST_ANCHORED: 8, ST_RERUN: 0, ST_UNMERGED: 7}


def test_model_all_threes():
    """Every step 3, seg 1024, warm 512: segment j's speculation starts
    at 1024 j - 512, on residue j + 1 mod 3; only j = 2 mod 3 anchors,
    the rest stay UNMERGED (the densest lane that does not merge)."""
    n = 64 * 1024
    st, c = _run(np.full((1, n), 3), [0], [n], 1024, 512)
    assert c == {ST_NONE: 0, ST_EXACT: 1, ST_ANCHORED: 21, ST_RERUN: 0, ST_UNMERGED: 42}
    assert [j for j in range(64) if st[0, j] == ST_ANCHORED] == list(range(2, 64, 3))


def test_model_equals_pallas_chain_and_doubling_mask():
    """The model's marks equal the Pallas chain kernel's (interpret mode)
    with per-lane starts and lengths, and the JAX doubling mask's from 0."""
    n = 2048  # the Pallas kernel takes multiples of its 256-row chunk
    rng = np.random.default_rng(8)
    step = np.where(rng.random((4, n)) < 0.4, rng.integers(3, 259, (4, n)), 1).astype(np.int32)
    step[3] = 3
    start = np.array([0, 37, 700, 0], np.int32)
    length = np.array([n, n - 300, 1500, n], np.int32)
    got, st = chain_cuda.chain_segments_model(
        *map(torch.from_numpy, (step, start, length)), seg=256, warm=128)
    want = chain_marks_pallas(jnp.asarray(step), jnp.asarray(start), jnp.asarray(length), n,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    zero = np.zeros_like(start)
    got0, _ = chain_cuda.chain_segments_model(
        *map(torch.from_numpy, (step, zero, length)), seg=256, warm=128)
    np.testing.assert_array_equal(np.asarray(_chain_mask(jnp.asarray(step), jnp.asarray(length),
                                                         n)), got0.numpy())
    assert int(st.eq(ST_UNMERGED).sum()) > 0 and int(st.eq(ST_ANCHORED).sum()) > 0
