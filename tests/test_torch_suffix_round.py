"""The doubling round's kernel schedule, as its plain model
(``suffix_cuda.doubling_model``: the first round's counting sort of the
symbols, tiles of small groups cut at group boundaries and each ordered
by (group, rank_{i+k}), the large groups along Manber and Myers' order,
the dense re-rank, and the skip of a segment whose ranks are distinct,
with its copy of the ranks at a stored level), against the plain rounds
(``suffix_torch._round`` round by round, ``stored_rounds``,
``doubling_rounds_fixed`` and the early-exit ``doubling_rounds``) and the
JAX package's ``suffix_jax._doubling_rounds``.

Inputs: segments of 65,794 positions in the match program's layout
(bytes and unique sentinels) of text, mixed data and random bytes; the
segments of a 96 KiB zero run, one of them zeros alone (all 17 rounds,
a large group in each); an all-sentinel segment; rows of 65,536 bytes
zero-padded as ``parallel.sharded_corpus_stats`` makes them; and rows
whose groups end on the tiles' edges. Every array is integer: tolerance
is exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zultra_tpu.ops import suffix_jax
from zultra_tpu_torch.corpus import mixed_corpus, random_bytes, text_corpus
from zultra_tpu_torch.ops import matchfinder_torch as mt
from zultra_tpu_torch.ops import suffix_cuda, suffix_torch

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

TILE = suffix_cuda.TILE


def _segments(raw: bytes, count: int) -> torch.Tensor:
    """The first ``count`` segments of one window over ``raw`` (bytes and
    unique sentinels, as the match program cuts them)."""
    data = np.frombuffer(raw, np.uint8)
    bufs, _ = mt.build_segments(data, [(0, len(data))], mt.SEG_CORE)
    return torch.from_numpy(bufs[:count])


def _rows(kind: str) -> torch.Tensor:
    if kind == "text":
        return _segments(text_corpus(3 * mt.SEG_CORE, seed=5), 2)
    if kind == "mixed":
        return _segments(mixed_corpus(3 * mt.SEG_CORE, seed=6), 2)
    if kind == "random":
        return _segments(random_bytes(2 * mt.SEG_CORE, seed=7), 1)
    if kind == "zero run":  # as tests/test_torch_match_program.py cuts it
        raw = mixed_corpus(8000, seed=3) + bytes(3 << 15) + mixed_corpus(24000, seed=4)
        bufs = _segments(raw, 4)
        assert not bool(bufs[2].any())
        return bufs
    if kind == "sentinels":
        return torch.from_numpy(256 + np.arange(mt.SEG_LEN, dtype=np.int32))[None]
    if kind == "corpus windows":  # parallel.sharded_corpus_stats: bytes, zeros at the end
        rows = np.zeros((2, 1 << 16), np.uint8)
        rows[0] = np.frombuffer(text_corpus(1 << 16, seed=8), np.uint8)
        rows[1, :40000] = np.frombuffer(mixed_corpus(40000, seed=9), np.uint8)
        return torch.from_numpy(rows.astype(np.int32))
    raise ValueError(kind)


KINDS = ["text", "mixed", "random", "zero run", "sentinels", "corpus windows"]


def _plain_chain(rows: torch.Tensor):
    """Every round's plain ranks and flags, and the suffix order at the end."""
    rank, ranks, flags, sa = rows.to(torch.int32), [rows.to(torch.int32)], [], None
    for level in range(suffix_torch.num_levels(rows.shape[1])):
        sa, rank, distinct = suffix_torch._round(rank, 1 << level)
        ranks.append(rank)
        flags.append(distinct)
    return sa, torch.stack(ranks), torch.stack(flags)


@pytest.fixture(scope="module", params=KINDS)
def case(request):
    rows = _rows(request.param)
    stats = {}
    model = suffix_cuda.doubling_model(rows, None, stats)
    return request.param, rows, model, stats


def test_model_equals_every_plain_round(case):
    """Every round's ranks equal the plain round's (so every round's order
    does: a round's order is its ranks', ties by position), and the last
    order and flags too."""
    _, rows, (sa, ranks, distinct, _), _ = case
    sa_p, ranks_p, flags_p = _plain_chain(rows)
    assert torch.equal(ranks, ranks_p)
    assert torch.equal(sa, sa_p)
    assert torch.equal(distinct, flags_p[-1])


def test_rounds_run_is_the_first_distinct_round(case):
    kind, rows, (_, _, _, run), stats = case
    _, _, flags = _plain_chain(rows)
    levels = flags.shape[0]
    first = [next((lv + 1 for lv in range(levels) if flags[lv, s]), levels)
             for s in range(rows.shape[0])]
    assert run.tolist() == first
    assert stats["skipped"] == rows.shape[0] * levels - sum(first)
    if kind == "sentinels":
        assert first == [1]
    if kind == "text":  # no large group past the first round: every later round ranked in walk 1
        assert stats["fused"] == sum(first) - rows.shape[0]
    if kind == "zero run":
        assert first[2] == 17 and stats["large_groups"] >= 17  # a large group every round


def test_model_equals_stored_and_fixed_rounds(case):
    """With 8 stored levels: the kept ranks equal ``stored_rounds``', the
    order and the rounds run equal ``doubling_rounds_fixed``'s and the
    early exit's; a skip writes the identity at the stored levels and at
    the first round past them, and no other."""
    _, rows, _, _ = case
    stats = {}
    sa, ranks, distinct, run = suffix_cuda.doubling_model(rows, 8, stats)
    st, stored = suffix_torch.stored_rounds(rows, 8)
    assert torch.equal(ranks, stored)
    for rounds in (suffix_torch.doubling_rounds_fixed, suffix_torch.doubling_rounds):
        sa_f, ranks_f, run_f = rounds(rows, store_levels=8)
        assert torch.equal(sa, sa_f) and torch.equal(ranks, ranks_f)
        assert torch.equal(run, run_f)
    # A segment distinct after round r (r rounds run) skips rounds r ..
    # levels - 1: stored ones (r .. 7) and round 8 copy its ranks.
    levels = suffix_torch.num_levels(rows.shape[1])
    assert stats["copied"] == sum(max(0, 9 - r) for r in run.tolist())
    assert stats["skipped"] == sum(levels - r for r in run.tolist())


@pytest.mark.parametrize("kind", ["text", "zero run"])
def test_model_equals_jax(kind):
    rows = _rows(kind)[:3]
    n = rows.shape[1]
    sa, ranks, _, _ = suffix_cuda.doubling_model(rows, 8)
    levels = suffix_jax._num_levels(n)
    jax_rounds = jax.jit(functools.partial(suffix_jax._doubling_rounds, n=n, levels=levels,
                                           store_levels=8))
    for s in range(rows.shape[0]):
        sa_j, ranks_j = jax_rounds(jnp.asarray(rows[s].numpy()))
        np.testing.assert_array_equal(np.asarray(sa_j), sa[s].numpy())
        np.testing.assert_array_equal(np.asarray(ranks_j), ranks[:, s].numpy())


def test_first_round_counting_sort():
    """The first round's previous order is positions by (symbol, position),
    bytes first, each sentinel by its value, with dense symbol ranks."""
    rng = np.random.default_rng(11)
    n = 3 * TILE + 123
    sym = rng.integers(0, 40, n)
    where = rng.choice(n, 900, replace=False)
    sym[where] = 256 + rng.choice(n, 900, replace=False)  # sentinels, unique, any order
    sa, rsa, grp = suffix_cuda._first_order(sym)
    want = np.lexsort((np.arange(n), sym))
    np.testing.assert_array_equal(sa, want)
    dense = np.unique(sym, return_inverse=True)[1]
    np.testing.assert_array_equal(grp, dense)
    np.testing.assert_array_equal(rsa, dense[sa])


@pytest.mark.parametrize("run_len", [TILE - 1, TILE, TILE + 1, 2 * TILE + 5])
def test_groups_on_the_tiles_edges(run_len):
    """Runs of one byte whose groups fill a tile, end on its edge or pass
    it (a large group), among short groups that straddle tile starts."""
    rng = np.random.default_rng(run_len)
    n = 5 * TILE
    row = rng.integers(0, 6, n)
    for start in (0, TILE - 3, 3 * TILE + 17):
        row[start : start + run_len] = 200
    row[-300:] = 256 + np.arange(300)
    rows = torch.from_numpy(row.astype(np.int32))[None]
    stats = {}
    sa, ranks, _, run = suffix_cuda.doubling_model(rows, None, stats)
    sa_p, ranks_p, _ = _plain_chain(rows)
    assert torch.equal(ranks, ranks_p) and torch.equal(sa, sa_p)
    assert stats["large_groups"] >= 1 and stats["sorted_tiles"] >= 1


@pytest.mark.parametrize("n", [1, 2, 3, 4097, suffix_cuda.MAX_N])
def test_short_and_longest_rows(n):
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(rng.integers(0, 4, (1, n)).astype(np.int32))
    sa, ranks, _, _ = suffix_cuda.doubling_model(rows)
    sa_p, ranks_p, _ = _plain_chain(rows)
    assert torch.equal(ranks, ranks_p) and torch.equal(sa, sa_p)


def test_kernel_route_by_row_length():
    assert suffix_cuda.fits(1) and suffix_cuda.fits(mt.SEG_LEN)
    assert suffix_cuda.fits(suffix_cuda.MAX_N) and not suffix_cuda.fits(suffix_cuda.MAX_N + 1)
    assert not suffix_cuda.fits(0)
    # A row of MAX_N positions holds fewer large groups than the kernel's table.
    assert suffix_cuda.MAX_N // (TILE + 1) < suffix_cuda.MAX_BIG
    with pytest.raises(ValueError):
        suffix_cuda.doubling_model(torch.zeros((1, suffix_cuda.MAX_N + 1), dtype=torch.int32))
