"""Prefix-doubling suffix arrays and rank tables for a batch of segments.

Manber-Myers doubling: ceil(log2 n) rounds of (sort by (rank_i,
rank_{i+k}), re-rank). Port of zultra_tpu.ops.suffix_jax's ``_num_levels``
and ``_doubling_rounds``; the suffix array is unique, so both produce the
same permutation. ``suffix_array`` and ``plcp`` port ``suffix_array_jax``
and ``plcp_jax`` (one byte string, numpy out).

Two routes for a round, by the rows' length alone. On the card, rows of
up to ``suffix_cuda.MAX_N`` positions take the kernel ``csrc/suffix.cu``
(``suffix_cuda.launch_round``), which updates each segment's order group
by group and skips a segment whose ranks are already distinct. Every
other call takes the plain round ``_round``: one stable sort of packed
int64 keys over every segment at once, a compare, a cumsum and a
scatter back to position order (a CPU tensor, and on the card longer
rows, counted as ``suffix.plain_rounds`` by the tracer). Both give the
same suffix order, dense ranks and flags, bit for bit; the rounds run
per segment (``Doubling.run``) count a round on a segment whose ranks
were not yet distinct, as the kernel runs it.

Two forms of the rounds past the stored ones: ``doubling_rounds`` stops
once every rank is distinct (a host sync a round, as the JAX package's
``lax.while_loop`` tests its flag on the device); ``doubling_rounds_fixed``
runs all ceil(log2 n) of them, the identities included, so that the
match program can be one captured CUDA graph.

Ties. JAX sorts (rank, rank2, idx) with ``lax.sort``; here one stable
sort of the packed key breaks ties by position. Only the order among
equal keys could differ, and neither output depends on it: the new
ranks are dense ranks of the keys, and after ceil(log2 n) rounds every
suffix has a rank of its own (rank2 = -1 past the end makes a suffix
that is a prefix of another the smaller), so the suffix array is the
unique one, for bytes with zero padding as for unique sentinels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import profiling
from .suffix_cuda import fits, launch_round, new_state


class Doubling(NamedTuple):
    """The doubling after its newest round: the suffix order (S, n) int32,
    its ranks in position order (S, n) int32, whether each segment's ranks
    are all distinct (S,) bool, and the rounds each segment ran (S,)
    int32. ``state``: the kernel's (``suffix_cuda.new_state``), which it
    updates in place round after round; None on the plain route."""
    sa: torch.Tensor
    rank: torch.Tensor
    distinct: torch.Tensor
    run: torch.Tensor
    state: tuple | None = None


def num_levels(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))))


def _sort_rerank(rank: torch.Tensor, rank2: torch.Tensor, base: int):
    """One doubling round: suffix order by (rank, rank2), then the new
    ranks in position order and a per-segment all-distinct flag.

    The two keys pack into one int64 (rank * base + rank2 + 1, with
    rank2 >= -1 and both below ``base``); a stable sort then breaks ties
    by position, which is the lexicographic (rank, rank2, idx) order."""
    key = rank.to(torch.int64) * base + (rank2.to(torch.int64) + 1)
    k_sorted, sa = torch.sort(key, dim=1, stable=True)
    diff = torch.zeros_like(k_sorted, dtype=torch.int32)
    diff[:, 1:] = (k_sorted[:, 1:] != k_sorted[:, :-1]).to(torch.int32)
    r_sorted = torch.cumsum(diff, dim=1, dtype=torch.int32)
    n = rank.shape[1]
    distinct = r_sorted[:, -1] == n - 1
    new_rank = torch.empty_like(r_sorted)
    new_rank.scatter_(1, sa, r_sorted)
    return sa.to(torch.int32), new_rank, distinct


def _round(rank: torch.Tensor, k: int):
    """One doubling round: (rank_i, rank_{i+k}) sorted, re-ranked; -1 past
    the end. -> (sa, new rank, per-segment all-distinct flag)."""
    S, n = rank.shape
    neg = torch.full((S, min(k, n)), -1, dtype=torch.int32, device=rank.device)
    rank2 = torch.cat([rank[:, k:], neg], dim=1) if k < n else neg
    return _sort_rerank(rank, rank2, n + 257)


def _on_card(rank: torch.Tensor) -> bool:
    """The kernel's route: a CUDA tensor of rows it takes."""
    return rank.is_cuda and fits(rank.shape[1])


def _step(st: Doubling | None, rank: torch.Tensor, level: int, out: torch.Tensor) -> Doubling:
    """Round ``level`` (k = 2^level) on ``rank``, the first when ``st`` is
    None. The kernel writes its ranks to ``out`` (``rank`` itself allowed
    past the first round); the plain round makes a new tensor."""
    if _on_card(rank):
        state = new_state(*rank.shape, rank.device) if st is None else st.state
        launch_round(rank, out, state, 1 << level, st is None)
        sa, _, distinct, run, _ = state
        return Doubling(sa, out, distinct, run, state)
    if rank.is_cuda:
        profiling.count("suffix.plain_rounds")
    sa, new_rank, distinct = _round(rank, 1 << level)
    if st is None:
        run = torch.ones_like(distinct, dtype=torch.int32)
    else:
        run = st.run + (~st.distinct).to(torch.int32)
    return Doubling(sa, new_rank, distinct, run)


def stored_rounds(data: torch.Tensor, store_levels: int | None = None):
    """The first rounds, whose ranks are kept: min(store_levels,
    num_levels(n)) of them (all with None). -> (Doubling after them, ranks
    (stored + 1, S, n) int32), ranks[l] comparing 2^l-grams."""
    levels = num_levels(data.shape[1])
    store = levels if store_levels is None else min(store_levels, levels)
    rank = data.to(torch.int32)
    ranks = torch.empty((store + 1, *rank.shape), dtype=torch.int32, device=rank.device)
    ranks[0] = rank
    st = None
    for level in range(store):
        out = ranks[level + 1]
        st = _step(st, ranks[level], level, out)
        if st.rank is not out:  # the plain round's new tensor
            out.copy_(st.rank)
    return st, ranks


def later_rounds(st: Doubling, level: int) -> Doubling:
    """Rounds ``level`` .. num_levels(n) - 1, every one of them, with no
    test of the ranks: nothing here waits for the device. The first writes
    new ranks (``st.rank`` may be a stored row); the kernel updates them in
    place after it."""
    for lv in range(level, num_levels(st.rank.shape[1])):
        st = _step(st, st.rank, lv, st.rank if lv > level else torch.empty_like(st.rank))
    return st


def doubling_rounds(data: torch.Tensor, store_levels: int | None = None):
    """data: (S, n) int32 symbols, each below 256 + n (bytes plus unique
    sentinels). Returns (sa (S, n) int32, ranks (store+1, S, n) int32,
    rounds run (S,) int32) where ranks[l] compares 2^l-grams (ranks[0] is
    the data itself).

    Rounds past ``store_levels`` stop as soon as every segment's ranks are
    distinct (further rounds are identities), which the host learns by
    waiting for the device after each of them: the form for the CPU and
    for one-off calls (``suffix_array``, ``plcp``, the corpus statistics).
    ``doubling_rounds_fixed`` runs them all and never waits."""
    st, ranks = stored_rounds(data, store_levels)
    level = first = ranks.shape[0] - 1
    while level < num_levels(data.shape[1]) and not bool(st.distinct.all()):
        st = _step(st, st.rank, level, st.rank if level > first else torch.empty_like(st.rank))
        level += 1
    return st.sa, ranks, st.run


def doubling_rounds_fixed(data: torch.Tensor, store_levels: int | None = None):
    """``doubling_rounds`` with every one of its num_levels(n) rounds run:
    the same (sa, ranks, rounds run), since rounds past distinctness are
    identities (the kernel skips them, the plain round repeats them), and
    no host sync, so that a CUDA graph can hold it (the JAX package's
    ``lax.while_loop`` runs inside its jit)."""
    st, ranks = stored_rounds(data, store_levels)
    st = later_rounds(st, ranks.shape[0] - 1)
    return st.sa, ranks, st.run


def adjacent_lcp(sa: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """lcp(SA[r-1], SA[r]) for r in 1..n-1 by descending the rank tables
    from the widest stored gram to single bytes. (S, n-1) int32."""
    return pair_lcp(ranks, sa[:, 1:], sa[:, :-1])


def pair_lcp(ranks: torch.Tensor, i_pos: torch.Tensor, j_pos: torch.Tensor) -> torch.Tensor:
    """lcp(suffix i, suffix j) of each segment's (S, q) position pairs, up
    to the widest stored gram's reach (2^(levels+1) - 1), by descending
    the rank tables (levels + 1, S, n) from that gram to single bytes.
    (S, q) int32."""
    n = ranks.shape[2]
    lcp = torch.zeros_like(i_pos)
    levels = ranks.shape[0] - 1
    for level in range(levels, -1, -1):
        width = 1 << level
        ia = i_pos + lcp
        ja = j_pos + lcp
        ok = (ia + width <= n) & (ja + width <= n)
        ra = torch.gather(ranks[level], 1, torch.clamp(ia, 0, n - 1).to(torch.int64))
        rb = torch.gather(ranks[level], 1, torch.clamp(ja, 0, n - 1).to(torch.int64))
        lcp = torch.where(ok & (ra == rb), lcp + width, lcp)
    return lcp


def suffix_array(data, device="cuda") -> np.ndarray:
    """Suffix array of a byte array (suffix_array_jax): (n,) int32."""
    arr = np.asarray(data, dtype=np.uint8)
    n = int(arr.shape[0])
    if n < 2:
        return np.zeros(n, dtype=np.int32)
    sa, _, _ = doubling_rounds(torch.from_numpy(arr.astype(np.int32)).to(device)[None])
    return sa[0].cpu().numpy()


def plcp(data, device="cuda") -> np.ndarray:
    """Permuted LCP (plcp_jax): plcp[i] = lcp of suffix i with its
    predecessor in suffix order, 0 for the first suffix. (n,) int32."""
    arr = np.asarray(data, dtype=np.uint8)
    n = int(arr.shape[0])
    if n < 2:
        return np.zeros(n, dtype=np.int32)
    sa, ranks, _ = doubling_rounds(torch.from_numpy(arr.astype(np.int32)).to(device)[None])
    out = torch.zeros_like(sa)
    out.scatter_(1, sa[:, 1:].to(torch.int64), adjacent_lcp(sa, ranks))
    return out[0].cpu().numpy()
