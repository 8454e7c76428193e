"""Prefix-doubling suffix arrays and rank tables for a batch of segments.

Manber-Myers doubling: ceil(log2 n) rounds of (sort by (rank_i,
rank_{i+k}), re-rank). Each round is one stable sort of packed int64
keys over every segment of the batch at once, a compare, a cumsum and a
scatter back to position order. Port of zultra_tpu.ops.suffix_jax's
``_num_levels`` and ``_doubling_rounds``; the suffix array is unique, so
both produce the same permutation. ``suffix_array`` and ``plcp`` port
``suffix_array_jax`` and ``plcp_jax`` (one byte string, numpy out).

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

import numpy as np
import torch


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


def stored_rounds(data: torch.Tensor, store_levels: int | None = None):
    """The first rounds, whose ranks are kept: min(store_levels,
    num_levels(n)) of them (all with None). -> (sa, distinct, ranks
    (stored + 1, S, n) int32), ranks[l] comparing 2^l-grams."""
    levels = num_levels(data.shape[1])
    store = levels if store_levels is None else min(store_levels, levels)
    rank = data.to(torch.int32)
    rows = [rank]
    sa = distinct = None
    for level in range(store):
        sa, rank, distinct = _round(rank, 1 << level)
        rows.append(rank)
    return sa, distinct, torch.stack(rows)


def later_rounds(sa: torch.Tensor, rank: torch.Tensor, level: int) -> torch.Tensor:
    """Rounds ``level`` .. num_levels(n) - 1, every one of them, with no
    test of the ranks: nothing here waits for the device. -> sa."""
    for lv in range(level, num_levels(rank.shape[1])):
        sa, rank, _ = _round(rank, 1 << lv)
    return sa


def doubling_rounds(data: torch.Tensor, store_levels: int | None = None):
    """data: (S, n) int32 symbols, each below 256 + n (bytes plus unique
    sentinels). Returns (sa (S, n) int32, ranks (store+1, S, n) int32)
    where ranks[l] compares 2^l-grams (ranks[0] is the data itself).

    Rounds past ``store_levels`` stop as soon as every segment's ranks are
    distinct (further rounds are identities), which the host learns by
    waiting for the device after each of them: the form for the CPU and
    for one-off calls (``suffix_array``, ``plcp``, the corpus statistics).
    ``doubling_rounds_fixed`` runs them all and never waits."""
    sa, distinct, ranks = stored_rounds(data, store_levels)
    rank, level = ranks[-1], ranks.shape[0] - 1
    while level < num_levels(data.shape[1]) and not bool(distinct.all()):
        sa, rank, distinct = _round(rank, 1 << level)
        level += 1
    return sa, ranks


def doubling_rounds_fixed(data: torch.Tensor, store_levels: int | None = None):
    """``doubling_rounds`` with every one of its num_levels(n) rounds run:
    the same (sa, ranks), since rounds past distinctness are identities,
    and no host sync, so that a CUDA graph can hold it (the JAX package's
    ``lax.while_loop`` runs inside its jit)."""
    sa, _, ranks = stored_rounds(data, store_levels)
    return later_rounds(sa, ranks[-1], ranks.shape[0] - 1), ranks


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
    sa, _ = doubling_rounds(torch.from_numpy(arr.astype(np.int32)).to(device)[None])
    return sa[0].cpu().numpy()


def plcp(data, device="cuda") -> np.ndarray:
    """Permuted LCP (plcp_jax): plcp[i] = lcp of suffix i with its
    predecessor in suffix order, 0 for the first suffix. (n,) int32."""
    arr = np.asarray(data, dtype=np.uint8)
    n = int(arr.shape[0])
    if n < 2:
        return np.zeros(n, dtype=np.int32)
    sa, ranks = doubling_rounds(torch.from_numpy(arr.astype(np.int32)).to(device)[None])
    out = torch.zeros_like(sa)
    out.scatter_(1, sa[:, 1:].to(torch.int64), adjacent_lcp(sa, ranks))
    return out[0].cpu().numpy()
