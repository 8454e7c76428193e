"""The prefix-doubling round of the suffix arrays on the card (kernel
``csrc/suffix.cu``), and the plain model of its schedule.

``suffix_torch`` runs the rounds; on a CUDA tensor of at most ``MAX_N``
positions a row it launches this kernel once a round (``launch_round``:
two launches, the round and the store of its ranks in position order),
else the plain round ``suffix_torch._round`` (the route is the row's
length alone, counted as ``suffix.plain_rounds`` by the tracer). The
kernel keeps its state on the device between rounds (``new_state``): the
suffix order, its ranks in suffix order, a flag a segment (every rank
distinct) and the rounds each segment ran. A segment whose flag was set
by the round before skips the round.

``doubling_model`` is the kernel's schedule in numpy, walk by walk: the
first round's counting sort, the tiles of small groups cut at group
boundaries, the large groups along Manber and Myers' order, the dense
re-rank (in walk 1 where the segment has no large group, counted as
fused; the same boundaries), the ranks stored to position order, and the
skip with its copy of the ranks at a stored level. It gives what
``suffix_torch.doubling_rounds_fixed`` gives, and the rounds run, bit for
bit (tests/test_torch_suffix_round.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import count_launch

MAX_N = 1 << 17  # positions a row, at most (the kernel's bitmap and large-group table)
TILE = 4096  # suffix-order entries a tile of small groups; a larger group is large
KEY2_BITS = 18  # rank_{i+k} + 1 < 2^18
MAX_BIG = 32  # large groups a segment, at most: MAX_N // (TILE + 1) < MAX_BIG
LARGE_GAP = TILE + 1 - 32  # a large group holds two ranks this far apart, one at a multiple of 32


def fits(n: int) -> bool:
    """Whether the kernel takes rows of ``n`` positions."""
    return 1 <= n <= MAX_N


def new_state(S: int, n: int, device):
    """The kernel's state of one doubling: (sa, rsa, distinct, run,
    scratch), written whole by its first round."""
    def words(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    return (words(S, n), words(S, n), torch.empty((S,), dtype=torch.bool, device=device),
            words(S), words(S, 2, n))


def launch_round(rank_in: torch.Tensor, rank_out: torch.Tensor, state, k: int,
                 first: bool) -> None:
    """One doubling round, k = 2^level, on every segment: (S, n) int32
    ranks in (the symbols, bytes and sentinels each unique in its row, for
    the first round) to ranks out (``rank_in`` itself allowed past the
    first round), the state updated in place. A segment whose ranks were
    all distinct copies its ranks where ``rank_out`` is another tensor."""
    sa, rsa, distinct, run, scratch = state
    for name, t, dtype, ndim in (("rank_in", rank_in, torch.int32, 2),
                                 ("rank_out", rank_out, torch.int32, 2),
                                 ("sa", sa, torch.int32, 2), ("rsa", rsa, torch.int32, 2),
                                 ("distinct", distinct, torch.bool, 1),
                                 ("run", run, torch.int32, 1),
                                 ("scratch", scratch, torch.int32, 3)):
        _build.check_cuda(f"suffix_round {name}", t, dtype, ndim)
    S, n = rank_in.shape
    if not fits(n) or k < 1 or rank_out.shape != (S, n) or sa.shape != (S, n) \
            or rsa.shape != (S, n) or distinct.shape != (S,) or run.shape != (S,) \
            or scratch.shape != (S, 2, n) or (first and rank_out.data_ptr() == rank_in.data_ptr()):
        raise ValueError(f"suffix_round: bad shapes or k for S={S} n={n} k={k}")
    _build.launch("zt_suffix_round", rank_in.data_ptr(), rank_out.data_ptr(), sa.data_ptr(),
                  rsa.data_ptr(), distinct.data_ptr(), run.data_ptr(), scratch.data_ptr(), S,
                  n, k, 1 if first else 0)
    count_launch("suffix_round")


# ---------------------------------------------------------------------------
# The plain model of the kernel's schedule
# ---------------------------------------------------------------------------

def doubling_model(data, store_levels: int | None = None, stats: dict | None = None):
    """The kernel's rounds on (S, n) int32 symbols (a tensor or an array):
    num_levels(n) of them, ranks kept for the first ``store_levels``.
    -> (sa (S, n), ranks (stored + 1, S, n), distinct (S,), run (S,))
    as torch tensors on the CPU. ``stats`` (a dict) gathers the schedule's
    counts: tiles sorted, tiles of singletons, large groups, segment
    rounds ranked in walk 1 (fused), segments skipped, ranks copied by a
    skip."""
    data = np.asarray(torch.as_tensor(data).cpu(), dtype=np.int64)
    S, n = data.shape
    if not fits(n):
        raise ValueError(f"doubling_model: rows of 1 to {MAX_N} positions, got {n}")
    levels = max(1, int(np.ceil(np.log2(max(n, 2)))))
    store = levels if store_levels is None else min(store_levels, levels)
    counts = stats if stats is not None else {}
    for key in ("sorted_tiles", "single_tiles", "large_groups", "fused", "skipped", "copied"):
        counts.setdefault(key, 0)
    sa = np.zeros((S, n), np.int64)
    rsa = np.zeros((S, n), np.int64)
    distinct = np.zeros(S, bool)
    run = np.zeros(S, np.int64)
    ranks = [data.copy()]
    rank = data
    for level in range(levels):
        out = np.empty_like(rank)
        for s in range(S):
            if level and distinct[s]:
                counts["skipped"] += 1
                out[s] = rank[s]
                # A stored level's new row, and the first round past them (whose
                # ranks leave the last stored row as it is), get the identity
                # written; later rounds update their ranks in place.
                counts["copied"] += level <= store
                continue
            sa[s], rsa[s], out[s], distinct[s] = _segment_round(
                rank[s], sa[s], rsa[s], 1 << level, level == 0, counts)
            run[s] = 1 if level == 0 else run[s] + 1
        rank = out
        if level < store:
            ranks.append(rank)
    return (_i32(sa), torch.stack([_i32(r) for r in ranks]), torch.from_numpy(distinct),
            _i32(run))


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32))


def _first_order(sym: np.ndarray):
    """The first round's previous order: positions by (symbol, position),
    the symbols' dense ranks in that order and in position order. Bytes by
    a stable counting sort (a cursor a byte); each sentinel (>= 256,
    unique in its row) after the bytes, by its value."""
    n = sym.shape[0]
    is_byte = sym < 256
    hist = np.bincount(sym[is_byte], minlength=256)
    cursor = np.concatenate([[0], np.cumsum(hist)[:-1]])
    dense_byte = np.concatenate([[0], np.cumsum(hist > 0)[:-1]])
    n_bytes, n_dense = int(hist.sum()), int((hist > 0).sum())
    sent = np.minimum(sym - 256, n - 1)
    bits = np.zeros(n, bool)
    bits[sent[~is_byte]] = True
    below = np.concatenate([[0], np.cumsum(bits)[:-1]])
    sa = np.empty(n, np.int64)
    rsa = np.empty(n, np.int64)
    grp = np.empty(n, np.int64)
    for t0 in range(0, n, TILE):  # positions in order: each byte's run in a tile
        p = np.arange(t0, min(t0 + TILE, n))
        b = sym[p]
        for byte in np.unique(b[b < 256]):
            run = p[b == byte]
            dest = cursor[byte] + np.arange(run.shape[0])
            sa[dest], rsa[dest], grp[run] = run, dense_byte[byte], dense_byte[byte]
            cursor[byte] += run.shape[0]
        sp = p[b >= 256]
        r = below[sent[sp]]
        sa[n_bytes + r], rsa[n_bytes + r], grp[sp] = sp, n_dense + r, n_dense + r
    return sa, rsa, grp


def _segment_round(rank: np.ndarray, sa: np.ndarray, rsa: np.ndarray, k: int, first: bool,
                   counts: dict):
    """One segment's round as the kernel runs it. -> (sa, rsa, new ranks in
    position order, distinct)."""
    n = rank.shape[0]
    grp = rank
    if first:
        sa, rsa, grp = _first_order(rank)
    nsa = np.empty(n, np.int64)
    nk2 = np.full(n, -7, np.int64)  # a tile of singletons writes none: no boundary reads them
    big = []
    # A group of more than TILE entries holds ranks LARGE_GAP apart, the
    # first at a multiple of 32; without such a pair walk 1 ranks the tiles
    # itself (fused), in the same order with the same boundaries.
    j = np.arange(0, max(n - LARGE_GAP, 0), 32)
    counts["fused"] += not bool((rsa[j] == rsa[j + LARGE_GAP]).any())
    # Walk 1: tiles of at most TILE entries cut at group boundaries.
    t0 = 0
    while t0 < n:
        t1 = n
        if n - t0 > TILE:
            last = rsa[t0 + TILE - 1]
            if rsa[t0 + TILE] != last:
                t1 = t0 + TILE
            else:
                t1 = t0 + int(np.searchsorted(rsa[t0 : t0 + TILE], last, "left"))
                if t1 == t0:  # a large group: noted, ordered by walk 2
                    end = t0 + TILE + int(np.searchsorted(rsa[t0 + TILE :], rsa[t0], "right"))
                    big.append((t0, end, rsa[t0]))
                    counts["large_groups"] += 1
                    t0 = end
                    continue
        r = rsa[t0:t1]
        if r[-1] - r[0] + 1 == t1 - t0:
            nsa[t0:t1] = sa[t0:t1]
            counts["single_tiles"] += 1
        else:
            p = sa[t0:t1]
            head = np.ones(t1 - t0, bool)
            head[1:] = r[1:] != r[:-1]
            tail = np.ones(t1 - t0, bool)
            tail[:-1] = head[1:]
            r2 = np.where(p + k < n, rank[np.minimum(p + k, n - 1)], -1)
            r2 = np.where(head & tail, -1, r2)  # a group of one loads nothing
            key = ((r - r[0]) << KEY2_BITS) | (r2 + 1)
            order = np.argsort(key, kind="stable")
            nsa[t0:t1] = p[order]
            nk2[t0:t1] = (key[order] & ((1 << KEY2_BITS) - 1)) - 1
            counts["sorted_tiles"] += 1
        t0 = t1
    # Walk 2: each large group's members take its next slots along
    # (rank_{p+k}, p): the suffixes past n - k, then sa[j] - k.
    if big:
        if len(big) > MAX_BIG:
            raise AssertionError("more large groups than the kernel holds")
        kk = min(k, n)
        valid = sa >= k
        p = np.concatenate([np.arange(n - kk, n), sa[valid] - k])
        r2 = np.concatenate([np.full(kk, -1), rsa[valid]])
        g = grp[p]
        for lo, hi, r0 in big:
            members = g == r0
            nsa[lo:hi] = p[members]
            nk2[lo:hi] = r2[members]
            if members.sum() != hi - lo:
                raise AssertionError("a large group's members do not fill it")
    # Walk 3: dense ranks of the new order.
    boundary = np.ones(n, bool)
    boundary[1:] = (rsa[1:] != rsa[:-1]) | (nk2[1:] != nk2[:-1])
    new_rsa = np.cumsum(boundary) - 1
    new_rank = np.empty(n, np.int64)
    new_rank[nsa] = new_rsa
    return nsa, new_rsa, new_rank, bool(new_rsa[-1] == n - 1)
