"""All-nearest-smaller-values (PSV/NSV), pairwise LCPs and range
max-below-threshold queries, as plain tensor ops on either device; and
the zero-padded sparse-min table with its top-down descents that the
staircase match finder (``ops/staircase_torch.py``) runs on.

Port of zultra_tpu/ops/nsv.py (``psv_nsv_jax`` :108, ``lcp_pairs_jax``
:142, ``range_max_below_jax`` :211) and of the table code of
zultra_tpu/ops/matchfinder_jax.py (``_build_sparse_min`` :159,
``_find_left`` :172, ``_find_right`` :190). The two JAX modules each
keep a copy of the sparse-min table code; here there is one.

* ``psv_nsv``: for every index the nearest smaller value to the left
  and to the right, by binary descents over a sparse table of windowed
  minima: O(n log n) work, no sequential stack.
* ``lcp_pairs``: lcp of arbitrary suffix pairs from the prefix-doubling
  rank tables (``suffix_torch``).
* ``range_max_below``: per query, the largest value below a threshold
  inside an index range, over a merge-sort tree with branchless
  power-of-two lower bounds.

Each takes tensors (kept on their device) or array-likes (moved to
``device``) and returns int32 tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .suffix_torch import doubling_rounds, pair_lcp

BIG = 1 << 30  # the sparse-min table's fill past the end
NEG = -(1 << 30)  # range_max_below's "none"
I32 = torch.int32
I64 = torch.int64


def _int32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(I32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


def build_sparse_min(a: torch.Tensor, levels: int) -> torch.Tensor:
    """st[l][..., i] = min(a[..., i .. i + 2^l - 1]), windows clipped at
    the end (filled with 2^30). a (..., n) -> (levels + 1, ..., n)."""
    tables = [a]
    cur = a
    for level in range(1, levels + 1):
        k = 1 << (level - 1)
        shifted = torch.cat([cur[..., k:], cur.new_full((*cur.shape[:-1], k), BIG)], dim=-1)
        cur = torch.minimum(cur, shifted)
        tables.append(cur)
    return torch.stack(tables)


def find_left(st: torch.Tensor, lev: int, pad: int, x: torch.Tensor, t: torch.Tensor):
    """Largest a <= x with L[a] < t, for (S, m) queries over S rows.

    One top-down descent of the zero-padded table ``st`` (levels + 1, S,
    2 pad + len(L)) built over [zeros(pad) | L | zeros(pad)], pad = 2^lev
    >= len(L): the window [x + 1 - 2^lev, x] always covers position 0,
    whose L is 0 < t, the left padding keeps its start index in bounds,
    and each level reads one element a query. Rightmost preference: take
    the right half whenever it still holds a value < t; real positions
    lie right of the padding, so the result is never a pad index."""
    cur = (x + 1).to(I64)  # padded coordinate of the window start: pad + x + 1 - 2^lev
    for level in range(lev - 1, -1, -1):
        step = 1 << level
        right_min = torch.gather(st[level], 1, cur + step)
        cur = torch.where(right_min < t, cur + step, cur)
    return (cur - pad).to(I32)


def find_right(st: torch.Tensor, lev: int, pad: int, x: torch.Tensor, t: torch.Tensor):
    """Smallest b >= x with L[b] < t (L's last entry is a 0 sentinel).

    The mirror of ``find_left`` over the same padded table: window [x, x
    + 2^lev), leftmost preference; the right padding keeps indices in
    bounds, and the sentinel lies left of it, so the result is never a
    pad index."""
    cur = (pad + x).to(I64)
    for level in range(lev - 1, -1, -1):
        step = 1 << level
        left_min = torch.gather(st[level], 1, cur)
        cur = torch.where(left_min < t, cur, cur + step)
    return (cur - pad).to(I32)


def _floor_log2_table(n: int, device) -> torch.Tensor:
    """logs[i] = floor(log2 i) for i in 1 .. n, logs[0] = 0."""
    logs = np.zeros(n + 1, dtype=np.int64)
    for b in range(1, max(n, 1).bit_length()):
        logs[1 << b :] += 1
    return torch.from_numpy(logs).to(device)


def _range_min(st, log_table, lo, hi):
    """min over [lo, hi) for index vectors lo < hi (the two-window RMQ)."""
    level = log_table[hi - lo]
    left = st[level, lo]
    right = st[level, hi - (1 << level)]
    return torch.minimum(left, right)


def psv_nsv(values, device="cuda"):
    """psv[i] = nearest j < i with values[j] < values[i] (else -1); nsv[i]
    = nearest j > i with values[j] < values[i] (else n). -> (psv, nsv),
    (n,) int32 tensors."""
    v = _int32(values, device)
    n = int(v.shape[0])
    if n == 0:
        return v.new_empty(0), v.new_empty(0)
    dev = v.device
    levels = max(1, int(math.ceil(math.log2(max(n, 2)))))
    st = build_sparse_min(v, levels)
    log_table = _floor_log2_table(n, dev)
    idx = torch.arange(n, dtype=I64, device=dev)
    zeros = torch.zeros(n, dtype=I64, device=dev)
    ends = torch.full((n,), n, dtype=I64, device=dev)

    def safe_range_min(lo, hi):
        """min over [lo, hi), hi > lo wherever the caller's mask uses it;
        degenerate ranges clamp to length 1."""
        lo_c = torch.clamp(lo, 0, n - 1)
        hi_c = torch.minimum(torch.maximum(hi, lo_c + 1), ends)
        return _range_min(st, log_table, lo_c, hi_c)

    def descend(lo, hi, exists, pick_right):
        # [lo, hi) holds the answer wherever one exists (min over it < v).
        for _ in range(levels + 2):
            active = ((hi - lo) > 1) & exists
            mid = (lo + hi) // 2
            if pick_right:  # the right half [mid, hi)
                go = safe_range_min(mid, hi) < v
                new_lo, new_hi = torch.where(go, mid, lo), torch.where(go, hi, mid)
            else:  # the left half [lo, mid)
                go = safe_range_min(lo, mid) < v
                new_lo, new_hi = torch.where(go, lo, mid), torch.where(go, mid, hi)
            lo, hi = torch.where(active, new_lo, lo), torch.where(active, new_hi, hi)
        return lo

    # PSV: search [0, i), keep the rightmost qualifying half.
    psv_exists = (idx > 0) & (safe_range_min(zeros, idx) < v)
    psv = torch.where(psv_exists, descend(zeros, idx, psv_exists, True), -1)
    # NSV: search [i + 1, n), keep the leftmost qualifying half.
    nsv_exists = (idx + 1 < n) & (safe_range_min(idx + 1, ends) < v)
    nsv = torch.where(nsv_exists, descend(idx + 1, ends, nsv_exists, False), n)
    return psv.to(I32), nsv.to(I32)


def lcp_pairs(data, i_positions, j_positions, device="cuda") -> torch.Tensor:
    """lcp(suffix i, suffix j) of a byte string for arbitrary position
    pairs, n - i where i == j. (q,) int32."""
    if torch.is_tensor(data):
        arr = data.to(I32)
    else:
        arr = torch.from_numpy(np.asarray(data, dtype=np.uint8).astype(np.int32)).to(device)
    i_pos = _int32(i_positions, arr.device)
    j_pos = _int32(j_positions, arr.device)
    n = int(arr.shape[0])
    _, ranks, _ = doubling_rounds(arr[None])
    lcp = pair_lcp(ranks, i_pos[None], j_pos[None])[0]
    return torch.where(i_pos == j_pos, n - i_pos, lcp)


def _merge_sort_tree(a: torch.Tensor, levels: int) -> torch.Tensor:
    """tree[l] = a with every aligned 2^l block sorted ascending."""
    n = a.shape[0]
    rows = [a]
    cur = a
    for level in range(1, levels + 1):
        width = 1 << level
        cur = torch.sort(cur.reshape(n // width, width), dim=1).values.reshape(n)
        rows.append(cur)
    return torch.stack(rows)


def range_max_below(values, los, his, thresholds, device="cuda") -> torch.Tensor:
    """For each query q: max(values[los[q]:his[q]]) over the entries below
    thresholds[q], or -2^30 if there is none. (q,) int32."""
    v = _int32(values, device)
    dev = v.device
    lo = _int32(los, dev).to(I64)
    hi = _int32(his, dev).to(I64)
    th = _int32(thresholds, dev)
    n0 = int(v.shape[0])
    levels = max(1, int(math.ceil(math.log2(max(n0, 2)))))
    n = 1 << levels
    padded = torch.full((n,), NEG, dtype=I32, device=dev)  # -2^30 never qualifies
    padded[:n0] = v
    tree = _merge_sort_tree(padded, levels)

    def seg_max_below(level, seg_start, width, active):
        """Largest value < th in the sorted run tree[level][seg_start :
        seg_start + width] (width = 2^level), by a branchless power-of-two
        lower bound: advance by step = width, width / 2, ..., 1 while the
        run's (count + step - 1)-th element is < th; count is then the
        number of qualifying elements."""
        count = torch.zeros_like(seg_start)
        for shift in range(level, -1, -1):
            step = 1 << shift
            probe = torch.clamp(seg_start + count + step - 1, 0, n - 1)
            take = ((count + step) <= width) & (tree[level, probe] < th)
            count = torch.where(take, count + step, count)
        best = tree[level, torch.clamp(seg_start + count - 1, 0, n - 1)]
        return torch.where(active & (count > 0), best, NEG)

    result = torch.full(lo.shape, NEG, dtype=I32, device=dev)
    a_cur, b_cur = lo, hi
    for level in range(levels + 1):
        width = 1 << level
        # Peel a right-misaligned prefix segment at this level ...
        take_a = (a_cur < b_cur) & ((a_cur & width) != 0)
        result = torch.maximum(result, torch.where(
            take_a, seg_max_below(level, a_cur, width, take_a), NEG))
        a_cur = torch.where(take_a, a_cur + width, a_cur)
        # ... and a left-misaligned suffix segment.
        take_b = (a_cur < b_cur) & ((b_cur & width) != 0)
        b_cur = torch.where(take_b, b_cur - width, b_cur)
        result = torch.maximum(result, torch.where(
            take_b, seg_max_below(level, b_cur, width, take_b), NEG))
    return result
