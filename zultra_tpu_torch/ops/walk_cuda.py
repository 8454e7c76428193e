"""The lazy LCP-interval walk (kernel ``csrc/walk.cu``) and its plain
PyTorch version.

Input is one rank-order word per suffix, SA | clamped-LCP << LCP_SHIFT,
for each segment buffer of the uniform [HALO | core | TAIL] layout. The
walk builds the LCP-interval tree (zultra src/matchfinder.c:98-155) and
runs the lazy interval ascent (:171-234) over every position up to the
end of the core, reporting up to 8 (len << 16 | off) rows per core
position, longest first — the rows zultra_tpu.ops.walk_pallas emits.
"""

from __future__ import annotations

import torch

from ..constants import (
    EXCL_VISITED_MASK,
    LCP_MASK,
    LCP_SHIFT,
    MAX_OFFSET,
    NMATCHES_PER_OFFSET,
    POS_MASK,
    VISITED_FLAG,
)

from .. import _build

launches = 0  # kernel launches since the last reset


def walk_segments(salcp: torch.Tensor, halo: int, core_len: int) -> torch.Tensor:
    """salcp (S, n) int32 -> packed rows (S, core_len, 8) int32 for the
    core positions [halo, halo + core_len) of every segment; zero where
    a position has fewer than 8 matches."""
    global launches
    if salcp.device.type == "cpu":
        return walk_segments_plain(salcp, halo, core_len)
    _build.check_cuda("walk", salcp, torch.int32, 2)
    S, n = salcp.shape
    if halo + core_len > n or n >= (1 << LCP_SHIFT):
        raise ValueError(f"walk: bad geometry n={n} halo={halo} core={core_len}")
    rows = torch.zeros((S, core_len, NMATCHES_PER_OFFSET), dtype=torch.int32,
                       device=salcp.device)
    tables = torch.zeros((S, 2 * n + 2), dtype=torch.int32, device=salcp.device)
    _build.launch("zt_walk", salcp.data_ptr(), tables.data_ptr(), rows.data_ptr(),
                  S, n, halo, core_len)
    launches += 1
    return rows


def walk_segments_plain(salcp: torch.Tensor, halo: int, core_len: int) -> torch.Tensor:
    """The walk as a plain loop over each segment's words (Python ints),
    with the kernel's exact semantics."""
    S, n = salcp.shape
    out = torch.zeros((S, core_len, NMATCHES_PER_OFFSET), dtype=torch.int32)
    for s in range(S):
        rows = _walk_one(salcp[s].tolist(), n, halo, halo + core_len)
        if rows:
            idx, vals = zip(*rows)
            out[s].view(-1)[torch.tensor(idx, dtype=torch.int64)] = torch.tensor(
                vals, dtype=torch.int32)
    return out.to(salcp.device)


def _walk_one(salcp: list, n: int, halo: int, limit: int) -> list:
    """One segment: returns [(flat row index, packed row), ...]."""
    T = [0] * (2 * n + 2)  # intervals[0..n) ++ pos_data[n..2n+1)
    NP = n

    # Phase 0: interval tree from SA + LCP (stack sweep).
    stack = [0]
    prev_pos = salcp[0] & POS_MASK
    nidx = 1
    for i in range(1, n):
        packed = salcp[i]
        next_pos = packed & POS_MASK
        next_lcp = packed & LCP_MASK
        top = stack[-1]
        top_lcp = top & LCP_MASK
        if next_lcp == top_lcp:
            T[NP + prev_pos] = top
        elif next_lcp > top_lcp:
            stack.append(next_lcp | nidx)
            nidx += 1
            T[NP + prev_pos] = stack[-1]
        else:
            T[NP + prev_pos] = top
            while True:
                closed = stack.pop() & POS_MASK
                s_lcp = stack[-1] & LCP_MASK
                if next_lcp > s_lcp:
                    stack.append(next_lcp | nidx)
                    nidx += 1
                T[closed] = stack[-1]
                if next_lcp >= s_lcp:
                    break
        prev_pos = next_pos
    T[NP + prev_pos] = stack[-1]
    while len(stack) > 1:
        top = stack.pop()
        T[top & POS_MASK] = stack[-1]

    # Phase 1: the lazy walk.
    rows = []
    for p in range(limit):
        mm = NMATCHES_PER_OFFSET if p >= halo else 0
        ref = T[NP + p]
        T[NP + p] = 0
        sref = T[ref & POS_MASK]
        while sref & LCP_MASK:
            T[ref & POS_MASK] = p | VISITED_FLAG
            ref = sref
            sref = T[sref & POS_MASK]
        if sref == 0:
            if ref != 0:
                T[ref & POS_MASK] = p | VISITED_FLAG
            continue
        match_pos = sref & EXCL_VISITED_MASK
        count = 0
        while True:
            s2 = T[NP + match_pos]
            while s2 > ref:
                match_pos = T[s2 & POS_MASK] & EXCL_VISITED_MASK
                s2 = T[NP + match_pos]
            T[ref & POS_MASK] = p | VISITED_FLAG
            T[NP + match_pos] = ref
            off = p - match_pos
            if count < mm and off <= MAX_OFFSET:
                rows.append(((p - halo) * NMATCHES_PER_OFFSET + count,
                             ((ref >> LCP_SHIFT) << 16) | off))
                count += 1
            if s2 == 0:
                break
            ref = s2
            match_pos = T[ref & POS_MASK] & EXCL_VISITED_MASK
    return rows
