"""The lazy LCP-interval walk (kernel ``csrc/walk.cu``), its plain
PyTorch version, and the plain model of the kernel's schedule.

Input is one rank-order word per suffix, SA | clamped-LCP << LCP_SHIFT,
for each segment buffer of the uniform [HALO | core | TAIL] layout. The
walk builds the LCP-interval tree (zultra src/matchfinder.c:98-155) and
runs the lazy interval ascent (:171-234) over every position up to the
end of the core, reporting up to 8 (len << 16 | off) rows per core
position, longest first — the rows zultra_tpu.ops.walk_pallas emits.

The kernel (``csrc/walk.cu``, replacing the TPU kernel
``zultra_tpu/ops/walk_pallas.py::_walk_kernel``) does not walk the halo.
It cuts the core into chunks of CHUNK positions starting at
h_j = halo + j * CHUNK, builds each chunk's walk state at h_j directly
from the tree, and walks the chunks in parallel: three launches a call
(sweep, park, walk). ``walk_chunks_model`` is the same schedule in plain
Python; its docstring states why the result is exact.
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
from . import count_launch

# Core positions a chunk walks, from a sweep on an H100 (`python3 -m
# zultra_tpu_torch.walk_bench --sweep`, PERF.md §6).
CHUNK = 4096
CHUNKS_MAX = 32  # chunks a segment, at most: one warp lane each in the sweep
SEGMENTS_MAX = 65535  # segments a call, at most: the park's grid height


def n_chunks(core_len: int, chunk: int) -> int:
    if chunk < 1:
        raise ValueError(f"walk: chunk must be positive, got {chunk}")
    return -(-core_len // chunk)


def scratch_bytes(S: int, n: int, core_len: int, chunk: int = CHUNK) -> int:
    """Device scratch of one walk_segments call: the phase-0 table and
    one table per chunk (intervals ++ positions, n words each), and a
    word per segment."""
    return 4 * S * ((n_chunks(core_len, chunk) + 1) * 2 * n + 1)


def walk_segments(salcp: torch.Tensor, halo: int, core_len: int,
                  chunk: int = CHUNK) -> torch.Tensor:
    """salcp (S, n) int32 -> packed rows (S, core_len, 8) int32 for the
    core positions [halo, halo + core_len) of every segment; zero where
    a position has fewer than 8 matches. On the card: three launches,
    ``chunk`` core positions a chunk walk, ``scratch_bytes`` of scratch.
    A CPU tensor takes the plain walk."""
    J = n_chunks(core_len, chunk)
    if salcp.device.type == "cpu":
        return walk_segments_plain(salcp, halo, core_len)
    _build.check_cuda("walk", salcp, torch.int32, 2)
    S, n = salcp.shape
    if (halo < 0 or core_len < 0 or halo + core_len > n or n >= (1 << LCP_SHIFT)
            or S > SEGMENTS_MAX):
        raise ValueError(f"walk: bad geometry S={S} n={n} halo={halo} core={core_len}")
    if J > CHUNKS_MAX:
        raise ValueError(f"walk: {J} chunks of {chunk} positions, at most {CHUNKS_MAX}")
    rows = torch.empty((S, core_len, NMATCHES_PER_OFFSET), dtype=torch.int32,
                       device=salcp.device)
    if S == 0 or J == 0:
        return rows
    tables = torch.empty((S, J + 1, 2, n), dtype=torch.int32, device=salcp.device)
    nidx = torch.empty((S,), dtype=torch.int32, device=salcp.device)
    _build.launch("zt_walk", salcp.data_ptr(), tables.data_ptr(), nidx.data_ptr(),
                  rows.data_ptr(), S, n, halo, core_len, chunk)
    count_launch("walk")
    return rows


def walk_segments_plain(salcp: torch.Tensor, halo: int, core_len: int) -> torch.Tensor:
    """The walk as a plain loop over each segment's words (Python ints),
    with the kernel's exact semantics: the tree, then every position from
    0 to the end of the core."""
    S, n = salcp.shape
    out = torch.zeros((S, core_len, NMATCHES_PER_OFFSET), dtype=torch.int32)
    for s in range(S):
        T, P = _tree(salcp[s].tolist(), n)
        rows = []
        for p in range(halo + core_len):
            _visit(T, P, p, P[p], NMATCHES_PER_OFFSET if p >= halo else 0, halo, rows)
        _scatter(out[s], rows)
    return out.to(salcp.device)


def _scatter(out: torch.Tensor, rows: list) -> None:
    if rows:
        idx, vals = zip(*rows)
        out.view(-1)[torch.tensor(idx, dtype=torch.int64)] = torch.tensor(vals, dtype=torch.int32)


def _tree(salcp: list, n: int):
    """Phase 0: the LCP-interval tree from SA + LCP (stack sweep).
    -> (T, P): T[i] is interval i's parent ref (0 at the root and under
    it), P[q] the ref of position q's leaf interval."""
    T = [0] * n
    P = [0] * n
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
            P[prev_pos] = top
        elif next_lcp > top_lcp:
            stack.append(next_lcp | nidx)
            nidx += 1
            P[prev_pos] = stack[-1]
        else:
            P[prev_pos] = top
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
    P[prev_pos] = stack[-1]
    while len(stack) > 1:
        top = stack.pop()
        T[top & POS_MASK] = stack[-1]
    return T, P


def _visit(T: list, P: list, p: int, ref: int, mm: int, halo: int, rows: list) -> int:
    """Phase 1 at position p, whose leaf ref is ``ref``: the lazy ascent,
    then the match chase; appends (flat row index, packed row) for up to
    ``mm`` matches within MAX_OFFSET and returns how many."""
    P[p] = 0
    sref = T[ref & POS_MASK]
    # Ascend to the closest visited ancestor (or the root), marking every
    # interval on the way as visited by p.
    while sref & LCP_MASK:
        T[ref & POS_MASK] = p | VISITED_FLAG
        ref = sref
        sref = T[sref & POS_MASK]
    if sref == 0:
        if ref != 0:
            T[ref & POS_MASK] = p | VISITED_FLAG
        return 0
    match_pos = sref & EXCL_VISITED_MASK
    count = 0
    while True:
        # Chase pos_data links to the nearest prior position parked no
        # deeper than ref.
        s2 = P[match_pos]
        while s2 > ref:
            match_pos = T[s2 & POS_MASK] & EXCL_VISITED_MASK
            s2 = P[match_pos]
        T[ref & POS_MASK] = p | VISITED_FLAG
        P[match_pos] = ref
        off = p - match_pos
        if count < mm and off <= MAX_OFFSET:
            rows.append(((p - halo) * NMATCHES_PER_OFFSET + count,
                         ((ref >> LCP_SHIFT) << 16) | off))
            count += 1
        if s2 == 0:
            return count
        ref = s2
        match_pos = T[ref & POS_MASK] & EXCL_VISITED_MASK


def walk_chunks_model(salcp: torch.Tensor, halo: int, core_len: int,
                      chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's schedule in plain Python, for the tests: the rows of
    ``walk_segments_plain``, launch by launch as ``csrc/walk.cu`` runs
    them. Chunk j walks [h_j, h_j + chunk) of the core, h_j = halo + j *
    chunk, from its own table, the canonical state at h_j:
    - every interval I with a position below h_j in its subtree holds
      VIS | last(I), the newest such position; every other interval keeps
      its phase-0 parent ref (the root, interval 0, keeps 0);
    - every position q < h_j is parked at the parent ref of the highest
      interval whose last is q (0 where that parent is the root), or at
      its leaf interval where the leaf's last is not q (0 at the root);
    - every position q >= h_j keeps its phase-0 leaf interval.

    Why the result is exact. The rows of position p depend only on the
    text: the nearest prior positions at each match length, longest
    first. The walk's tables are a lazy form of one fact, "for every
    interval, the newest visited position in its subtree": an interval
    that holds VIS | x is exact, and a position parked at a ref says which
    ancestors' marks it has been superseded in. The canonical state is
    that fact with nothing left lazy, so walking from it gives the rows
    of walking from 0 (checked on zero runs, period-3 runs, random bytes,
    repeated fragments and lz data, every chunk start down to chunk = 1:
    tests/test_torch_walk_chunks.py). Both parts of it come out of
    parallel work:
    - Sweep: last(I) for every chunk start is a running maximum per stack
      entry, one per chunk, of the positions attached to the entry (those
      below h_j), folded into the new top when the entry closes; the
      entry's value is final then, and written to every chunk's table.
    - Park: each q < h_j gets exactly one write, from the interval H with
      last(H) = q whose parent's last differs (last grows going up, so the
      intervals with last = q form one path), or from the leaf rule; the
      two never both hold, so the writes do not race.
    No word that neither launch wrote is read: the walk reads the leaf of
    p from the phase-0 table and positions below p from its own table,
    written by the park (q < h_j) or by the walk itself (q >= h_j)."""
    S, n = salcp.shape
    J = n_chunks(core_len, chunk)
    if halo < 0 or core_len < 0 or halo + core_len > n:
        raise ValueError(f"walk: bad geometry n={n} halo={halo} core={core_len}")
    out = torch.zeros((S, core_len, NMATCHES_PER_OFFSET), dtype=torch.int32)
    for s in range(S):
        rows = []
        _model_segment(salcp[s].tolist(), n, halo, core_len, chunk, J, rows)
        _scatter(out[s], rows)
    return out.to(salcp.device)


def _model_segment(salcp, n, halo, core_len, chunk, J, rows):
    h = [halo + j * chunk for j in range(J)]
    # 1. Sweep: the phase-0 tree (T0 parents, P0 leaves), and per chunk the
    # intervals' words of its table (Tc[j]), from J running maxima a stack
    # entry (-1: no position below h_j attached yet).
    T0, P0 = [0] * n, [0] * n
    Tc = [[None] * n for _ in range(J)]
    for Tj in Tc:
        Tj[0] = 0
    stack, mx = [0], [[-1] * J]

    def attach(q):
        m = mx[-1]
        for j in range(J):
            if q < h[j] and q > m[j]:
                m[j] = q

    def close(parent):
        """Pops the top entry; its maxima go to its chunks' words and, if
        ``parent`` is pushed in its place, stay; else fold into the new top."""
        closed = stack.pop() & POS_MASK
        m = mx.pop()
        T0[closed] = parent
        for j in range(J):
            Tc[j][closed] = VISITED_FLAG | m[j] if m[j] >= 0 else parent
        if stack and stack[-1] == parent:
            for j in range(J):
                mx[-1][j] = max(mx[-1][j], m[j])
        else:
            stack.append(parent)
            mx.append(m)

    prev_pos = salcp[0] & POS_MASK
    nidx = 1
    for i in range(1, n):
        packed = salcp[i]
        next_pos = packed & POS_MASK
        next_lcp = packed & LCP_MASK
        top_lcp = stack[-1] & LCP_MASK
        if next_lcp > top_lcp:
            stack.append(next_lcp | nidx)
            mx.append([-1] * J)
            nidx += 1
        P0[prev_pos] = stack[-1]
        attach(prev_pos)
        while next_lcp < stack[-1] & LCP_MASK:
            s_lcp = stack[-2] & LCP_MASK
            if next_lcp > s_lcp:
                close(next_lcp | nidx)
                nidx += 1
            else:
                close(stack[-2])
        prev_pos = next_pos
    P0[prev_pos] = stack[-1]
    attach(prev_pos)
    while len(stack) > 1:
        close(stack[-2])

    # 2. Park: each chunk's position words below h_j; one write each.
    Pc = [[None] * n for _ in range(J)]
    for j in range(J):
        Tj, Pj = Tc[j], Pc[j]
        for iv in range(1, nidx):  # the highest interval whose last is q
            v = Tj[iv]
            if v & VISITED_FLAG and Tj[T0[iv] & POS_MASK] != v:
                q = v & EXCL_VISITED_MASK
                assert Pj[q] is None
                Pj[q] = T0[iv]
        for q in range(h[j]):  # the leaf rule
            if Tj[P0[q] & POS_MASK] != VISITED_FLAG | q:
                assert Pj[q] is None
                Pj[q] = P0[q]
        assert None not in Pj[: h[j]]

    # 3. Walk: each chunk from its own table; leaves from the phase-0 table.
    for j in range(J):
        for p in range(h[j], min(h[j] + chunk, halo + core_len)):
            _visit(Tc[j], Pc[j], p, P0[p], NMATCHES_PER_OFFSET, halo, rows)
