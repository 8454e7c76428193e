"""Greedy token-chain marks (kernel ``csrc/chain.cu``), their plain
PyTorch version, and the plain model of the kernel's schedule.

For each lane, the chain p0 = start, p_{k+1} = p_k + max(step[p_k], 1)
marks every position it visits below ``length`` — the token starts of a
greedy or chosen parse (zultra src/blockdeflate.c:333-361). Same
contract as zultra_tpu.ops.chain_pallas.chain_marks_pallas and the
pointer-doubling masks of block_jax._chain_mask / split_jax.

The kernel (``csrc/chain.cu``, replacing the TPU kernel
``zultra_tpu/ops/chain_pallas.py::_chain_kernel``) cuts each lane into
segments [a_j, b_j) of SEG positions and makes two launches a call:
speculate every segment at once, then resolve each lane's segments in
order. ``chain_segments_model`` is the same schedule in plain Python.

Why the result is exact. Let E_j be the true chain's first position at
or past a_j; the marks of [a_j, b_j) are a function of E_j alone, since
two chains that share one position are identical from there on. The
speculative chain S_j starts at max(start, a_j - WARM) and stops at its
first position at or past min(b_j, length); F_j is its first position
at or past a_j and X_j its last, the first at or past the segment's end.
- If S_j started at ``start`` it is the true chain: status EXACT.
- If F_j = E_j, S_j is the true chain from a_j on: its marks are exact
  and E_{j+1} = X_j (ANCHORED).
- Otherwise the true chain is walked from E_j over the segment until it
  lands on a position S_j marked (the chains merge there: the marks from
  that position on are exact, and E_{j+1} = X_j; RERUN), or leaves the
  segment without doing so (its own marks replace S_j's, and E_{j+1} is
  where it left; UNMERGED).
E_0 is ``start``, and each E_{j+1} comes from a resolved segment j, so
one ordered pass over a lane's segments resolves all of them exactly, at
O(1) a segment that anchors.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from . import count_launch

# Segment and warm-up sizes, from a sweep on an H100 (`python3 -m
# zultra_tpu_torch.chain_bench --sweep`, PERF.md §6): the fewest re-walks
# for the least time on the splitter's and planner's lanes.
SEG = 256  # positions per segment
WARM = 128  # warm-up positions below each segment
# Segment status, as the kernel leaves it (SPECULATED only between launches).
ST_NONE, ST_EXACT, ST_ANCHORED, ST_SPECULATED, ST_RERUN, ST_UNMERGED = range(6)
SEG_MAX = 16384  # a segment, and its warm-up, must fit the kernels' shared memory
N_MAX = 1 << 30  # positions per lane (hops are clamped to this, so no int32 overflow)


def check_segments(seg: int, warm: int) -> None:
    if not (1 <= seg <= SEG_MAX and 0 <= warm <= SEG_MAX):
        raise ValueError(f"chain: need 1 <= seg <= {SEG_MAX} and 0 <= warm <= {SEG_MAX}, "
                         f"got {seg}, {warm}")


def chain_marks(step: torch.Tensor, start: torch.Tensor, length: torch.Tensor, *,
                status: bool = False, seg: int = SEG, warm: int = WARM):
    """step (B, n) int32 hop sizes, start/length (B,) int32 -> (B, n)
    bool, True at every chain position p with start <= p < length. With
    ``status=True`` also returns the (B, ceil(n / seg)) int8 segment
    status (``ST_*``). A CPU tensor takes the plain forms: pointer
    doubling, or the schedule's model when the status is asked for."""
    check_segments(seg, warm)
    if step.device.type == "cpu":
        if status:
            return chain_segments_model(step, start, length, seg, warm)
        return chain_marks_plain(step, start, length)
    for name, t, nd in (("step", step, 2), ("start", start, 1), ("length", length, 1)):
        _build.check_cuda(f"chain {name}", t, torch.int32, nd)
    B, n = step.shape
    if start.shape[0] != B or length.shape[0] != B:
        raise ValueError("chain: start/length must have one entry per lane")
    if n >= N_MAX:
        raise ValueError(f"chain: lanes of {n} positions, at most {N_MAX - 1}")
    nseg = -(-n // seg)
    marks = torch.empty((B, n), dtype=torch.uint8, device=step.device)
    fx = torch.empty((2, B, nseg), dtype=torch.int32, device=step.device)
    st = torch.empty((B, nseg), dtype=torch.int8, device=step.device)
    _build.launch("zt_chain", step.data_ptr(), start.data_ptr(), length.data_ptr(),
                  marks.data_ptr(), fx.data_ptr(), st.data_ptr(), B, n, seg, warm)
    count_launch("chain")
    marks = marks.view(torch.bool)  # every byte is 0 or 1
    return (marks, st) if status else marks


def chain_marks_plain(step: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Pointer doubling: after r rounds every position reachable from
    ``start`` within 2^r hops is marked."""
    B, n = step.shape
    dev = step.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    nxt = torch.clamp(idx + torch.clamp(step.to(torch.int64), min=1), max=n)
    jmp = torch.cat([nxt, torch.full((B, 1), n, dtype=torch.int64, device=dev)], dim=1)
    mark = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    mark.scatter_(1, torch.clamp(start.to(torch.int64), 0, n)[:, None], 1)
    for _ in range(max(1, int(math.ceil(math.log2(n + 1))) + 1)):
        hop = torch.zeros_like(mark).scatter_reduce(1, jmp, mark, "amax")
        mark = torch.maximum(mark, hop)
        jmp = torch.gather(jmp, 1, jmp)
    return (mark[:, :n] == 1) & (idx >= start[:, None]) & (idx < length[:, None])


def chain_segments_model(step, start, length, seg=SEG, warm=WARM):
    """The kernel's schedule in plain Python, for the tests: (marks (B,
    n) bool, segment status (B, ceil(n / seg)) int8), phase by phase as
    ``csrc/chain.cu`` runs it."""
    check_segments(seg, warm)
    B, n = step.shape
    nseg = -(-n // seg)
    marks = torch.zeros((B, n), dtype=torch.bool)
    st = torch.zeros((B, nseg), dtype=torch.int8)
    for b in range(B):
        s = min(max(int(start[b]), 0), n)
        L = min(max(int(length[b]), 0), n)
        m, row = _model_lane(step[b].tolist(), s, L, n, seg, warm)
        marks[b] = torch.tensor(m, dtype=torch.bool)
        st[b] = torch.tensor(row, dtype=torch.int8)
    return marks.to(step.device), st.to(step.device)


def _model_lane(step, s, L, n, seg, warm):
    nseg = -(-n // seg)
    marks, st = [0] * n, [ST_NONE] * nseg
    F, X = [0] * nseg, [0] * nseg

    def hop(p):
        return min(max(step[p], 1), N_MAX)

    # 1. Speculate: every segment that holds part of [s, L), from a warm-up
    # start below it; the segment holding s starts at s itself.
    for j in range(nseg):
        a, b = j * seg, min(j * seg + seg, n)
        lim = min(b, L)
        if s >= L or a >= L or b <= s:
            continue
        p = max(s, a - warm)
        st[j] = ST_EXACT if p == s else ST_SPECULATED
        while p < a:
            p += hop(p)
        F[j] = p
        while p < lim:
            marks[p] = 1
            p += hop(p)
        X[j] = p
    # 2. Resolve, in order, carrying E (the true chain's first position in
    # the segment at hand).
    E = None
    for j in range(nseg):
        if st[j] == ST_NONE:
            continue
        if st[j] == ST_EXACT or F[j] == E:
            st[j] = ST_EXACT if st[j] == ST_EXACT else ST_ANCHORED
            E = X[j]
            continue
        a, lim = j * seg, min(j * seg + seg, L)
        p, true = E, []
        while p < lim and not marks[p]:  # the segment's marks are still S_j's
            true.append(p)
            p += hop(p)
        merged = p < lim
        m = p if merged else lim  # S_j's marks from m on stand
        marks[a:m] = [0] * (m - a)
        for q in true:
            marks[q] = 1
        st[j] = ST_RERUN if merged else ST_UNMERGED
        E = X[j] if merged else p
    return marks, st
