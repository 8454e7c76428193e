"""The optimal-parse cost DP (kernel ``csrc/dp.cu``), its plain PyTorch
version, and the per-lane preparation around it.

Port of zultra_tpu.ops.dp_pallas (``_prep_lane``, ``run_dp_pallas``)
and of parse_wavefront's ``_varlen_tables``. The lane preparation packs,
per position and match slot, what the recurrence needs under the
current code lengths:

  lit       literal bit cost (0 past the block end)
  p1        sc << 16 | osize  for matches shorter than 40 (truncatable);
            osize = INF16 otherwise
  p2        clamped << 16 | lcs  for matches of 40 or more (length
            symbol + extra + offset bits); lcs = INF16 otherwise
  varlen40  length-symbol bits for k = 3..39 (rows 37..39 = BIG)

The DP returns chosen_len | slot << 9 per position (slot 0 = literal);
offsets are re-read from the match table by slot.

The kernel (``csrc/dp.cu``, replacing the TPU kernel
``zultra_tpu/ops/dp_pallas.py::_dp_kernel``) cuts each lane into
segments of SEG positions and makes three launches a call:
speculate every segment from a zero cost ring WARM positions above it,
check each against the segment above, fix up the rest sequentially,
top down. ``dp_segments_model`` is the same schedule in plain Python.

Why the result is exact: cost[p] reads only cost[p+1 .. p+258] (the
taps). If a segment's warm-up costs differ from the (exact up to a
constant) costs of the segment above by one constant over 258
consecutive positions, every candidate below carries that constant too,
and the packed minima keep their argmin and tie-breaks, so the choices
are the true ones; INF = 2^26 stays above every real candidate. A
segment whose run starts at the lane's length starts from the true
boundary; a segment that does not anchor is re-run from the ring of the
segment above, and the one below it is checked again. The argument
needs exact integer sums: a literal costs at most 15 bits (code lengths
<= 15) and a length symbol at most 20, so on a lane of at most MAX_LANE
= 2^21 positions (a 2 MiB block, the largest) every cost is at most
15 * 2^21 and a packed short, (cost + 20) * 64 + 63, stays below 2^31.
Every lane, whatever its length, runs the same schedule. The TPU kernel
clamps its packed sums at 2^24 - 1, but runs only on blocks of up to
2^20 positions (block_jax.DP_PALLAS_MAX_N), where no sum reaches that;
longer blocks take its scan DP, which has no clamp, nor has the
reference. Neither have the kernel and its plain forms here.
"""

from __future__ import annotations

import torch

from ..constants import LEAVE_ALONE_MATCH_SIZE, MIN_MATCH_SIZE, NMATCHES_PER_OFFSET

from .. import _build
from . import count_launch, plan_cuda
from .symbol_map import (
    matchlen_sym_extra_base,
    offset_index,
    offset_sym_extra_base,
    select_by_symbol,
)
from .tables import device_tables

INF = 1 << 26
INF16 = 0x7FFF
BIG = 1 << 30
N_SHORT = LEAVE_ALONE_MATCH_SIZE - MIN_MATCH_SIZE  # 37 truncation lengths
I32 = torch.int32
I64 = torch.int64

TAPS = 258  # cost[p] reads cost[p + 1 .. p + 258]
SEG = 1024  # positions per segment
WARM = 512  # warm-up positions above each segment
# The longest lane: a 2 MiB block. Past it the packed sums could pass 2^31.
MAX_LANE = 1 << 21
# Segment status, as the kernel leaves it.
ST_NONE, ST_EXACT, ST_ANCHORED, ST_SPECULATED, ST_RERUN = range(5)


def varlen_tables(lit_lens: torch.Tensor) -> torch.Tensor:
    """Length-symbol bit cost by encoded length e = len - 3 (B, 256):
    lit_lens[MATCHLEN_SYMBOL[e]] + MATCHLEN_EXTRA_BITS[e]."""
    t = device_tables(lit_lens.device)
    return lit_lens[:, t.matchlen_symbol] + t.matchlen_extra[None, :]


def prep_lanes(ll, ol, window, mlens, moffs, length):
    """Packed statics for B lanes: ll (B, 288) / ol (B, 32) code
    lengths, window (B, n) uint8, mlens/moffs (B, n, 8) int32, length
    (B,) int32. Returns lit (B, n), p1/p2 (B, n, 8), varlen40 (B, 40),
    all int32 and contiguous. A CPU tensor takes the plain form; a CUDA
    tensor one launch of the ``prep_lanes`` kernel (``plan_cuda``)."""
    if window.device.type == "cpu":
        return prep_lanes_plain(ll, ol, window, mlens, moffs, length)
    return plan_cuda.launch_prep_lanes(ll, ol, window, mlens, moffs, length)


def prep_lanes_plain(ll, ol, window, mlens, moffs, length):
    """``prep_lanes`` as tensor ops (dp_pallas._prep_lane, vmapped)."""
    B, n = window.shape
    dev = window.device
    idx = torch.arange(n, dtype=I32, device=dev)[None, :]
    in_block = idx < length[:, None]
    remaining = torch.clamp(length[:, None] - idx, min=0)
    lit = torch.where(in_block, torch.gather(ll, 1, window.to(I64)), 0)

    valid = mlens >= MIN_MATCH_SIZE
    clamped = torch.minimum(mlens, remaining[:, :, None])
    osym, oextra, _ = offset_sym_extra_base(offset_index(moffs))
    osize = select_by_symbol(ol, osym, 0, 30, 0) + oextra

    long_mask = valid & (mlens >= LEAVE_ALONE_MATCH_SIZE)
    short_mask = valid & (mlens < LEAVE_ALONE_MATCH_SIZE)
    sc = torch.where(short_mask, clamped, 0)
    p1 = (sc << 16) | torch.where(short_mask, osize, INF16)

    e_raw = clamped - MIN_MATCH_SIZE
    e = torch.where((e_raw < 0) | (e_raw > 255), 255, e_raw)
    lsym, lextra, _ = matchlen_sym_extra_base(e)
    varlen_e = select_by_symbol(ll, lsym, 257, 286, 0) + lextra
    lcs16 = torch.where(long_mask, varlen_e + osize, INF16)
    cl = torch.where(long_mask, clamped, 0)
    p2 = (cl << 16) | lcs16

    varlen40 = torch.cat([varlen_tables(ll)[:, :N_SHORT],
                          torch.full((B, 3), BIG, dtype=I32, device=dev)], dim=1)
    return (lit.to(I32).contiguous(), p1.to(I32).contiguous(), p2.to(I32).contiguous(),
            varlen40.to(I32).contiguous())


def check_segments(seg: int, warm: int) -> None:
    """The taps a re-run starts from, and the warm-up a segment is
    checked over, must lie in the one segment above it."""
    if seg < TAPS or not 0 <= warm <= seg:
        raise ValueError(f"dp: need seg >= {TAPS} and 0 <= warm <= seg, got {seg}, {warm}")


def dp_choices(lit, p1, p2, varlen40, length, *, status=False, seg=SEG, warm=WARM):
    """Packed choices (B, n) int32: chosen_len | slot << 9. ``length``
    (B,) int32 gives each lane's end; every position at or past it must
    hold lit 0 (``prep_lanes`` makes it so) and gets choice 0. With
    ``status=True`` also returns the (B, ceil(n / seg)) int8 segment
    status (``ST_*``). A CPU tensor takes the plain forms: the
    sequential recurrence, or the schedule's model when the status is
    asked for. Lanes wider than MAX_LANE are refused."""
    check_segments(seg, warm)
    if lit.shape[-1] > MAX_LANE:
        raise ValueError(f"dp: lanes of {lit.shape[-1]} positions, past {MAX_LANE}")
    if lit.device.type == "cpu":
        if status:
            return dp_segments_model(lit, p1, p2, varlen40, length, seg, warm)
        return dp_choices_plain(lit, p1, p2, varlen40)
    _build.check_cuda("dp lit", lit, I32, 2)
    _build.check_cuda("dp p1", p1, I32, 3)
    _build.check_cuda("dp p2", p2, I32, 3)
    _build.check_cuda("dp varlen40", varlen40, I32, 2)
    _build.check_cuda("dp length", length, I32, 1)
    B, n = lit.shape
    if (p1.shape != (B, n, NMATCHES_PER_OFFSET) or p2.shape != p1.shape
            or varlen40.shape != (B, 40) or length.shape != (B,)):
        raise ValueError("dp: inconsistent input shapes")
    nseg = -(-n // seg)
    out = torch.empty((B, n), dtype=I32, device=lit.device)
    cost = torch.empty((B, n), dtype=I32, device=lit.device)
    warm_costs = torch.empty((B * nseg, max(warm, 1)), dtype=I32, device=lit.device)
    st = torch.empty((B, nseg), dtype=torch.int8, device=lit.device)
    _build.launch("zt_dp", lit.data_ptr(), p1.data_ptr(), p2.data_ptr(), varlen40.data_ptr(),
                  length.data_ptr(), out.data_ptr(), cost.data_ptr(), warm_costs.data_ptr(),
                  st.data_ptr(), B, n, seg, warm)
    count_launch("dp")
    return (out, st) if status else out


def dp_choices_plain(lit, p1, p2, varlen40) -> torch.Tensor:
    """The recurrence as a plain loop over each lane's positions (Python
    ints), with the kernel's exact constants and tie-breaks, from
    cost 0 at the padded end n."""
    B, n = lit.shape
    out = [
        _dp_span(lit[b].tolist(), p1[b].tolist(), p2[b].tolist(), varlen40[b].tolist(), 0, n,
                 [0] * TAPS)[1]
        for b in range(B)
    ]
    return torch.tensor(out, dtype=I32, device=lit.device).reshape(B, n)


def _dp_span(lit, p1, p2, vl, lo, hi, top):
    """The recurrence from hi - 1 down to lo, given ``top``, the TAPS
    costs of positions hi .. hi + TAPS - 1. -> (costs, choices), each a
    list over [lo, hi)."""
    cost = [0] * (hi - lo) + list(top)  # cost[p - lo]
    out = [0] * (hi - lo)
    for p in range(hi - 1, lo - 1, -1):
        i = p - lo
        row1 = p1[p]
        row2 = p2[p]
        need = 0
        for a in row1:
            need = max(need, (a >> 16) - MIN_MATCH_SIZE)
        # Packed prefix minimum over k = 3..3+need (the shorts).
        pm = []
        run = 1 << 62
        for k in range(MIN_MATCH_SIZE, MIN_MATCH_SIZE + need + 1):
            x = vl[k - MIN_MATCH_SIZE] + cost[i + k]
            run = min(run, x * 64 + 63 - k)
            pm.append(run)
        key = (lit[p] + cost[i + 1]) * 16
        lsel = 0
        for m in range(NMATCHES_PER_OFFSET):
            a = row1[m]
            sc = a >> 16
            wg = pm[max(sc - MIN_MATCH_SIZE, 0)]
            cand = (wg >> 6) + (a & 0xFFFF) if sc >= MIN_MATCH_SIZE else INF
            b = row2[m]
            cl = b >> 16
            lcs = b & 0xFFFF
            valid_l = lcs != INF16
            if valid_l:
                cand = min(cand, lcs + (cost[i + cl] if cl >= LEAVE_ALONE_MATCH_SIZE else 0))
            km = cand * 16 + m + 1
            if km < key:
                key = km
                lsel = cl if valid_l else 63 - (wg & 63)
        mcode = key & 15
        cost[i] = key >> 4
        out[i] = (lsel if mcode else 0) | (mcode << 9)
    return cost[: hi - lo], out


def _anchored(warm_costs, costs) -> bool:
    """True when the two cost runs differ by one constant over TAPS
    consecutive positions (the shift check)."""
    run, prev = 0, None
    for w, c in zip(warm_costs, costs):
        d = w - c
        run = run + 1 if d == prev else 1
        prev = d
        if run >= TAPS:
            return True
    return False


def dp_segments_model(lit, p1, p2, varlen40, length, seg=SEG, warm=WARM):
    """The kernel's schedule in plain Python, for the tests: (choices
    (B, n) int32, segment status (B, ceil(n / seg)) int8). Phase by
    phase as ``csrc/dp.cu`` runs it."""
    check_segments(seg, warm)
    B, n = lit.shape
    nseg = -(-n // seg)
    out = torch.zeros((B, n), dtype=I32)
    st = torch.zeros((B, nseg), dtype=torch.int8)
    for b in range(B):
        rows = (lit[b].tolist(), p1[b].tolist(), p2[b].tolist(), varlen40[b].tolist())
        L = min(max(int(length[b]), 0), n)
        o, s = _model_lane(rows, L, seg, warm)
        out[b, :L] = torch.tensor(o, dtype=I32)
        st[b, : len(s)] = torch.tensor(s, dtype=torch.int8)
    return out.to(lit.device), st.to(lit.device)


def _model_lane(rows, L, seg, warm):
    k = -(-L // seg)
    cost, out, warm_costs, st = [0] * L, [0] * L, [None] * k, [0] * k
    bounds = [(s * seg, min(s * seg + seg, L)) for s in range(k)]
    # 1. Speculate: every segment from a zero ring at min(b + warm, L).
    for s, (a, b) in enumerate(bounds):
        top = min(b + warm, L)
        c, o = _dp_span(*rows, a, top, [0] * TAPS)
        cost[a:b], out[a:b], warm_costs[s] = c[: b - a], o[: b - a], c[b - a :]
        st[s] = ST_EXACT if top == L else ST_SPECULATED
    # 2. Check each speculated segment against the one above it.
    for s, (a, b) in enumerate(bounds):
        if st[s] == ST_SPECULATED:
            st[s] = ST_ANCHORED if _anchored(warm_costs[s], cost[b : b + warm]) else ST_SPECULATED
    # 3. Fix up, top down: re-run what is not anchored from the ring above,
    # and check the segment below each re-run against its new costs.
    above = False
    for s in range(k - 1, -1, -1):
        a, b = bounds[s]
        if above:
            if st[s] == ST_EXACT or _anchored(warm_costs[s], cost[b : b + warm]):
                st[s] = ST_EXACT if st[s] == ST_EXACT else ST_ANCHORED
                above = False
                continue
        elif st[s] != ST_SPECULATED:
            continue
        top = [cost[q] if q < L else 0 for q in range(b, b + TAPS)]
        cost[a:b], out[a:b] = _dp_span(*rows, a, b, top)
        st[s] = ST_RERUN
        above = True
    return out, st


def run_dp(lit_lens, off_lens, window, mlens, moffs, length):
    """One batched DP pass: (best_len, best_off), each (B, n) int32."""
    v = dp_choices(*prep_lanes(lit_lens, off_lens, window, mlens, moffs, length), length)
    best_len = v & 511
    mcode = (v >> 9).to(I64)
    got = torch.gather(moffs, 2, torch.clamp(mcode - 1, min=0)[:, :, None])[:, :, 0]
    return best_len, torch.where(mcode > 0, got, 0)
