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
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    LEAVE_ALONE_MATCH_SIZE,
    MATCHLEN_EXTRA_BITS,
    MATCHLEN_SYMBOL,
    MIN_MATCH_SIZE,
    NMATCHES_PER_OFFSET,
)

from .. import _build
from .symbol_map import (
    matchlen_sym_extra_base,
    offset_index,
    offset_sym_extra_base,
    select_by_symbol,
)

INF = 1 << 26
INF16 = 0x7FFF
BIG = 1 << 30
CLAMPX = (1 << 24) - 1
N_SHORT = LEAVE_ALONE_MATCH_SIZE - MIN_MATCH_SIZE  # 37 truncation lengths
I32 = torch.int32
I64 = torch.int64

launches = 0  # kernel launches since the last reset


def varlen_tables(lit_lens: torch.Tensor) -> torch.Tensor:
    """Length-symbol bit cost by encoded length e = len - 3 (B, 256):
    lit_lens[MATCHLEN_SYMBOL[e]] + MATCHLEN_EXTRA_BITS[e]."""
    dev = lit_lens.device
    sym = torch.as_tensor(np.asarray(MATCHLEN_SYMBOL, np.int64), device=dev)
    extra = torch.as_tensor(np.asarray(MATCHLEN_EXTRA_BITS, np.int32), device=dev)
    return lit_lens[:, sym] + extra[None, :]


def prep_lanes(ll, ol, window, mlens, moffs, length):
    """Packed statics for B lanes: ll (B, 288) / ol (B, 32) code
    lengths, window (B, n) uint8, mlens/moffs (B, n, 8) int32, length
    (B,) int32. Returns lit (B, n), p1/p2 (B, n, 8), varlen40 (B, 40),
    all int32 and contiguous."""
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


def dp_choices(lit, p1, p2, varlen40) -> torch.Tensor:
    """Packed choices (B, n) int32: chosen_len | slot << 9."""
    global launches
    if lit.device.type == "cpu":
        return dp_choices_plain(lit, p1, p2, varlen40)
    _build.check_cuda("dp lit", lit, I32, 2)
    _build.check_cuda("dp p1", p1, I32, 3)
    _build.check_cuda("dp p2", p2, I32, 3)
    _build.check_cuda("dp varlen40", varlen40, I32, 2)
    B, n = lit.shape
    if p1.shape != (B, n, NMATCHES_PER_OFFSET) or p2.shape != p1.shape or varlen40.shape != (B, 40):
        raise ValueError("dp: inconsistent input shapes")
    out = torch.empty((B, n), dtype=I32, device=lit.device)
    _build.launch("zt_dp", lit.data_ptr(), p1.data_ptr(), p2.data_ptr(), varlen40.data_ptr(),
                  out.data_ptr(), B, n)
    launches += 1
    return out


def dp_choices_plain(lit, p1, p2, varlen40) -> torch.Tensor:
    """The recurrence as a plain loop over each lane's positions (Python
    ints), with the kernel's exact constants and tie-breaks."""
    B, n = lit.shape
    out = [
        _dp_lane(lit[b].tolist(), p1[b].tolist(), p2[b].tolist(), varlen40[b].tolist(), n)
        for b in range(B)
    ]
    return torch.tensor(out, dtype=I32, device=lit.device).reshape(B, n)


def _dp_lane(lit, p1, p2, vl, n):
    cost = [0] * (n + 272)  # cost[p] = 0 for p >= n: the boundary
    out = [0] * n
    for p in range(n - 1, -1, -1):
        row1 = p1[p]
        row2 = p2[p]
        need = 0
        for a in row1:
            need = max(need, (a >> 16) - MIN_MATCH_SIZE)
        # Packed prefix minimum over k = 3..3+need (the shorts).
        pm = []
        run = 1 << 62
        for k in range(MIN_MATCH_SIZE, MIN_MATCH_SIZE + need + 1):
            x = min(vl[k - MIN_MATCH_SIZE] + cost[p + k], CLAMPX)
            run = min(run, x * 64 + 63 - k)
            pm.append(run)
        key = (lit[p] + cost[p + 1]) * 16
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
                cand = min(cand, lcs + (cost[p + cl] if cl >= LEAVE_ALONE_MATCH_SIZE else 0))
            km = cand * 16 + m + 1
            if km < key:
                key = km
                lsel = cl if valid_l else 63 - (wg & 63)
        mcode = key & 15
        cost[p] = key >> 4
        out[p] = (lsel if mcode else 0) | (mcode << 9)
    return out


def run_dp(lit_lens, off_lens, window, mlens, moffs, length):
    """One batched DP pass: (best_len, best_off), each (B, n) int32."""
    v = dp_choices(*prep_lanes(lit_lens, off_lens, window, mlens, moffs, length))
    best_len = v & 511
    mcode = (v >> 9).to(I64)
    got = torch.gather(moffs, 2, torch.clamp(mcode - 1, min=0)[:, :, None])[:, :, 0]
    return best_len, torch.where(mcode > 0, got, 0)
