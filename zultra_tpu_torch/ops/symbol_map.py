"""Closed-form DEFLATE symbol maps on int32 tensors.

The (encoded length -> symbol/extra/base) and (offset index ->
symbol/extra/base) maps of RFC 1951 (constants._build_length_tables /
_build_offset_tables) are functions of floor(log2(x)) and one mantissa
bit, so every caller computes them elementwise instead of gathering from
the 256/512-entry tables. Same contract as zultra_tpu.ops.symbol_map.
"""

from __future__ import annotations

import torch


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x >= 1 (callers clamp). frexp of the
    float64 value is exact for every int32: x = m * 2^e, m in [0.5, 1)."""
    _, e = torch.frexp(x.to(torch.float64))
    return (e - 1).to(torch.int32)


def matchlen_sym_extra_base(e: torch.Tensor):
    """(symbol, extra_bits, encoded_base) for encoded length e = len - 3,
    0..255 — equals MATCHLEN_SYMBOL/EXTRA_BITS/BASE[e] elementwise."""
    e = e.to(torch.int32)
    k = torch.clamp(floor_log2(torch.clamp(e, min=1)), min=2)
    extra_hi = k - 2
    q = e >> extra_hi
    sym_hi = 249 + 4 * k + q
    base_hi = q << extra_hi
    low = e < 8
    top = e == 255  # length 258: symbol 285, no extra bits
    sym = torch.where(low, 257 + e, torch.where(top, 285, sym_hi))
    extra = torch.where(low | top, 0, extra_hi)
    base = torch.where(low, e, torch.where(top, 255, base_hi))
    return sym, extra, base


def offset_sym_extra_base(oidx: torch.Tensor):
    """(symbol, extra_bits, base_offset) for the two-level offset index
    (raw_off < 256 ? raw_off : 256 + ((raw_off - 256) >> 7)) — equals
    OFFSET_SYMBOL/EXTRA_BITS/BASE[oidx] for every valid index 0..509."""
    oidx = oidx.to(torch.int32)
    j = torch.where(oidx < 256, oidx, ((oidx - 256) << 7) + 256)
    k = torch.clamp(floor_log2(torch.clamp(j, min=1)), min=1)
    bit = (j >> (k - 1)) & 1
    low = j < 4
    sym = torch.where(low, j, 2 * k + bit)
    extra = torch.where(low, 0, k - 1)
    base = torch.where(low, j + 1, ((2 + bit) << (k - 1)) + 1)
    return sym, extra, base


def offset_index(offs: torch.Tensor) -> torch.Tensor:
    """Two-level offset-table index of match offsets (0 -> index 0),
    clipped to the table's 0..511 range."""
    raw = torch.clamp(offs - 1, min=0)
    oidx = torch.where(raw < 256, raw, 256 + ((raw - 256) >> 7))
    return torch.clamp(oidx, 0, 511)


def select_by_symbol(table_rows: torch.Tensor, sym: torch.Tensor, lo: int,
                     hi: int, init: int) -> torch.Tensor:
    """out[...] = table_rows[..., sym[...]] for sym in [lo, hi), ``init``
    elsewhere. ``table_rows`` is (B, S) and ``sym`` is (B, ...): a
    gather along the symbol axis with out-of-range symbols masked."""
    inside = (sym >= lo) & (sym < hi)
    B = table_rows.shape[0]
    idx = torch.where(inside, sym, lo).to(torch.int64).reshape(B, -1)
    got = torch.gather(table_rows, 1, idx).reshape(sym.shape)
    return torch.where(inside, got, torch.full_like(got, init))
