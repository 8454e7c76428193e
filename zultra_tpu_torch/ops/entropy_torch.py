"""Batched Huffman bundle: Moffat-Katajainen code lengths, Kraft-sum
length limiting, canonical codewords, the code-length table's RLE
statistics, the Zopfli histogram rewrite, the dynamic/static block cost
estimators and the CL-mask search.

Port of zultra_tpu.ops.entropy_jax in the configuration the JAX package
runs on a TPU (``_mk_impl() == "pallas"``): the sequential MK merge and
parent-chain phases and the Kraft lengthen/shorten sweeps go through the
kernels of ``mk_cuda`` (plain loops on CPU tensors), every histogram of
the batch a lane, and the (key, index) sorts through the ``lex_order``
kernel of ``plan_cuda``; MK phase 3's closed form and the scatters back
to symbol order are tensor ops around them. The Zopfli rewrite's
decision sweep and the RLE statistics (every mask of the CL-mask search
in one launch a mode, the concatenation of the code lengths in the
kernel) go through the kernels of ``rle_cuda``. Reference
semantics:
zultra src/huffman/huffencoder.c:157-346 and :446-735,
src/blockdeflate.c:538-618. Every tie-break (sort by (weight, symbol),
strict phase-1 comparisons, the <=1-used-symbol quirk) is reproduced.
"""

from __future__ import annotations

import torch

from ..constants import NCODELENSYMS

from . import mk_cuda, plan_cuda
from .rle_cuda import (  # noqa: F401
    concat_lengths as _concat_lengths,
    defined_count,
    optimize_for_rle,
    optimize_for_rle_pair,
    rle_bits_masks,
    rle_bits_tables,
    rle_histogram_masks,
    rle_histogram_tables,
)
from .tables import MASK_ORDER, device_tables

INF32 = 2**30
I32 = torch.int32
I64 = torch.int64


def _arange(n, dev, dtype=I32):
    return torch.arange(n, dtype=dtype, device=dev)


def _scatter_dump(shape, dev, idx, src, reduce, fill=0):
    """Scatter ``src`` into a fresh (B, S + 1) tensor along dim 1 and
    drop the last column: indices equal to S land in the dump column,
    which is how the JAX package's out-of-range drops are expressed."""
    B, S = shape
    out = torch.full((B, S + 1), fill, dtype=src.dtype, device=dev)
    if reduce == "set":
        out.scatter_(1, idx.to(I64), src)
    else:
        out.scatter_reduce_(1, idx.to(I64), src, reduce)
    return out[:, :S]


def _lex_order(key: torch.Tensor) -> torch.Tensor:
    """Indices sorting ``key`` ascending along dim 1, ties broken by
    index: the order of lax.sort((key, iota), num_keys=2). A CPU tensor
    takes the plain form; a CUDA tensor one launch of the ``lex_order``
    kernel (``plan_cuda``)."""
    if key.device.type == "cpu":
        return _lex_order_plain(key)
    return plan_cuda.launch_lex_order(key)


def _lex_order_plain(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=1, stable=True)[1]


# ---------------------------------------------------------------------------
# Moffat-Katajainen lengths
# ---------------------------------------------------------------------------


def mk_inputs(hist: torch.Tensor):
    """What the MK kernel takes for ``hist`` (B, S): the used weights
    sorted by (weight, symbol) with zeros after them, n_used (B,), and
    the sort order (B, S) int64."""
    used = hist > 0
    n_used = used.sum(dim=1, dtype=I32)
    key = torch.where(used, hist, INF32).to(I32)
    queue = _lex_order(key)
    key_sorted = torch.gather(key, 1, queue)
    a0 = torch.where(key_sorted < INF32, key_sorted, 0).contiguous()
    return a0, n_used, queue


def mk_lengths(hist: torch.Tensor) -> torch.Tensor:
    """Batched minimum-redundancy code lengths, UNLIMITED. hist (B, S)
    int32 -> (B, S) int32; <=1 used symbol gives all zeros except
    lengths[0] = 1."""
    B, S = hist.shape
    dev = hist.device
    a0, n_used, queue = mk_inputs(hist)
    a = mk_cuda.mk_phase12(a0, n_used)

    # Phase 3 (closed form): leaves_at[d] = 2 internal_at[d-1] -
    # internal_at[d]; leaf depths fill sorted positions deepest-first.
    sym = _arange(S, dev)[None, :]
    t_in = sym < (n_used - 1)[:, None]
    depth_clip = torch.clamp(a, 0, S - 1)
    internal_at = _scatter_dump((B, S), dev, torch.where(t_in, depth_clip, S),
                                torch.ones_like(a), "sum")
    avail = torch.cat([torch.ones((B, 1), dtype=I32, device=dev), 2 * internal_at[:, :-1]], dim=1)
    leaves_at = avail - internal_at
    cum_excl = torch.cumsum(leaves_at, dim=1, dtype=I32) - leaves_at
    fill = _scatter_dump((B, S), dev,
                         torch.where(leaves_at > 0, torch.clamp(cum_excl, 0, S - 1), S),
                         sym.expand(B, S).contiguous(), "amax", fill=-1)
    depth_of_r = torch.cummax(fill, dim=1)[0]
    r_of_i = torch.clamp(n_used[:, None] - 1 - sym, 0, S - 1)
    len_sorted = torch.gather(depth_of_r, 1, r_of_i.to(I64))
    len_sorted = torch.where(sym < n_used[:, None], len_sorted, 0)
    lengths = torch.zeros((B, S), dtype=I32, device=dev).scatter_(1, queue, len_sorted)

    few = (n_used <= 1)[:, None]
    quirk = (sym == 0).to(I32).expand(B, S)
    return torch.where(few, quirk, lengths)


def limited_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Kraft-sum length limiting of unlimited MK lengths: clamp overlong
    codes, lengthen the rarest symbols until the Kraft sum fits, then
    re-shorten the most frequent while room remains. Only lanes with a
    code longer than ``max_len`` change. On the card every lane is
    repaired and the over-long lanes selected (no host sync, as
    entropy_jax.limited_lengths does on a TPU); the plain form sweeps the
    over-long lanes alone."""
    if not lengths.is_cuda:
        return _limited_lengths_plain(lengths, max_len)
    over = lengths.max(dim=1)[0] > max_len
    return torch.where(over[:, None], _kraft_repair(lengths, max_len), lengths)


def _limited_lengths_plain(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    over = lengths.max(dim=1)[0] > max_len
    if not bool(over.any()):
        return lengths
    lanes = torch.nonzero(over)[:, 0]
    out = lengths.clone()
    out[lanes] = _kraft_repair(lengths[lanes], max_len)
    return out


def kraft_inputs(lengths: torch.Tensor, max_len: int):
    """What the Kraft kernel takes for ``lengths`` (B, S): the used
    lengths sorted by (length, symbol) and clamped to ``max_len``, n_used
    and the clamped Kraft sum (B,), the sort order (B, S) int64 and the
    used-slot mask."""
    S = lengths.shape[1]
    full = 1 << max_len
    used = lengths > 0
    sym = _arange(S, lengths.device)[None, :]
    key = torch.where(used, lengths * S + sym, INF32)
    order = _lex_order(key)  # unused symbols' order is irrelevant (masked)
    n_used = used.sum(dim=1, dtype=I32)
    lens = torch.clamp(torch.gather(lengths, 1, order), max=max_len).contiguous()
    in_used = sym < n_used[:, None]
    kraft0 = torch.where(in_used, full >> lens, 0).sum(dim=1, dtype=I32)
    return lens, n_used, kraft0, order, in_used


def _kraft_repair(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    lens, n_used, kraft0, order, in_used = kraft_inputs(lengths, max_len)
    lens = mk_cuda.kraft_limit(lens, n_used, kraft0, max_len)
    return torch.zeros_like(lengths).scatter_(1, order, torch.where(in_used, lens, 0))


def build_lengths(hist: torch.Tensor, max_len: int) -> torch.Tensor:
    """MK lengths + Kraft limiting (build_dynamic_codewords' lengths)."""
    return limited_lengths(mk_lengths(hist), max_len)


def _reverse_bits16(word, nbits):
    w = word
    for lo, hi, sh in ((0x5555, 0xAAAA, 1), (0x3333, 0xCCCC, 2),
                       (0x0F0F, 0xF0F0, 4), (0x00FF, 0xFF00, 8)):
        w = ((w & lo) << sh) | ((w & hi) >> sh)
    return torch.where(nbits > 0, w >> (16 - torch.clamp(nbits, max=16)), 0)


def canonical_codewords(lengths: torch.Tensor) -> torch.Tensor:
    """Canonical bit-reversed codewords over (length, symbol) order;
    zero-length symbols get codeword 0."""
    B, S = lengths.shape
    dev = lengths.device
    used = lengths > 0
    MAXL = 16
    lclip = torch.clamp(lengths, 0, MAXL)
    cnt = _scatter_dump((B, MAXL + 1), dev, torch.where(used, lclip, 0),
                        used.to(I32), "sum")
    next_code = torch.zeros((B, MAXL + 1), dtype=I32, device=dev)
    code = torch.zeros(B, dtype=I32, device=dev)
    for d in range(1, MAXL + 1):
        code = (code + cnt[:, d - 1]) << 1
        next_code[:, d] = code
    sym = _arange(S, dev)[None, :]
    order = _lex_order(torch.where(used, lengths * S + sym, INF32))
    pos = torch.empty((B, S), dtype=I32, device=dev).scatter_(1, order, sym.expand(B, S).contiguous())
    cum_shorter = torch.cumsum(cnt, dim=1, dtype=I32) - cnt
    rank = pos - torch.gather(cum_shorter, 1, lclip.to(I64))
    word = torch.gather(next_code, 1, lclip.to(I64)) + rank
    return torch.where(used, _reverse_bits16(word, lengths), 0)


# ---------------------------------------------------------------------------
# Code-length table RLE statistics
# ---------------------------------------------------------------------------


def rle_histogram(lens: torch.Tensor, n_def: torch.Tensor, mask: int) -> torch.Tensor:
    """CL-symbol histogram of the RLE walk over each lane's lengths
    (update_var_lengths_entropy). lens (B, L), n_def (B,) -> (B, 19)."""
    return rle_histogram_masks(lens, n_def, (mask,))


def rle_bits(lens: torch.Tensor, n_def: torch.Tensor, te_lens: torch.Tensor,
             mask: int) -> torch.Tensor:
    """Bit size of the RLE-coded table under CL lengths ``te_lens``
    (get_var_lengths_size). -> (B,)."""
    return rle_bits_masks(lens, n_def, te_lens, (mask,))


def raw_table_size(te_lens: torch.Tensor) -> torch.Tensor:
    """CL lengths in transmission order, trailing zeros trimmed, >= 4."""
    in_order = te_lens[:, device_tables(te_lens.device).codelen_order]
    posp1 = _arange(NCODELENSYMS, te_lens.device)[None, :] + 1
    last = torch.where(in_order != 0, posp1, 0).max(dim=1)[0]
    return torch.clamp(last, min=4)


# ---------------------------------------------------------------------------
# Block cost estimators and the CL-mask search
# ---------------------------------------------------------------------------


def static_cost(lit_hist: torch.Tensor, off_hist: torch.Tensor) -> torch.Tensor:
    """evaluate_static_cost (reference src/blockdeflate.c:538-566)."""
    t = device_tables(lit_hist.device)
    lit_counted = torch.where(t.lit_counted, lit_hist, 0)
    cost = (lit_counted * (t.static_lit_len + t.lit_extra)).sum(dim=1, dtype=I32)
    cost = cost + (off_hist * (5 + t.off_extra)).sum(dim=1, dtype=I32)
    return cost + 3


def _symbol_and_table_cost(lit_hist, off_hist, lit_len, off_len):
    t = device_tables(lit_hist.device)
    lit_counted = torch.where(t.lit_counted, lit_hist, 0)
    cost = (lit_counted * (lit_len + t.lit_extra)).sum(dim=1, dtype=I32)
    cost = cost + (off_hist * (off_len + t.off_extra)).sum(dim=1, dtype=I32)
    te_len = mk_lengths(rle_histogram_tables(lit_len, off_len, (7,))[0]).contiguous()
    cost = cost + 5 + 5 + 4
    cost = cost + 3 * raw_table_size(te_len)
    cost = cost + rle_bits_tables(lit_len, off_len, te_len, (31,))
    return cost + 3


def dynamic_cost_given(lit_hist, off_hist, lit_len, off_len) -> torch.Tensor:
    """evaluate_dynamic_cost with GIVEN (limited) code lengths."""
    return _symbol_and_table_cost(lit_hist, off_hist, lit_len, off_len)


def dynamic_cost(lit_hist: torch.Tensor, off_hist: torch.Tensor) -> torch.Tensor:
    """estimated_dynamic_cost_of_entropy: unlimited MK lengths from the
    histograms, symbol cost + dynamic table cost + 3 header bits."""
    return _symbol_and_table_cost(lit_hist, off_hist, mk_lengths(lit_hist),
                                  mk_lengths(off_hist))


def mask_histograms(lit_len: torch.Tensor, off_len: torch.Tensor):
    """The CL histograms of every mask in MASK_ORDER of each lane's
    concatenated lengths, stacked mask-major into one
    (len(MASK_ORDER) * B, 19) batch, with n_lit, n_off (B,)."""
    return rle_histogram_tables(lit_len, off_len, MASK_ORDER)


def mask_search(lit_len: torch.Tensor, off_len: torch.Tensor):
    """Evaluate every CL-code mask in the reference order (0..7, then
    odd 9..31); later masks win cost ties. The masks' CL lengths are
    built in one stacked batch. Returns (best_mask (B,), cl_len (B, 19),
    n_lit, n_off)."""
    B = lit_len.shape[0]
    hists, n_lit, n_off = mask_histograms(lit_len, off_len)
    cl_flat = limited_lengths(mk_lengths(hists), 7).contiguous()
    cl_m = cl_flat.view(len(MASK_ORDER), B, NCODELENSYMS)
    cost_m = rle_bits_tables(lit_len, off_len, cl_flat, MASK_ORDER).view(len(MASK_ORDER), B).T
    best = cost_m.min(dim=1)[0]
    mi = _arange(len(MASK_ORDER), lit_len.device)[None, :]
    midx = torch.where(cost_m == best[:, None], mi, -1).max(dim=1)[0]
    cl_sel = cl_m[midx.to(I64), _arange(B, lit_len.device, I64)]
    return device_tables(lit_len.device).mask_order[midx.to(I64)], cl_sel, n_lit, n_off
