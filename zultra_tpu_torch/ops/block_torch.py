"""Block planner: the complete per-block deflate decision flow for a
batch of block lanes — greedy entropy, static/dynamic choice, the 3+1
parse/entropy convergence passes on the DP and chain kernels,
match->literal post-optimization, the Zopfli RLE A/B test, the CL-mask
search, and token emission into packed words.

Port of zultra_tpu.ops.block_jax (``_plan_block_core``,
``_emit_tokens``, ``plan_blocks_device_multi``, the per-window forms
``plan_blocks_device`` and ``plan_blocks``, and their helpers; no
mesh). Reference semantics: zultra src/blockdeflate.c:827-997 and the
stream-level cost choice src/libzultra.c:317-324. Lanes are block-local
(position 0 = block start); bytes past a lane's length are the window's
next bytes and every stage masks them. A bucket of lanes is planned by
one program (``ops/programs.py``): on the card, one CUDA graph a bucket
shape, as ``jax.jit`` makes ``_plan_block_core`` one program a shape.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..constants import (
    MAX_OFFSET,
    MIN_MATCH_SIZE,
    MIN_OFFSET,
    NEODMARKERSYM,
    NLITERALSYMS,
    NOFFSETSYMS,
)

from .. import profiling
from . import plan_cuda, programs
from .chain_cuda import chain_marks
from .dp_cuda import run_dp
from .entropy_torch import (
    build_lengths,
    canonical_codewords,
    dynamic_cost,
    dynamic_cost_given,
    mask_search,
    optimize_for_rle_pair,
    static_cost,
)
from .symbol_map import (
    matchlen_sym_extra_base,
    offset_index,
    offset_sym_extra_base,
    select_by_symbol,
)
from .tables import device_tables

CONVERGENCE_PASSES = 3
TILE = 4096  # smallest lane bucket
MERGE_CAP = 1 << 15  # buckets up to this size merge into one batch
I32 = torch.int32
I64 = torch.int64


def token_starts(step: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Token-start mask of the hop chain walked from 0 (B, n) bool."""
    start = torch.zeros_like(length)
    return chain_marks(step.to(I32).contiguous(), start, length)


def token_hist(window, lens, offs, length, is_tok=None):
    """Token entropy (accumulate_token_entropy): histogram the literal/
    length and offset symbols of the chain's tokens, EOD += 1. Returns
    (lit_hist (B, 288), off_hist (B, 32), is_tok). Without ``is_tok`` the
    chain kernel marks the tokens; the histograms are the plain form on a
    CPU tensor, one launch of the ``token_hist`` kernel (``plan_cuda``)
    on a CUDA tensor."""
    if is_tok is None:
        is_tok = token_starts(torch.where(lens >= MIN_MATCH_SIZE, lens, 1), length)
    if window.device.type == "cpu":
        return (*token_hist_plain(window, lens, offs, is_tok), is_tok)
    return (*plan_cuda.launch_token_hist(window, lens, offs, is_tok), is_tok)


def token_hist_plain(window, lens, offs, is_tok):
    """The histograms of ``token_hist`` as tensor ops (the scatter form of
    block_jax._token_hist) -> (lit_hist, off_hist)."""
    B, n = window.shape
    is_match = lens >= MIN_MATCH_SIZE
    len_sym, _, _ = matchlen_sym_extra_base(torch.clamp(lens - MIN_MATCH_SIZE, 0, 255))
    off_sym, _, _ = offset_sym_extra_base(offset_index(offs))
    sym1 = torch.where(is_tok, torch.where(is_match, len_sym, window.to(I32)), NLITERALSYMS)
    sym2 = torch.where(is_match & is_tok, off_sym, NOFFSETSYMS)
    ones = torch.ones((B, n), dtype=I32, device=window.device)
    lit_hist = torch.zeros((B, NLITERALSYMS + 1), dtype=I32, device=window.device)
    lit_hist.scatter_add_(1, sym1.to(I64), ones)
    lit_hist = lit_hist[:, :NLITERALSYMS].clone()
    lit_hist[:, NEODMARKERSYM] += 1
    off_hist = torch.zeros((B, NOFFSETSYMS + 1), dtype=I32, device=window.device)
    off_hist.scatter_add_(1, sym2.to(I64), ones)
    return lit_hist, off_hist[:, :NOFFSETSYMS].contiguous()


def offset_workaround(off_hist: torch.Tensor) -> torch.Tensor:
    """Always emit >= 2 offset codewords (zlib < 1.2.1.1 inflate bug,
    reference src/blockdeflate.c:893-913)."""
    n = torch.clamp((off_hist[:, : NOFFSETSYMS - 2] > 0).sum(dim=1, dtype=I32), max=2)
    e0, e1 = off_hist[:, 0], off_hist[:, 1]
    out = off_hist.clone()
    out[:, 0] = torch.where((n == 0) | ((n == 1) & (e0 == 0)), 1, e0)
    out[:, 1] = torch.where((n == 0) | ((n == 1) & (e0 > 0)), 1, e1)
    return out


def _match_bits(lens, offs, lit_len, off_len):
    """(len symbol, len extra, len base, off symbol, off extra, off base)
    and the code lengths of both symbols, for every position."""
    e = torch.clamp(lens - MIN_MATCH_SIZE, 0, 255)
    ls, le, lb = matchlen_sym_extra_base(e)
    osym, oe, ob = offset_sym_extra_base(offset_index(offs))
    ls_len = select_by_symbol(lit_len, ls, 257, 286, 0)
    os_len = select_by_symbol(off_len, osym, 0, 30, 0)
    return e, ls, le, lb, osym, oe, ob, ls_len, os_len


def post_optimize(best_len, best_off, window, lit_len, off_len, is_tok):
    """Match->literal demotion (post_optimize, parse.py:175-216): a
    chosen match demotes iff its span's literal cost sum is below the
    match cost and the span holds no zero-length literal. Returns
    (demoted best_len, covered mask)."""
    B, n = window.shape
    dev = window.device
    pos = torch.arange(n, dtype=I32, device=dev)[None, :]
    is_match = best_len >= MIN_MATCH_SIZE
    tok_match = is_tok & is_match & (best_off >= MIN_OFFSET) & (best_off <= MAX_OFFSET)
    lit_costs = torch.gather(lit_len, 1, window.to(I64))
    zero = torch.zeros((B, 1), dtype=I32, device=dev)
    P = torch.cat([zero, torch.cumsum(lit_costs, dim=1, dtype=I32)], dim=1)
    Z = torch.cat([zero, torch.cumsum((lit_costs == 0).to(I32), dim=1, dtype=I32)], dim=1)
    _, _, le, _, _, oe, _, ls_len, os_len = _match_bits(best_len, best_off, lit_len, off_len)
    match_cost = ls_len + le + os_len + oe
    span_end = torch.clamp(pos + best_len, max=n).to(I64)
    pos64 = pos.to(I64).expand(B, n)
    span_cost = torch.gather(P, 1, span_end) - torch.gather(P, 1, pos64)
    span_zero = torch.gather(Z, 1, span_end) - torch.gather(Z, 1, pos64)
    demote = tok_match & (span_cost < match_cost) & (span_zero == 0)
    dem_end = torch.cummax(torch.where(demote, span_end.to(I32), 0), dim=1)[0]
    covered = pos < dem_end
    return torch.where(covered, 0, best_len), covered


def emit_tokens(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok):
    """Token emission at bit phase 0: every token's codeword (+ extra
    bits) packed LSB-first into 32-bit words, EOD last. Returns (words
    (B, n_words) int64 holding uint32 values, total_bits (B,) int32). A
    CPU tensor takes the plain form; a CUDA tensor one launch of the
    ``emit_tokens`` kernel (``plan_cuda``). Every codeword must lie below
    2^its length, as ``canonical_codewords`` and the static tables give
    them: the kernel ORs each field into its words where the plain form
    adds, and the two agree only on fields that fit their bits."""
    args = (window, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok)
    if window.device.type == "cpu":
        return emit_tokens_plain(*args)
    return plan_cuda.launch_emit_tokens(*args)


def emit_tokens_plain(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok):
    """``emit_tokens`` as tensor ops (block_jax._emit_tokens): an int64
    cumsum of the field widths and two scatter_adds of the pieces."""
    B, n = window.shape
    dev = window.device
    is_match = is_tok & (best_len >= MIN_MATCH_SIZE)
    e, ls, le, lb, osym, oe, ob, ls_len, os_len = _match_bits(best_len, best_off, lit_len, off_len)
    byte = window.to(I64)
    lit_v = torch.gather(lit_cw, 1, byte)
    lit_n = torch.gather(lit_len, 1, byte)
    m1_v = select_by_symbol(lit_cw, ls, 257, 286, 0).to(I64) | ((e - lb).to(I64) << ls_len)
    m1_n = ls_len + le
    m2_v = select_by_symbol(off_cw, osym, 0, 30, 0).to(I64) | ((best_off - ob).to(I64) << os_len)
    m2_n = os_len + oe

    lane1_v = torch.where(is_match, m1_v, torch.where(is_tok, lit_v.to(I64), 0))
    lane1_n = torch.where(is_match, m1_n, torch.where(is_tok, lit_n, 0))
    lane2_v = torch.where(is_match, m2_v, 0)
    lane2_n = torch.where(is_match, m2_n, 0)
    vals = torch.cat([torch.stack([lane1_v, lane2_v], dim=2).reshape(B, -1),
                      lit_cw[:, NEODMARKERSYM : NEODMARKERSYM + 1].to(I64)], dim=1)
    nbits = torch.cat([torch.stack([lane1_n, lane2_n], dim=2).reshape(B, -1),
                       lit_len[:, NEODMARKERSYM : NEODMARKERSYM + 1]], dim=1).to(I64)
    offs_bits = torch.cumsum(nbits, dim=1) - nbits
    total_bits = (offs_bits[:, -1] + nbits[:, -1]).to(I32)

    # Fields never overlap, so adding the shifted pieces equals OR-ing
    # them; each field spans at most two words.
    num_words = (16 * n + 64) // 32 + 2
    w = offs_bits >> 5
    sh = offs_bits & 31
    live = nbits > 0
    lo = torch.where(live, (vals << sh) & 0xFFFFFFFF, 0)
    hi = torch.where(live & (sh > 0), vals >> (32 - sh), 0)
    words = torch.zeros((B, num_words + 1), dtype=I64, device=dev)
    words.scatter_add_(1, torch.clamp(w, max=num_words), lo)
    words.scatter_add_(1, torch.clamp(w + 1, max=num_words), hi)
    return words[:, :num_words], total_bits


def plan_block_core(window, mlens, moffs, length, greedy_tok=None):
    """The per-block planning program for B lanes: window (B, n) uint8,
    mlens/moffs (B, n, 8) int32, length (B,) int32, greedy_tok (B, n)
    bool or None (the splitter's greedy token marks sliced per block).
    Returns a dict of plan fields and the emitted words."""
    B, n = window.shape
    dev = window.device
    t = device_tables(dev)
    s_lit_len, s_lit_cw = t.static_lit_len[None, :], t.static_lit_cw[None, :]
    s_off_len, s_off_cw = t.static_off_len[None, :], t.static_off_cw[None, :]
    idx = torch.arange(n, dtype=I32, device=dev)[None, :]

    # Greedy entropy over match-table row 0 -> static/dynamic choice.
    if greedy_tok is not None:
        greedy_tok = greedy_tok & (idx < length[:, None])
    g_lit, g_off, _ = token_hist(window, mlens[:, :, 0], moffs[:, :, 0], length, greedy_tok)
    is_dyn = (static_cost(g_lit, g_off) > dynamic_cost(g_lit, g_off))[:, None]
    lit_len = build_lengths(g_lit, 15)
    off_len = build_lengths(g_off, 15)

    # 3+1 convergence passes.
    for p in range(CONVERGENCE_PASSES + 1):
        ll = torch.where(is_dyn, lit_len, s_lit_len)
        ol = torch.where(is_dyn, off_len, s_off_len)
        # Unused codewords get a default cost so the optimizer may adopt
        # them (static tables have no zeros, so this is dynamic-only).
        ll = torch.where(ll == 0, 9, ll)
        ol = torch.where(ol == 0, 6, ol)
        best_len, best_off = run_dp(ll, ol, window, mlens, moffs, length)
        f_lit, f_off, is_tok = token_hist(window, best_len, best_off, length)
        if p == CONVERGENCE_PASSES:
            f_off = offset_workaround(f_off)
        lit_len = build_lengths(f_lit, 15)
        off_len = build_lengths(f_off, 15)

    # Match->literal demotion under the final lengths (dynamic only);
    # demoted spans re-enter the chain as literal runs.
    demoted, covered = post_optimize(best_len, best_off, window, lit_len, off_len, is_tok)
    best_len = torch.where(is_dyn, demoted, best_len)
    emit_tok = torch.where(is_dyn, is_tok | covered, is_tok)

    # Zopfli RLE histogram A/B test.
    cur_cost = dynamic_cost_given(f_lit, f_off, lit_len, off_len)
    o_lit, o_off = optimize_for_rle_pair(f_lit, f_off)
    o_lit_len = build_lengths(o_lit, 15)
    o_off_len = build_lengths(o_off, 15)
    adopt = (dynamic_cost_given(o_lit, o_off, o_lit_len, o_off_len) < cur_cost)[:, None]
    lit_len = torch.where(adopt, o_lit_len, lit_len)
    off_len = torch.where(adopt, o_off_len, off_len)

    best_mask, cl_len, n_lit, n_off = mask_search(lit_len, off_len)

    lit_cw = torch.where(is_dyn, canonical_codewords(lit_len), s_lit_cw)
    off_cw = torch.where(is_dyn, canonical_codewords(off_len), s_off_cw)
    lit_len_f = torch.where(is_dyn, lit_len, s_lit_len)
    off_len_f = torch.where(is_dyn, off_len, s_off_len)
    words, total_bits = emit_tokens(window, best_len, best_off, lit_cw, lit_len_f,
                                    off_cw, off_len_f, emit_tok)
    return {
        "is_dynamic": is_dyn[:, 0],
        "lit_len": lit_len,
        "off_len": off_len,
        "best_mask": best_mask,
        "cl_len": cl_len,
        "n_lit": n_lit,
        "n_off": n_off,
        "words": words,
        "total_bits": total_bits,
    }


def on_device(device: torch.device):
    """A block with ``device`` current if it is a CUDA device, so that the
    kernels launch on that card's stream from whichever thread calls."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``. To a CUDA device it goes by one pinned,
    non-blocking copy: a pageable one makes the host wait until the
    stream has drained."""
    dev = torch.device(device)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if profiling.enabled():
        profiling.count("h2d.bytes", t.nbytes)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def to_host(*tensors: torch.Tensor) -> list:
    """Tensors as numpy arrays: non-blocking copies of all of them, then
    one wait on the current stream, where one ``.cpu()`` each would wait
    once each."""
    with profiling.span("zultra.wait"):
        host = [t.to("cpu", non_blocking=True) for t in tensors]
        on_card = [t.device for t in tensors if t.is_cuda]
        if on_card:
            torch.cuda.current_stream(on_card[0]).synchronize()
    if profiling.enabled():
        profiling.count("d2h.bytes", sum(t.nbytes for t in tensors))
    return [h.numpy() for h in host]


def lane_bucket(n: int) -> int:
    size = TILE
    while size < n:
        size *= 2
    return size


def merge_small_buckets(buckets: dict) -> None:
    """Plan every bucket up to MERGE_CAP in one batch at the largest of
    their sizes (a lane's plan does not depend on its padding)."""
    small = [k for k in buckets if k <= MERGE_CAP]
    if len(small) > 1:
        tgt = max(small)
        merged = []
        for k in sorted(small):
            merged.extend(buckets.pop(k))
        buckets[tgt] = sorted(merged)


def collect_plans(out: dict, idxs, plans) -> None:
    """One device->host copy per bucket (``to_host``), split into
    per-block plan dicts with the JAX package's numpy dtypes."""
    host = dict(zip(out, to_host(*out.values())))
    total_bits = host["total_bits"]
    for b, i in enumerate(idxs):
        n_words = (int(total_bits[b]) + 31) // 32
        plans[i] = {
            "is_dynamic": bool(host["is_dynamic"][b]),
            "lit_len": host["lit_len"][b],
            "off_len": host["off_len"][b],
            "best_mask": int(host["best_mask"][b]),
            "cl_len": host["cl_len"][b],
            "n_lit": int(host["n_lit"][b]),
            "n_off": int(host["n_off"][b]),
            "total_bits": int(total_bits[b]),
            "words": host["words"][b, :n_words].astype(np.uint32),
        }


def padded_lanes(n: int) -> int:
    """The lane count a bucket of ``n`` lanes is planned at: the next power
    of two, as block_jax pads it (:731-733), so that a few program shapes
    serve every batch. A padded lane has length 0 and its plan is dropped."""
    return 1 << max(n - 1, 0).bit_length()


def plan_buckets(lanes) -> list:
    """The planner's batches for ``lanes`` [(window, start, length), ...]:
    [(n_pad, lane indices)] by ascending n_pad, every bucket up to
    MERGE_CAP merged into one."""
    buckets: dict[int, list[int]] = {}
    for i, (_, _, ln) in enumerate(lanes):
        buckets.setdefault(lane_bucket(ln), []).append(i)
    merge_small_buckets(buckets)
    return sorted(buckets.items())


def slice_bucket(win_stack, lens_stack, offs_stack, meta, tok_stack, n_pad: int):
    """One bucket's lanes cut out of the window stacks, ``n_pad`` positions
    each (block_jax's ``_slice_blocks_multi``, :646, kept apart from the
    planner's program as there). ``meta`` (3, B) int64 holds each lane's
    window index, start and length. A lane's columns past the stacks'
    width read zeros, as block_jax's extended stacks give them. Returns
    (win, mlens, moffs, length, greedy marks or None)."""
    n_lane = win_stack.shape[1]
    widx, starts, length = meta[0], meta[1], meta[2].to(I32)
    cols = starts[:, None] + torch.arange(n_pad, dtype=I64, device=win_stack.device)[None, :]
    inside = cols < n_lane
    cols = torch.clamp(cols, max=n_lane - 1)
    rows = widx[:, None]
    win = torch.where(inside, win_stack[rows, cols], 0)
    mlens = torch.where(inside[:, :, None], lens_stack[rows, cols], 0)
    moffs = torch.where(inside[:, :, None], offs_stack[rows, cols], 0)
    gtok = None if tok_stack is None else tok_stack[rows, cols] & inside
    return win, mlens, moffs, length, gtok


def plan_blocks_device_multi(win_stack, lens_stack, offs_stack, lanes, tok_stack=None):
    """Plans for blocks drawn from a batch of window lanes: win_stack
    (W, n_lane) uint8, lens/offs_stack (W, n_lane, 8) int32, lanes a
    list of (window_index, start_in_lane, length), tok_stack (W, n_lane)
    bool or None. Blocks bucket by padded size across windows; each
    bucket, padded to a power of two lanes, is cut out of the stacks
    (``slice_bucket``) and planned by the ``plan_block_core`` program (a
    graph replay on the card, keyed on the bucket's shape alone). Returns
    plans in ``lanes`` order."""
    plans: list = [None] * len(lanes)
    with profiling.span("zultra.plan"):
        for n_pad, idxs in plan_buckets(lanes):
            with profiling.span("zultra.plan.slice"):
                meta = np.zeros((3, padded_lanes(len(idxs))), np.int64)  # padded: window 0, start 0
                meta[:, : len(idxs)] = np.array([lanes[i] for i in idxs], np.int64).T
                bucket = slice_bucket(win_stack, lens_stack, offs_stack,
                                      to_device(meta, win_stack.device), tok_stack, n_pad)
            with profiling.span("zultra.plan.program"):
                out = programs.run(plan_block_core, *bucket)
            with profiling.span("zultra.plan.collect"):
                collect_plans(out, idxs, plans)
            if profiling.enabled():
                profiling.count("plan.buckets")
                profiling.count("plan.positions", meta.shape[1] * n_pad)
                profiling.count("plan.input", sum(lanes[i][2] for i in idxs))
                count_long_lanes([lanes[i][2] for i in idxs])
    return plans


# Lanes past this (1 MiB, the default largest block) come only from block
# sizes above the default; the tracer counts them.
LONG_LANE = 1 << 20


def count_long_lanes(lengths) -> None:
    """The tracer's ``dp.long_lanes`` and ``dp.long_positions`` of one
    bucket: its lanes longer than LONG_LANE, and their positions."""
    long = [n for n in lengths if n > LONG_LANE]
    profiling.count("dp.long_lanes", len(long))
    profiling.count("dp.long_positions", sum(long))


def plan_blocks_device(win, lens, offs, block_spans) -> list:
    """Plans for the blocks ``block_spans`` [(s, e), ...] of one window
    whose bytes ``win`` (n,) uint8 and tables ``lens``/``offs`` (n, 8)
    lie on the device (block_jax.plan_blocks_device, :610): its blocks
    as the lanes of a one-window ``plan_blocks_device_multi``."""
    lanes = [(0, s, e - s) for s, e in block_spans]
    return plan_blocks_device_multi(win[None], lens.to(I32)[None], offs.to(I32)[None], lanes)


def plan_blocks(window, match_table, block_spans, device="cuda") -> list:
    """Plans for the blocks of one window from its host bytes and host
    match table (n, 8, 2) (block_jax.plan_blocks, :754): both go to
    ``device`` once, then ``plan_blocks_device``."""
    dev = torch.device(device)
    mt = np.asarray(match_table, dtype=np.int32)
    n = min(len(window), mt.shape[0])
    win = torch.from_numpy(np.array(window[:n], dtype=np.uint8)).to(dev)
    lens = torch.from_numpy(np.ascontiguousarray(mt[:n, :, 0])).to(dev)
    offs = torch.from_numpy(np.ascontiguousarray(mt[:n, :, 1])).to(dev)
    return plan_blocks_device(win, lens, offs, block_spans)
