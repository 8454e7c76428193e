"""The block planner's fused per-position passes (kernels ``csrc/plan.cu``)
and plain models of the kernels' schedules.

Four kernels, each the card's form of a function whose plain PyTorch
version stays in its own module (a CPU tensor takes that form; a CUDA
tensor reaches the launches here or raises):

- K11 ``prep_lanes`` (``dp_cuda.prep_lanes``; JAX
  ``dp_pallas._prep_lane``): the DP's packed statics lit, p1, p2 and
  varlen40. One launch: a block per (lane, TILE positions), a thread per
  (position, slot) element.
- K12 ``token_hist`` (``block_torch.token_hist`` given the token marks;
  JAX ``block_jax._token_hist``): the literal/length and offset symbol
  histograms of a lane's tokens, EOD += 1. One launch: a block per (lane,
  HIST_TILE positions); a lane loads the marks and bytes of a run of RUN
  positions in one wide load each, a warp walks its 32 runs' positions 32
  neighbours at a time, each token adds one to shared bins, and the block
  adds its nonzero bins into the lane's rows with integer atomics.
- K13 ``emit_tokens`` (``block_torch.emit_tokens``; JAX
  ``block_jax._emit_tokens``): every token's codeword and extra bits
  packed LSB-first into words, EOD last. One launch: a block takes the
  tile of EMIT_TILE positions its atomic ticket names, computes each
  field once (EMIT_PER positions a thread), scans its threads' bits,
  publishes the tile's bit count and finds its first bit in the lane by a
  decoupled look-back over the lane's tiles, builds its words in shared
  memory and stores them whole; the first and last word of a tile, which
  a neighbour may share, are OR'ed. Words, status words and ticket are
  one buffer, which the C entry zeroes by one memset a call.
- K14 ``lex_order`` (``entropy_torch._lex_order``; the ``lax.sort((key,
  iota), num_keys=2)`` of ``entropy_jax``): the indices that sort each
  row by (key, index). S <= 32: a warp a row ranks by count (key i goes
  to #{j: k_j < k_i} + #{j < i: k_j == k_i}). Above: a bitonic network on
  the unique words (key ^ 2^31) << 32 | index, padded with ~0 to a power
  of two P, every comparator ascending, in the layout that the C entry
  picks by P and B (``lex_order_layout``: E words a thread, rows a
  block).

Every launch runs on the current stream, allocates nothing and waits on
nothing, so the planner's CUDA graph (``ops/programs.py``) records it;
outputs and scratch come from torch. Each wrapper adds one to its
kernel's launch count a call.

The models (``*_model``) run each schedule in numpy on CPU tensors, with
the kernels' closed-form symbol maps (floor(log2(x)) by the bit search
that ``31 - __clz(x)`` computes), and return counters of what the
schedule met; ``tests/test_torch_planner_fusions.py`` holds them against
the plain forms and the JAX functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import count_launch

THREADS = 256  # threads a block (csrc/plan.cu)
TILE = 4096  # positions a block of prep_lanes
EMIT_PER = 8  # positions an emit_tokens thread
EMIT_TILE = THREADS * EMIT_PER  # positions an emit_tokens block
FIELD_BITS = 48  # a position's two fields at most (codes of <= 15 bits)
SLOTS = 8  # match slots a position
NLIT, NOFF, EOD = 288, 32, 256
MIN_MATCH, LEAVE_ALONE = 3, 40
N_SHORT = LEAVE_ALONE - MIN_MATCH
INF16 = 0x7FFF
BIG = 1 << 30
MAX_SORT = 1024  # keys a lex_order row
# Rows at which lex_order's network at P = 512 (rows of 288 keys) takes
# its throughput layout (csrc/plan.cu's LEX_THROUGHPUT_ROWS).
LEX_THROUGHPUT_ROWS = 1024
RUN = 8  # positions of a token_hist lane's wide loads
WARP_SPAN = 32 * RUN  # positions a token_hist warp takes
HIST_TILE = 1024  # positions a token_hist block: 4 warps (csrc/plan.cu)
MAX_LANES = 65535  # lanes a launch of the per-position kernels (the grid's y)
I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8


def _lanes(name: str, B: int, n: int) -> None:
    if B > MAX_LANES or n < 1:
        raise ValueError(f"{name}: {B} lanes of {n} positions; the kernel takes up to "
                         f"{MAX_LANES} lanes of at least one position")


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------


def launch_prep_lanes(ll, ol, window, mlens, moffs, length):
    """K11 on CUDA tensors: (lit (B, n), p1, p2 (B, n, 8), varlen40 (B,
    40)), all int32."""
    _build.check_cuda("prep_lanes ll", ll, I32, 2)
    _build.check_cuda("prep_lanes ol", ol, I32, 2)
    _build.check_cuda("prep_lanes window", window, U8, 2)
    _build.check_cuda("prep_lanes mlens", mlens, I32, 3)
    _build.check_cuda("prep_lanes moffs", moffs, I32, 3)
    _build.check_cuda("prep_lanes length", length, I32, 1)
    B, n = window.shape
    if (ll.shape != (B, NLIT) or ol.shape != (B, NOFF) or mlens.shape != (B, n, SLOTS)
            or moffs.shape != mlens.shape or length.shape != (B,)):
        raise ValueError("prep_lanes: inconsistent input shapes")
    _lanes("prep_lanes", B, n)
    dev = window.device
    lit = torch.empty((B, n), dtype=I32, device=dev)
    p1 = torch.empty((B, n, SLOTS), dtype=I32, device=dev)
    p2 = torch.empty((B, n, SLOTS), dtype=I32, device=dev)
    varlen40 = torch.empty((B, 40), dtype=I32, device=dev)
    _build.launch("zt_prep_lanes", ll.data_ptr(), ol.data_ptr(), window.data_ptr(),
                  mlens.data_ptr(), moffs.data_ptr(), length.data_ptr(), lit.data_ptr(),
                  p1.data_ptr(), p2.data_ptr(), varlen40.data_ptr(), B, n)
    count_launch("prep_lanes")
    return lit, p1, p2, varlen40


def _strided_i32(name, t, B, n):
    """A (B, n) int32 CUDA view of any strides (the planner passes the
    match tables' first slot, a view of stride 8)."""
    if not t.is_cuda or t.dtype != I32 or t.shape != (B, n):
        raise ValueError(f"{name}: expected a CUDA int32 tensor of shape {(B, n)}, got "
                         f"{t.device} {t.dtype} {tuple(t.shape)}")


def launch_token_hist(window, lens, offs, is_tok):
    """K12 on CUDA tensors: (lit_hist (B, 288), off_hist (B, 32)) int32.
    ``lens`` and ``offs`` may be strided views."""
    _build.check_cuda("token_hist window", window, U8, 2)
    _build.check_cuda("token_hist is_tok", is_tok, torch.bool, 2)
    B, n = window.shape
    _strided_i32("token_hist lens", lens, B, n)
    _strided_i32("token_hist offs", offs, B, n)
    if is_tok.shape != (B, n):
        raise ValueError("token_hist: inconsistent input shapes")
    _lanes("token_hist", B, n)
    lit_hist = torch.zeros((B, NLIT), dtype=I32, device=window.device)
    off_hist = torch.zeros((B, NOFF), dtype=I32, device=window.device)
    _build.launch("zt_token_hist", window.data_ptr(), lens.data_ptr(), offs.data_ptr(),
                  is_tok.data_ptr(), lit_hist.data_ptr(), off_hist.data_ptr(), B, n,
                  lens.stride(0), lens.stride(1), offs.stride(0), offs.stride(1))
    count_launch("token_hist")
    return lit_hist, off_hist


def num_words(n: int) -> int:
    """Words a lane of n positions is emitted into (block_jax._emit_tokens)."""
    return (16 * n + 64) // 32 + 2


def launch_emit_tokens(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok):
    """K13 on CUDA tensors: (words (B, num_words(n)) int64 holding uint32
    values, total_bits (B,) int32). The words, the tiles' status words
    and the ticket are one buffer, which the C entry zeroes: one memset
    and one launch. The fields are OR'ed into the words, so each codeword
    must lie below 2^its length (``block_torch.emit_tokens``)."""
    _build.check_cuda("emit_tokens window", window, U8, 2)
    _build.check_cuda("emit_tokens is_tok", is_tok, torch.bool, 2)
    B, n = window.shape
    for name, t in (("best_len", best_len), ("best_off", best_off)):
        _build.check_cuda(f"emit_tokens {name}", t, I32, 2)
    for name, t, S in (("lit_cw", lit_cw, NLIT), ("lit_len", lit_len, NLIT),
                       ("off_cw", off_cw, NOFF), ("off_len", off_len, NOFF)):
        _build.check_cuda(f"emit_tokens {name}", t, I32, 2)
        if t.shape != (B, S):
            raise ValueError(f"emit_tokens: {name} has shape {tuple(t.shape)}, not {(B, S)}")
    if best_len.shape != (B, n) or best_off.shape != (B, n) or is_tok.shape != (B, n):
        raise ValueError("emit_tokens: inconsistent input shapes")
    _lanes("emit_tokens", B, n)
    nw = num_words(n)
    scratch = torch.empty(B * nw + B * -(-n // EMIT_TILE) + 1, dtype=I64, device=window.device)
    total_bits = torch.empty((B,), dtype=I32, device=window.device)
    _build.launch("zt_emit_tokens", window.data_ptr(), best_len.data_ptr(), best_off.data_ptr(),
                  is_tok.data_ptr(), lit_cw.data_ptr(), lit_len.data_ptr(), off_cw.data_ptr(),
                  off_len.data_ptr(), scratch.data_ptr(), total_bits.data_ptr(), B, n, nw)
    words = scratch[: B * nw].view(B, nw)
    count_launch("emit_tokens")
    return words, total_bits


def lex_order_layout(B: int, S: int):
    """K14's network layout for B rows of S keys, as ``zt_lex_order``
    picks it: (P, E, rows), the row padded to P words, E words a thread
    (P / E threads a row), rows a block; None for S <= 32 (the warp
    kernel). The latency layout (E = 2, or 4 at P = 1024; a row a block)
    at every width; at P = 512 from ``LEX_THROUGHPUT_ROWS`` rows the
    throughput layout (E = 16, 8 rows a block)."""
    if S <= 32:
        return None
    P = max(64, 1 << (S - 1).bit_length())
    if P == 512 and B >= LEX_THROUGHPUT_ROWS:
        return P, 16, 8
    return P, max(2, P // 256), 1


def launch_lex_order(key):
    """K14 on a CUDA tensor: key (B, S) int32, 1 <= S <= 1024 -> (B, S)
    int64, the indices sorting each row by (key, index)."""
    _build.check_cuda("lex_order key", key, I32, 2)
    B, S = key.shape
    if not 1 <= S <= MAX_SORT:
        raise ValueError(f"lex_order: rows of {S} keys, the kernel takes 1..{MAX_SORT}")
    out = torch.empty((B, S), dtype=I64, device=key.device)
    _build.launch("zt_lex_order", key.data_ptr(), out.data_ptr(), B, S)
    count_launch("lex_order")
    return out


def hammer_lanes(n: int, dev):
    """Two lanes of n positions that hammer one bin of the token
    histograms (the card tests' and ``chip_smoke.py``'s): a zero run
    (matches of 258 at offset 1 to the end: length symbol 285, offset
    symbol 0) and one literal byte (no match). Window (2, n) uint8, match
    tables (2, n, 8) int32, lengths (2,) int32."""
    window = torch.zeros((2, n), dtype=U8, device=dev)
    window[1] = 0x61
    mlens = torch.zeros((2, n, SLOTS), dtype=I32, device=dev)
    left = n - torch.arange(n, device=dev, dtype=I32)
    mlens[0, :, 0] = torch.where(left >= MIN_MATCH, torch.clamp(left, max=258), 0)
    moffs = torch.where(mlens >= MIN_MATCH, 1, 0).to(I32)
    return window, mlens, moffs, torch.full((2,), n, dtype=I32, device=dev)


# ---------------------------------------------------------------------------
# The kernels' arithmetic in numpy
# ---------------------------------------------------------------------------


def floor_log2(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) for int x >= 1 by a binary search over the bits,
    which is what 31 - clz(x) computes."""
    x = np.asarray(x, np.int64).copy()
    r = np.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hit = x >= (1 << s)
        r += np.where(hit, s, 0)
        x = np.where(hit, x >> s, x)
    return r


def len_symbol(e: np.ndarray):
    """(symbol, extra bits, base) of encoded lengths e in 0..255."""
    e = np.asarray(e, np.int64)
    k = np.maximum(floor_log2(np.maximum(e, 1)), 2)
    q = e >> (k - 2)
    sym = np.where(e < 8, 257 + e, np.where(e == 255, 285, 249 + 4 * k + q))
    extra = np.where((e < 8) | (e == 255), 0, k - 2)
    base = np.where(e < 8, e, np.where(e == 255, 255, q << (k - 2)))
    return sym, extra, base


def offset_index(off: np.ndarray) -> np.ndarray:
    raw = np.maximum(np.asarray(off, np.int64) - 1, 0)
    return np.clip(np.where(raw < 256, raw, 256 + ((raw - 256) >> 7)), 0, 511)


def off_symbol(oidx: np.ndarray):
    """(symbol, extra bits, base) of offset indices 0..511."""
    oidx = np.asarray(oidx, np.int64)
    j = np.where(oidx < 256, oidx, ((oidx - 256) << 7) + 256)
    k = np.maximum(floor_log2(np.maximum(j, 1)), 1)
    bit = (j >> (k - 1)) & 1
    low = j < 4
    return (np.where(low, j, 2 * k + bit), np.where(low, 0, k - 1),
            np.where(low, j + 1, ((2 + bit) << (k - 1)) + 1))


def _pick(table: np.ndarray, sym: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """table[b, sym[b, ...]] for sym in [lo, hi), else 0."""
    inside = (sym >= lo) & (sym < hi)
    idx = np.where(inside, sym, lo).reshape(sym.shape[0], -1)
    got = np.take_along_axis(table.astype(np.int64), idx, axis=1).reshape(sym.shape)
    return np.where(inside, got, 0)


def _i32(x: np.ndarray) -> np.ndarray:
    """int64 values wrapped to int32, as the kernels' int arithmetic wraps."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _np(*tensors):
    return [t.cpu().numpy() for t in tensors]


# ---------------------------------------------------------------------------
# Models of the schedules
# ---------------------------------------------------------------------------


def prep_lanes_model(ll, ol, window, mlens, moffs, length, tile=TILE):
    """K11's schedule: for each (lane, tile of ``tile`` positions), every
    (position, slot) element from the lane's tables -> (lit, p1, p2,
    varlen40) int32 tensors and {"tiles": blocks run}."""
    ll, ol, window, mlens, moffs, length = _np(ll, ol, window, mlens, moffs, length)
    B, n = window.shape
    lit = np.zeros((B, n), np.int64)
    p1 = np.zeros((B, n, SLOTS), np.int64)
    p2 = np.zeros((B, n, SLOTS), np.int64)
    tiles = 0
    for b in range(B):
        for p0 in range(0, n, tile):
            tiles += 1
            pos = np.arange(p0, min(p0 + tile, n))
            ln = int(length[b])
            lit[b, pos] = np.where(pos < ln, ll[b][window[b, pos]], 0)
            ml = mlens[b, pos].astype(np.int64)
            clamped = np.minimum(ml, np.maximum(ln - pos, 0)[:, None])
            osym, oextra, _ = off_symbol(offset_index(moffs[b, pos]))
            osize = _pick(ol[b : b + 1], osym[None], 0, 30)[0] + oextra
            valid = ml >= MIN_MATCH
            is_long = valid & (ml >= LEAVE_ALONE)
            is_short = valid & (ml < LEAVE_ALONE)
            p1[b, pos] = (np.where(is_short, clamped, 0) << 16) | np.where(is_short, osize, INF16)
            e = clamped - MIN_MATCH
            e = np.where((e < 0) | (e > 255), 255, e)
            lsym, lextra, _ = len_symbol(e)
            varlen_e = _pick(ll[b : b + 1], lsym[None], 257, 286)[0] + lextra
            p2[b, pos] = ((np.where(is_long, clamped, 0) << 16)
                          | np.where(is_long, varlen_e + osize, INF16))
    sym, extra, _ = len_symbol(np.arange(N_SHORT))
    varlen40 = np.concatenate([ll[:, sym] + extra[None, :], np.full((B, 3), BIG)], axis=1)
    out = [torch.from_numpy(_i32(a)) for a in (lit, p1, p2, varlen40)]
    return (*out, {"tiles": tiles})


def _token_symbols(window, lens, offs):
    """Each position's (literal/length symbol, offset symbol or -1)."""
    is_match = lens >= MIN_MATCH
    lsym, _, _ = len_symbol(np.clip(lens.astype(np.int64) - MIN_MATCH, 0, 255))
    osym, _, _ = off_symbol(offset_index(offs))
    return (np.where(is_match, lsym, window.astype(np.int64)), np.where(is_match, osym, -1))


def token_hist_model(window, lens, offs, is_tok, tile=HIST_TILE, order_seed=0):
    """K12's schedule: a block per (lane, ``tile`` positions), warps of
    WARP_SPAN positions in runs of RUN a lane, step e of a warp taking
    positions 32 e + lane into the block's bins; the blocks' bins added
    into the lane's rows in a seeded random order (the atomics' order is
    the card's to choose), EOD from each lane's first block -> (lit_hist,
    off_hist, counters: tile, blocks, runs (of RUN positions inside the
    lane), runs_skipped (no mark), warps_skipped (no mark in any of its
    runs), shared_adds (one a token and one a match's offset)). The kernel
    takes HIST_TILE; another tile (the model's alone) shows the sums exact
    under any split, and one below 256 ends in a partial warp."""
    window, lens, offs, is_tok = _np(window, lens, offs, is_tok)
    B, n = window.shape
    lit = np.zeros((B, NLIT), np.int64)
    off = np.zeros((B, NOFF), np.int64)
    stats = dict(tile=tile, blocks=0, runs=0, runs_skipped=0, warps_skipped=0, shared_adds=0)
    blocks = [(b, p0) for b in range(B) for p0 in range(0, n, tile)]
    np.random.default_rng(order_seed).shuffle(blocks)
    for b, p0 in blocks:
        end = min(p0 + tile, n)
        n_warps = -(-(end - p0) // WARP_SPAN)
        w0 = p0 + WARP_SPAN * np.arange(n_warps)[:, None, None]
        # runs: [warp, lane, i] -> position w0 + RUN lane + i
        run_pos = w0 + RUN * np.arange(32)[None, :, None] + np.arange(RUN)[None, None, :]
        run_in = run_pos < end
        run_tok = run_in & is_tok[b, np.minimum(run_pos, n - 1)]
        live = run_in.any(axis=2)
        marked = run_tok.any(axis=2)
        stats["blocks"] += 1
        stats["runs"] += int(live.sum())
        stats["runs_skipped"] += int((live & ~marked).sum())
        stats["warps_skipped"] += int((~marked.any(axis=1)).sum())
        # steps: [warp, e, lane] -> position w0 + 32 e + lane
        pos = w0 + 32 * np.arange(RUN)[None, :, None] + np.arange(32)[None, None, :]
        inside = pos < end
        at = np.minimum(pos, n - 1)
        tok = inside & is_tok[b, at]
        s1, s2 = _token_symbols(window[b, at], lens[b, at], offs[b, at])
        h_lit = np.bincount(s1[tok], minlength=NLIT)
        h_off = np.bincount(s2[tok & (s2 >= 0)], minlength=NOFF)
        stats["shared_adds"] += int(tok.sum()) + int((tok & (s2 >= 0)).sum())
        if p0 == 0:
            h_lit[EOD] += 1
        lit[b] += h_lit
        off[b] += h_off
    return torch.from_numpy(_i32(lit)), torch.from_numpy(_i32(off)), stats


def emit_fields(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok):
    """Numpy (B, n) arrays of each position's two fields: (v1, n1, v2,
    n2), int64, as csrc/plan.cu's ``position_fields``."""
    is_match = is_tok & (best_len >= MIN_MATCH)
    e = np.clip(best_len.astype(np.int64) - MIN_MATCH, 0, 255)
    ls, le, lb = len_symbol(e)
    os_, oe, ob = off_symbol(offset_index(best_off))
    ls_len = _pick(lit_len, ls, 257, 286)
    os_len = _pick(off_len, os_, 0, 30)
    byte = window.astype(np.int64)
    m1_v = _pick(lit_cw, ls, 257, 286) | ((e - lb) << ls_len)
    m2_v = _pick(off_cw, os_, 0, 30) | ((best_off.astype(np.int64) - ob) << os_len)
    lit_v = np.take_along_axis(lit_cw.astype(np.int64), byte, axis=1)
    lit_n = np.take_along_axis(lit_len.astype(np.int64), byte, axis=1)
    v1 = np.where(is_match, m1_v, np.where(is_tok, lit_v, 0))
    n1 = np.where(is_match, ls_len + le, np.where(is_tok, lit_n, 0))
    return v1, n1, np.where(is_match, m2_v, 0), np.where(is_match, os_len + oe, 0)


EMIT_COUNTERS = ("tiles", "lookback_rounds", "lookback_waits", "statuses_read",
                 "unaligned_tiles", "shared_words", "thread_shared_words", "straddle_word")


def _tile_words(vals, nbits, per_thread, n_words, stats):
    """One tile's build in shared memory: each thread's first bit by an
    exclusive scan of its fields' bits, then its fields OR'ed into words
    whose bit 0 is the tile's first (the kernel's accumulator: a thread's
    first and last word by shared atomics, the words between by stores,
    each such word asserted to be the thread's alone) -> (words, the
    tile's bits)."""
    buf = [0] * n_words
    owners = {}  # word -> threads that wrote it
    widths = [int(nbits[i : i + 2 * per_thread].sum()) for i in range(0, len(nbits), 2 * per_thread)]
    first = 0
    for t, width in enumerate(widths):
        w, fill, acc, own = first >> 5, first & 31, 0, False
        for f in range(2 * per_thread * t, 2 * per_thread * (t + 1)):
            bits = int(nbits[f])
            stats["straddle_word"] += int(bits > 0 and (fill + bits - 1) >> 5 != fill >> 5)
            acc |= int(vals[f]) << fill
            fill += bits
            while fill >= 32:
                if own:
                    assert buf[w] == 0 and w not in owners
                    buf[w] = acc & 0xFFFFFFFF
                elif acc & 0xFFFFFFFF:
                    buf[w] |= acc & 0xFFFFFFFF
                owners.setdefault(w, set()).add(t)
                own = True
                acc >>= 32
                fill -= 32
                w += 1
        if acc & 0xFFFFFFFF:
            buf[w] |= acc & 0xFFFFFFFF
            owners.setdefault(w, set()).add(t)
        first += width
    stats["thread_shared_words"] += sum(len(o) > 1 for o in owners.values())
    return buf, first


def emit_tokens_model(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok,
                      tile=EMIT_TILE, per_thread=EMIT_PER, order_seed=0, resident=8):
    """K13's one launch. Blocks take tickets in lane-major order, at most
    ``resident`` at a time, and a seeded scheduler runs their steps in a
    random interleaving (the card's order of completion): (1) the tile's
    fields, each thread's first bit, its words in shared memory
    (``_tile_words``), its bit count published (lane's tile 0: as its
    prefix); (2) the look-back, 32 statuses a round back to the nearest
    prefix, a round that meets an unpublished status waiting (tried again
    later), then the tile's prefix published and, on the lane's last
    tile, the total and the EOD field OR'ed; (3) the tile's words stored
    whole at the lane's alignment, its first and last word OR'ed (a
    neighbour or the EOD may share them), every other word asserted to be
    written by this tile alone. ``tile`` must be a multiple of
    ``per_thread``. -> (words (B, num_words(n)) int64, total_bits (B,)
    int32, counters over ``EMIT_COUNTERS``)."""
    arrs = _np(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok)
    assert tile % per_thread == 0
    v1, n1, v2, n2 = emit_fields(*arrs)
    B, n = arrs[0].shape
    nw = num_words(n)
    tiles = -(-n // tile)
    # Fields in stream order: 2 p is position p's first field, 2 p + 1 its second.
    nbits = np.stack([n1, n2], axis=2).reshape(B, 2 * n)
    vals = np.where(nbits > 0, np.stack([v1, v2], axis=2).reshape(B, 2 * n), 0)
    tile_words = tile * FIELD_BITS // 32 + 1
    stats = dict.fromkeys(EMIT_COUNTERS, 0)
    words = [[0] * nw for _ in range(B)]
    writers = [{} for _ in range(B)]  # word -> tiles (the EOD as tile -1) that wrote it
    status = [[None] * tiles for _ in range(B)]  # (is_prefix, bits)
    total = np.zeros(B, np.int64)

    def or_into(b, g, v, who):
        if g < nw and v & 0xFFFFFFFF:
            words[b][g] |= v & 0xFFFFFFFF
            writers[b].setdefault(g, set()).add(who)

    class Tile:
        def __init__(self, ticket):
            self.b, self.j = divmod(ticket, tiles)
            self.step, self.k, self.before = 0, self.j - 1, 0

        def advance(self):
            b, j = self.b, self.j
            if self.step == 0:
                lo = 2 * j * tile
                hi = min(lo + 2 * tile, 2 * n)
                fv = np.zeros(2 * tile, np.int64)
                fb = np.zeros(2 * tile, np.int64)
                fv[: hi - lo], fb[: hi - lo] = vals[b, lo:hi], nbits[b, lo:hi]
                self.buf, self.agg = _tile_words(fv, fb, per_thread, tile_words, stats)
                status[b][j] = (j == 0, self.agg)
                stats["tiles"] += 1
                self.step = 1 if j > 0 else 2
                if j == 0:
                    self.publish()
            elif self.step == 1:
                window = [status[b][k] for k in range(self.k, max(self.k - 32, -1), -1)]
                if any(st is None for st in window):
                    stats["lookback_waits"] += 1
                    return
                stats["lookback_rounds"] += 1
                stats["statuses_read"] += len(window)
                for is_prefix, bits in window:
                    self.before += bits
                    if is_prefix:
                        status[b][j] = (True, self.before + self.agg)
                        self.publish()
                        self.step = 2
                        return
                self.k -= 32
            else:
                self.store()
                self.step = 3

        def publish(self):
            b, j = self.b, self.j
            if j == tiles - 1:
                end = self.before + self.agg
                eod_bits = int(arrs[4][b, EOD])
                total[b] = end + eod_bits
                if eod_bits > 0:
                    v = int(arrs[3][b, EOD])
                    or_into(b, end >> 5, v << (end & 31), -1)
                    if end & 31:
                        or_into(b, (end >> 5) + 1, v >> (32 - (end & 31)), -1)

        def store(self):
            b, s, agg = self.b, self.before, self.agg
            if agg == 0:
                return
            stats["unaligned_tiles"] += int(s % 32 != 0)
            g0, g1, sh = s >> 5, (s + agg - 1) >> 5, s & 31
            for g in range(g0, min(g1, nw - 1) + 1):
                k = g - g0
                both = (self.buf[k] << 32 | (self.buf[k - 1] if k else 0)) << sh
                v = (both >> 32) & 0xFFFFFFFF
                if (k == 0 and sh) or (g == g1 and (s + agg) % 32):
                    or_into(b, g, v, self.j)
                else:
                    assert words[b][g] == 0 and g not in writers[b]
                    words[b][g] = v
                    writers[b][g] = {self.j}

    rng = np.random.default_rng(order_seed)
    n_tickets, next_ticket, live = B * tiles, 0, []
    while next_ticket < n_tickets or live:
        admit = int(next_ticket < n_tickets and len(live) < resident)
        pick = int(rng.integers(0, len(live) + admit))
        if pick == len(live):
            live.append(Tile(next_ticket))
            next_ticket += 1
            continue
        live[pick].advance()
        if live[pick].step == 3:
            live.pop(pick)
    stats["shared_words"] = sum(len(w) > 1 for lane in writers for w in lane.values())
    return (torch.tensor(words, dtype=I64).view(B, nw), torch.from_numpy(_i32(total)), stats)


def _rank_order(k: np.ndarray) -> np.ndarray:
    """The warp kernel's rank count: key i goes to #{j: k_j < k_i} +
    #{j < i: k_j == k_i}."""
    B, S = k.shape
    below = k[:, None, :] < k[:, :, None]  # [b, i, j]: k_j < k_i
    tie = (k[:, None, :] == k[:, :, None]) & (np.arange(S)[None, :] < np.arange(S)[:, None])[None]
    rank = below.sum(axis=2) + tie.sum(axis=2)
    out = np.zeros((B, S), np.int64)
    np.put_along_axis(out, rank, np.broadcast_to(np.arange(S), (B, S)), axis=1)
    return out


LEX_PAD = np.uint64(2**64 - 1)  # the network's pad word, after every packed key


def _network_order(k: np.ndarray, P: int, E: int, stats: dict) -> np.ndarray:
    """The bitonic network in numpy, stage by stage, on the kernel's words
    (key ^ 2^31) << 32 | index padded with ~0: position t E + e starts
    with key index e T + t (T = P / E); merge width k first meets each
    position's mirror i ^ (k - 1) in its k-block, then i ^ j for j = k /
    4 .. 1, the smaller word to the lower position. Counts the stages that
    run in registers (partner in the thread), by shuffles (in the warp)
    and through shared memory."""
    B, S = k.shape
    T = P // E
    words = ((k.view(np.uint32) ^ np.uint32(2**31)).astype(np.uint64) << np.uint64(32)
             | np.arange(S, dtype=np.uint64)[None, :])
    i = np.arange(P)
    src = (i % E) * T + i // E  # position t E + e <- key index e T + t
    w = np.where(src < S, words[:, np.minimum(src, S - 1)], LEX_PAD)
    for lk in range(1, P.bit_length()):
        for lj in range(lk - 1, -1, -1):
            j = 1 << lj
            partner = i ^ ((1 << lk) - 1 if lj == lk - 1 else j)
            lower = (i & j) == 0
            w = np.where(lower, np.minimum(w, w[:, partner]), np.maximum(w, w[:, partner]))
            stats["stages"] += 1
            stats["register_stages" if j < E else "shuffle_stages" if j < 32 * E
                  else "shared_stages"] += 1
    assert (w[:, S:] == LEX_PAD).all()  # every pad after every key
    return (w[:, :S] & np.uint64(0xFFFFFFFF)).astype(np.int64)


def lex_order_model(key):
    """K14's schedule -> ((B, S) int64 order, counters): the warp kernel's
    rank count for S <= 32, else the network in the layout the C entry
    picks (``lex_order_layout``). Counters: rows,
    ties (pairs of equal keys that the index ordered), blocks, padded
    slots, the network's stages and their register, shuffle and shared
    counts (0 for the warp kernel)."""
    k = key.cpu().numpy().astype(np.int32)
    B, S = k.shape
    srt = np.sort(k, axis=1)
    ties = int(sum((c * (c - 1) // 2).sum() for c in (
        np.diff(np.flatnonzero(np.r_[True, row[1:] != row[:-1], True])) for row in srt)))
    stats = dict(rows=B, ties=ties, blocks=-(-B // (THREADS // 32)), padded=0, stages=0,
                 register_stages=0, shuffle_stages=0, shared_stages=0)
    if S <= 32:
        out = _rank_order(k.astype(np.int64))
    else:
        P, E, rows = lex_order_layout(B, S)
        stats.update(blocks=-(-B // rows), padded=B * (P - S))
        out = _network_order(k, P, E, stats)
    assert (np.sort(out, axis=1) == np.arange(S)[None, :]).all()  # a permutation
    return torch.from_numpy(out), stats
