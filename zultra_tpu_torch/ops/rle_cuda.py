"""The RLE decision sweep and the RLE statistics of code-length tables
(kernels ``csrc/rle.cu``), their plain PyTorch versions, and plain models
of the kernels' schedules.

``optimize_for_rle`` is the Zopfli histogram rewrite
(zultra_tpu.ops.entropy_jax.optimize_for_rle_jax, :462-545; reference
huffutils.c:34-114): a decision sweep over the ORIGINAL counts, then one
rewrite of the decided segments. The JAX package runs the sweep as a
``lax.scan`` inside the planner's one compiled program; its plain form
here is a Python loop of L + 1 steps of tensor ops. The ``rle_sweep``
kernel runs a warp per word of 32 counts (a block a row of 288, ten rows
of 32 a block), the rows of both of a planner call's sets
(``optimize_for_rle_pair``) in one launch: the warps find the
good-for-RLE runs, each step's inputs and the prefix sums of the counts;
the chain carries the limit alone, and since a boundary sets the limit
to its own step's, each lane finds the boundaries after itself within
its word (32 tests, then pointer doubling), so only a word's entry is
serial (on the row's first warp); then every position finds its segment
between the boundaries around it and is rewritten where the segment is
written.

``rle_histogram_masks`` and ``rle_bits_masks`` are the CL-symbol
histogram (entropy_jax.rle_histogram, :255) and the bit size
(entropy_jax.rle_bits, :276) of each lane's concatenated lengths under
several CL masks at once, mask-major: row m * B + b is lane b under
masks[m]. ``rle_histogram_tables`` and ``rle_bits_tables`` take the code
lengths themselves (lit_len, off_len) and concatenate them as
entropy_jax._concat_lengths (:568) does, in the kernel (the histograms
also give n_lit, n_off); on the CPU ``concat_lengths`` does it first. The
``rle_stats`` kernel finds a lane's runs once for all its masks (run
starts by ballot, each run's end from the next start), then with one
mask a warp takes the lane's runs 32 a step, each start's emission counts
in closed form (entropy_jax._run_counts, :202-252), the bins summed by
warp reductions; with several masks a block takes the lane, a thread a
run, and sums each run's counts under every class of masks that can
differ for it, each mask's row read from its classes. One launch covers
all of a call's masks.

Why the sweep's schedule is exact: every step reads the original counts
(``c``, ``good``, ``limit4`` are functions of the input row alone), and a
write decided at step i covers [i - stride, i), behind the cursor, so the
decisions never see a rewritten value and the segments, each starting at
the previous boundary, are disjoint and can be written after the sweep.
Only the limit carries from step to step: the stride and total at a
boundary are its distance to the previous boundary and the sum of the
counts between (int32 sums wrap, so a difference of wrapping prefix sums
equals the chain of adds). A step past ``eff`` changes nothing, so the
sweep stops at ``eff``.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import NCODELENSYMS, NLITERALSYMS, NOFFSETSYMS
from .. import _build
from . import count_launch

INF32 = 2**30
I32 = torch.int32
I64 = torch.int64
MAX_L = 320  # the kernels' rows: 288 literal/length + 32 offset lengths
MAX_MASKS = 32  # masks a rle_stats launch takes by value
WARP = 32
SWEEP_COUNTERS = ("rows", "words", "tests", "doubling_rounds", "boundaries", "segments",
                  "rewritten")
STATS_COUNTERS = ("lanes", "runs", "rows", "steps", "packed_rows", "group_adds",
                  "class_counts")
# One mask's histograms sum their 19 bins packed three to a register in
# PACK_BITS-bit fields, a warp reduction a register, where n_def < 2^PACK_BITS
# (the bins' total is at most n_def), else by aggregating equal symbols with
# __match_any_sync.
PACK_BITS = 10


def _arange(n, dev, dtype=I32):
    return torch.arange(n, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# The decision sweep
# ---------------------------------------------------------------------------


def _check_counts(name, counts):
    _build.check_cuda(f"rle_sweep {name}", counts, I32, 2)
    if not 1 <= counts.shape[1] <= MAX_L:
        raise ValueError(f"rle_sweep: rows of {counts.shape[1]} counts, the kernel takes "
                         f"1..{MAX_L}")


def optimize_for_rle(counts: torch.Tensor) -> torch.Tensor:
    """counts (B, L) int32, L <= 320 -> (B, L) int32: the histograms
    rewritten for RLE (optimize_histogram_for_rle, batched). A CPU tensor
    takes the plain form; a CUDA tensor one ``rle_sweep`` launch."""
    if counts.device.type == "cpu":
        return optimize_for_rle_plain(counts)
    _check_counts("counts", counts)
    out = torch.empty_like(counts)
    if counts.shape[0]:
        _build.launch("zt_rle_sweep", counts.data_ptr(), out.data_ptr(), *counts.shape,
                      None, None, 0, 0)
        count_launch("rle_sweep")
    return out


def optimize_for_rle_pair(lit: torch.Tensor, off: torch.Tensor):
    """``optimize_for_rle`` of two row sets, the planner's literal/length
    (B, 288) and offset (B, 32) histograms -> (lit, off) rewritten. CPU
    tensors take the plain form twice; CUDA tensors one ``rle_sweep``
    launch for both sets (a warp a row of either)."""
    if lit.device.type == "cpu" and off.device.type == "cpu":
        return optimize_for_rle_plain(lit), optimize_for_rle_plain(off)
    _check_counts("lit", lit)
    _check_counts("off", off)
    if lit.device != off.device:
        raise ValueError(f"rle_sweep: row sets on {lit.device} and {off.device}")
    out_lit, out_off = torch.empty_like(lit), torch.empty_like(off)
    if lit.shape[0] + off.shape[0]:
        _build.launch("zt_rle_sweep", lit.data_ptr(), out_lit.data_ptr(), *lit.shape,
                      off.data_ptr(), out_off.data_ptr(), *off.shape)
        count_launch("rle_sweep")
    return out_lit, out_off


def optimize_for_rle_plain(counts: torch.Tensor) -> torch.Tensor:
    """The decision sweep as tensor ops over the lanes, one step of the
    JAX scan a loop iteration, then one vectorized rewrite."""
    B, L = counts.shape
    dev = counts.device
    pos = _arange(L, dev)[None, :]
    eff = torch.where(counts != 0, pos + 1, 0).max(dim=1)[0]
    in_len = pos < eff[:, None]

    # good_for_rle: zero runs >= 5, nonzero runs >= 7 (within eff).
    prev = torch.cat([torch.full((B, 1), -1, dtype=counts.dtype, device=dev), counts[:, :-1]], dim=1)
    is_start = in_len & ((pos == 0) | (counts != prev))
    nxt_c = torch.where(is_start, pos, INF32)
    nxt_c = torch.cat([nxt_c[:, 1:], torch.full((B, 1), INF32, dtype=I32, device=dev)], dim=1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt_c, [1]), dim=1)[0], [1])
    run_len = torch.minimum(nxt, eff[:, None]) - pos
    good_start = is_start & torch.where(counts == 0, run_len >= 5, run_len >= 7)
    start_pos = torch.cummax(torch.where(is_start, pos, -1), dim=1)[0]
    good_at = torch.zeros((B, L), dtype=I32, device=dev).scatter_reduce_(
        1, torch.where(is_start, pos, 0).to(I64).expand(B, L).contiguous(),
        good_start.to(I32), "amax")
    good = in_len & (torch.gather(good_at, 1, torch.clamp(start_pos, 0, L - 1).to(I64)) > 0)

    # Decision sweep over i = 0..eff inclusive.
    c_ext = torch.cat([counts, torch.zeros((B, 4), dtype=counts.dtype, device=dev)], dim=1)
    limit4 = (c_ext[:, :L] + c_ext[:, 1:L + 1] + c_ext[:, 2:L + 2] + c_ext[:, 3:L + 3] + 2) // 4
    good_ext = torch.cat([good, torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1)
    stride = torch.zeros(B, dtype=I32, device=dev)
    limit = c_ext[:, 0].to(I32)
    total = torch.zeros(B, dtype=I32, device=dev)
    wr, wstart, wval = [], [], []
    for i in range(L + 1):
        at_end = i == eff
        inside = i < eff
        ci = c_ext[:, i]
        boundary = at_end | (inside & (good_ext[:, i] | ((ci - limit).abs() >= 4)))
        do_write = boundary & ((stride >= 4) | ((stride >= 3) & (total == 0)))
        val = torch.clamp((total + stride // 2) // torch.clamp(stride, min=1), min=1)
        val = torch.where(total == 0, 0, val)
        wr.append(do_write & (i <= eff))
        wstart.append(i - stride)
        wval.append(val)
        lim_new = torch.where(i < eff - 3, limit4[:, min(i, L - 1)],
                              torch.where(inside, ci, 0))
        limit = torch.where(boundary, lim_new, limit)
        stride = torch.where(boundary, 0, stride) + (i <= eff).to(I32)
        total = torch.where(boundary, 0, total) + torch.where(inside, ci, 0)
    wr = torch.stack(wr, dim=1)
    wstart = torch.stack(wstart, dim=1)
    wval = torch.stack(wval, dim=1)
    wend = _arange(L + 1, dev)[None, :].expand(B, L + 1)

    # Rewrite segments [wstart, wend): each position takes the latest
    # write-start at or before it (segments are disjoint).
    ws = torch.where(wr, torch.clamp(wstart, 0, L - 1), 0).to(I64)
    end_at = torch.full((B, L), -1, dtype=I32, device=dev).scatter_reduce_(
        1, ws, torch.where(wr, wend, -1), "amax")
    val_at = torch.full((B, L), -1, dtype=I32, device=dev).scatter_reduce_(
        1, ws, torch.where(wr, wval, -1), "amax")
    wkey = torch.cummax(torch.where(end_at >= 0, pos, -1), dim=1)[0]
    wkey_c = torch.clamp(wkey, 0, L - 1).to(I64)
    covered = (wkey >= 0) & (pos < torch.gather(end_at, 1, wkey_c))
    fill_val = torch.gather(val_at, 1, wkey_c)
    return torch.where((eff[:, None] > 0) & covered, fill_val, counts)


def _i32(x: int) -> int:
    """x wrapped to int32, as the kernels' and the plain forms' adds wrap."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _start_words(row: list, n: int) -> list:
    """The warp's ballots: word k bit l set iff position 32k + l < n starts
    a run (position 0, or a value other than the one before it)."""
    words = []
    for k in range(-(-len(row) // WARP)):
        bits = 0
        for lane in range(WARP):
            i = k * WARP + lane
            if i < min(n, len(row)) and (i == 0 or row[i] != row[i - 1]):
                bits |= 1 << lane
        words.append(bits)
    return words


def _prev_start(words: list, i: int) -> int:
    """The highest start at or below i (-1 if none), word by word."""
    k, lane = divmod(i, WARP)
    m = words[k] & ((2 << lane) - 1)
    while not m and k > 0:
        k -= 1
        m = words[k]
    return k * WARP + m.bit_length() - 1 if m else -1


def _next_start(words: list, i: int):
    """The lowest start above i (None if none), word by word."""
    k, lane = divmod(i, WARP)
    m = words[k] & ~((2 << lane) - 1) if lane < WARP - 1 else 0
    while not m and k + 1 < len(words):
        k += 1
        m = words[k]
    return k * WARP + (m & -m).bit_length() - 1 if m else None


def _abs32(x: int) -> int:
    """|x| of an int32 as int32 arithmetic gives it (|INT32_MIN| wraps to
    itself), as the plain form's and the kernel's abs."""
    return _i32(-x) if x < 0 else x


def _word_paths(cw, good, step_limit, base, eff, stats):
    """One word's boundary paths: for each lane i, the next lane j > i
    (below ``eff``) that is a boundary under limit step_limit[base + i],
    then the boundaries from i on by five rounds of pointer doubling ->
    [path bits of lane i]."""
    live = [base + j < eff for j in range(WARP)]
    nxt = []
    for i in range(WARP):
        after = step_limit[base + i]
        stats["tests"] += WARP
        nxt.append(next((j for j in range(i + 1, WARP) if live[j] and (
            good[base + j] or _abs32(_i32(cw[base + j] - after)) >= 4)), WARP))
    path = [1 << i for i in range(WARP)]
    for _ in range(5):
        stats["doubling_rounds"] += 1
        further = [path[x % WARP] for x in nxt]
        then = [nxt[x % WARP] for x in nxt]
        path = [p | f if x < WARP else p for p, f, x in zip(path, further, nxt)]
        nxt = [t if x < WARP else x for x, t in zip(nxt, then)]
    return path


def rle_sweep_model(counts: torch.Tensor):
    """The ``rle_sweep`` kernel's schedule on a CPU tensor, row by row ->
    (the (B, L) rewrite of ``optimize_for_rle_plain``, {counter: count}
    over ``SWEEP_COUNTERS``). The warp's parallel part: ``eff`` by a max,
    the run starts as ballot words, each position's run from the nearest
    starts, ``good``, each step's (count, limit a boundary sets) and the
    wrapping prefix sums. The chain by words of 32 steps below ``eff``
    (a warp each on the card): each lane's next boundary and path of
    boundaries within its word (``_word_paths``), then the words in order, each entered with the
    limit the last boundary before it set: the lowest lane that is a
    boundary under it starts the word's path. Then every position's
    segment from the boundary masks, its total from the prefix sums.
    Asserts that the rewrite equals the sequential sweep's
    (``optimize_for_rle_plain``)."""
    B, L = counts.shape
    out = counts.tolist()
    stats = dict.fromkeys(SWEEP_COUNTERS, 0)
    for row_out, c in zip(out, counts.tolist()):
        stats["rows"] += 1
        eff = max((i + 1 for i, v in enumerate(c) if v != 0), default=0)
        n_words = -(-eff // WARP)
        cw = c + [0] * (WARP * n_words + 3 - L)
        words = _start_words(c, eff)
        good = [False] * len(cw)
        for i in range(eff):
            s = _prev_start(words, i)
            ns = _next_start(words, i)
            good[i] = (eff if ns is None else ns) - s >= (5 if c[i] == 0 else 7)
        limit4 = [_i32(sum(cw[i : i + 4]) + 2) >> 2 for i in range(len(cw) - 3)]
        step_limit = [limit4[i] if i < eff - 3 else cw[i] for i in range(len(cw) - 3)]
        pre = [0]
        for x in cw:
            pre.append(_i32(pre[-1] + x))
        limit, bounds = cw[0], []
        for k in range(n_words):
            stats["words"] += 1
            base = WARP * k
            path = _word_paths(cw, good, step_limit, base, eff, stats)
            first = [j for j in range(WARP) if base + j < eff and (
                good[base + j] or _abs32(_i32(cw[base + j] - limit)) >= 4)]
            if first:
                bits = path[first[0]]
                bounds += [base + j for j in range(WARP) if bits >> j & 1]
                limit = step_limit[base + bits.bit_length() - 1]
        stats["boundaries"] += len(bounds) + (eff > 0)
        segments = []
        for s, e in zip([0] + bounds, bounds + [eff]):
            stride, total = e - s, _i32(pre[e] - pre[s])
            if stride >= 4 or (stride >= 3 and total == 0):
                segments.append((s, e, 0 if total == 0 else max(_i32(total + stride // 2)
                                                                // stride, 1)))
        for start, end, val in segments:
            stats["segments"] += 1
            stats["rewritten"] += end - start
            row_out[start:end] = [val] * (end - start)
    out = torch.tensor(out, dtype=I32).view(B, L)
    assert torch.equal(out, optimize_for_rle_plain(counts))
    return out, stats


# ---------------------------------------------------------------------------
# The RLE statistics of code-length tables
# ---------------------------------------------------------------------------


def defined_count(lens: torch.Tensor, min_symbols: int) -> torch.Tensor:
    """(B,) the last nonzero entry's position + 1 of each row, at least
    min_symbols (entropy_jax.defined_count, :307)."""
    S = lens.shape[1]
    posp1 = _arange(S, lens.device)[None, :] + 1
    last = torch.where(lens != 0, posp1, 0).max(dim=1)[0]
    return torch.clamp(last, min=min_symbols)


def concat_lengths(lit_len: torch.Tensor, off_len: torch.Tensor):
    """concat(lit_len[:n_lit], off_len[:n_off]) as fixed (B, 320) + n_lit,
    n_off, n_def (entropy_jax._concat_lengths, :568): the plain front of
    the fused statistics, which the kernel does in registers."""
    n_lit = defined_count(lit_len, 257)
    n_off = defined_count(off_len, 1)
    L = NLITERALSYMS + NOFFSETSYMS
    j = _arange(L, lit_len.device)[None, :]
    from_off = j >= n_lit[:, None]
    oidx = torch.clamp(j - n_lit[:, None], 0, NOFFSETSYMS - 1)
    lens = torch.where(
        from_off,
        torch.gather(off_len, 1, oidx.to(I64)),
        torch.gather(lit_len, 1, torch.clamp(j, 0, NLITERALSYMS - 1).to(I64).expand(lit_len.shape[0], L)),
    )
    return lens, n_lit, n_off, n_lit + n_off


def _check_masks(masks) -> tuple:
    masks = tuple(int(m) for m in masks)
    if not 1 <= len(masks) <= MAX_MASKS or any(not 0 <= m < 32 for m in masks):
        raise ValueError(f"rle_stats: 1..{MAX_MASKS} masks in 0..31, got {list(masks)}")
    return masks


def _check_te(te_lens: torch.Tensor, rows: int) -> None:
    if te_lens.shape != (rows, NCODELENSYMS):
        raise ValueError(f"rle_stats: te_lens of shape {tuple(te_lens.shape)}, expected "
                         f"({rows}, {NCODELENSYMS})")


def _launch_stats(lit, off, n_def, masks, te, out, n_lit, n_off, min_lit: int,
                  min_off: int) -> None:
    """One ``rle_stats`` launch: rows lit[b, :n_lit] ++ off[b, :n_off]
    (the C entry's arguments; ``off`` None and ``n_def`` given for rows
    already concatenated)."""
    B, L_lit = lit.shape
    L_off = 0 if off is None else off.shape[1]
    if B:
        arr = (ctypes.c_int * len(masks))(*masks)
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        _build.launch("zt_rle_stats", lit.data_ptr(), ptr(off), ptr(n_def), ptr(te),
                      out.data_ptr(), ptr(n_lit), ptr(n_off), L_lit, min_lit, L_off, min_off,
                      B, ctypes.addressof(arr), len(masks), 0 if te is None else 1)
        count_launch("rle_stats")


def _check_rows(lens: torch.Tensor, n_def: torch.Tensor) -> None:
    _build.check_cuda("rle_stats lens", lens, I32, 2)
    _build.check_cuda("rle_stats n_def", n_def, I32, 1)
    if n_def.shape[0] != lens.shape[0]:
        raise ValueError("rle_stats: n_def must have one entry per lane")
    if not 1 <= lens.shape[1] <= MAX_L:
        raise ValueError(f"rle_stats: rows of {lens.shape[1]} lengths, the kernel takes 1..{MAX_L}")


def _check_tables(lit_len: torch.Tensor, off_len: torch.Tensor) -> None:
    _build.check_cuda("rle_stats lit_len", lit_len, I32, 2)
    _build.check_cuda("rle_stats off_len", off_len, I32, 2)
    if lit_len.shape != (off_len.shape[0], NLITERALSYMS) or off_len.shape[1] != NOFFSETSYMS:
        raise ValueError(f"rle_stats: lit_len {tuple(lit_len.shape)} and off_len "
                         f"{tuple(off_len.shape)}, expected (B, {NLITERALSYMS}) and "
                         f"(B, {NOFFSETSYMS})")


def rle_histogram_masks(lens: torch.Tensor, n_def: torch.Tensor, masks) -> torch.Tensor:
    """lens (B, L) int32, n_def (B,) int32, masks a sequence of M static
    CL masks -> (M * B, 19) int32 CL-symbol histograms of the RLE walk
    over each lane's first n_def lengths, mask-major. A CUDA tensor takes
    one ``rle_stats`` launch (histogram mode)."""
    masks = _check_masks(masks)
    if lens.device.type == "cpu":
        return torch.cat([rle_histogram_plain(lens, n_def, m) for m in masks])
    _check_rows(lens, n_def)
    out = torch.empty((len(masks) * lens.shape[0], NCODELENSYMS), dtype=I32, device=lens.device)
    _launch_stats(lens, None, n_def, masks, None, out, None, None, lens.shape[1], 0)
    return out


def rle_bits_masks(lens: torch.Tensor, n_def: torch.Tensor, te_lens: torch.Tensor,
                   masks) -> torch.Tensor:
    """lens (B, L), n_def (B,), te_lens (M * B, 19) int32 CL code lengths
    (row m * B + b for lane b under masks[m]) -> (M * B,) int32 bit sizes
    of the RLE-coded tables. A CUDA tensor takes one ``rle_stats`` launch
    (bits mode)."""
    masks = _check_masks(masks)
    B = lens.shape[0]
    _check_te(te_lens, len(masks) * B)
    if lens.device.type == "cpu":
        return torch.cat([rle_bits_plain(lens, n_def, te_lens[i * B:(i + 1) * B], m)
                          for i, m in enumerate(masks)])
    _check_rows(lens, n_def)
    _build.check_cuda("rle_stats te_lens", te_lens, I32, 2)
    out = torch.empty(len(masks) * B, dtype=I32, device=lens.device)
    _launch_stats(lens, None, n_def, masks, te_lens, out, None, None, lens.shape[1], 0)
    return out


def rle_histogram_tables(lit_len: torch.Tensor, off_len: torch.Tensor, masks):
    """lit_len (B, 288), off_len (B, 32) int32 code lengths, M static CL
    masks -> ((M * B, 19) CL-symbol histograms of each lane's concatenated
    lengths, mask-major; n_lit, n_off (B,)). A CPU tensor takes the plain
    form (``concat_lengths``, then ``rle_histogram_plain`` a mask); a CUDA
    tensor one ``rle_stats`` launch, the concatenation in the kernel."""
    masks = _check_masks(masks)
    if lit_len.device.type == "cpu":
        lens, n_lit, n_off, n_def = concat_lengths(lit_len, off_len)
        return torch.cat([rle_histogram_plain(lens, n_def, m) for m in masks]), n_lit, n_off
    _check_tables(lit_len, off_len)
    B = lit_len.shape[0]
    out = torch.empty((len(masks) * B, NCODELENSYMS), dtype=I32, device=lit_len.device)
    n_lit = torch.empty(B, dtype=I32, device=lit_len.device)
    n_off = torch.empty(B, dtype=I32, device=lit_len.device)
    _launch_stats(lit_len, off_len, None, masks, None, out, n_lit, n_off, 257, 1)
    return out, n_lit, n_off


def rle_bits_tables(lit_len: torch.Tensor, off_len: torch.Tensor, te_lens: torch.Tensor,
                    masks) -> torch.Tensor:
    """lit_len (B, 288), off_len (B, 32), te_lens (M * B, 19) -> (M * B,)
    int32 bit sizes of each lane's RLE-coded concatenated lengths under
    masks[m] and te_lens row m * B + b. A CPU tensor takes the plain form;
    a CUDA tensor one ``rle_stats`` launch."""
    masks = _check_masks(masks)
    B = lit_len.shape[0]
    _check_te(te_lens, len(masks) * B)
    if lit_len.device.type == "cpu":
        lens, _, _, n_def = concat_lengths(lit_len, off_len)
        return rle_bits_masks(lens, n_def, te_lens, masks)
    _check_tables(lit_len, off_len)
    _build.check_cuda("rle_stats te_lens", te_lens, I32, 2)
    out = torch.empty(len(masks) * B, dtype=I32, device=lit_len.device)
    _launch_stats(lit_len, off_len, None, masks, te_lens, out, None, None, 257, 1)
    return out


def _run_structure(lens: torch.Tensor, n_def: torch.Tensor):
    """Maximal runs of each lane's first n_def entries: (is_start,
    run_len) with run_len meaningful at starts."""
    B, L = lens.shape
    dev = lens.device
    pos = _arange(L, dev)[None, :]
    valid = pos < n_def[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=lens.dtype, device=dev), lens[:, :-1]], dim=1)
    is_start = valid & ((pos == 0) | (lens != prev))
    nxt_c = torch.where(is_start, pos, INF32)
    nxt_c = torch.cat([nxt_c[:, 1:], torch.full((B, 1), INF32, dtype=I32, device=dev)], dim=1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt_c, [1]), dim=1)[0], [1])
    run_end = torch.minimum(nxt, n_def[:, None])
    return is_start, torch.where(is_start, run_end - pos, 0)


def _run_counts(value, r, mask: int):
    """Per-run RLE emission counts under a static ``mask`` (walk_var_
    lengths): (n16, n17, n18, lit_count, lit_value)."""
    zero = value == 0
    zeros = torch.zeros_like(r)
    r3 = r >= 3
    if mask & 4:
        ge11 = r >= 11
        q = r // 138
        rem = r % 138
        n18 = torch.where(r3 & ge11, q + (rem >= 11).to(I32), 0)
        after18 = torch.where(r3 & ge11, torch.where(rem >= 11, 0, rem), r)
    else:
        n18 = zeros
        after18 = r
    if mask & 2:
        q10 = after18 // 10
        rem10 = after18 % 10
        n17 = torch.where(r3 & (after18 >= 3), q10 + (rem10 >= 3).to(I32), 0)
        after17 = torch.where(r3 & (after18 >= 3), torch.where(rem10 >= 3, 0, rem10), after18)
    else:
        n17 = zeros
        after17 = after18
    z_lit = after17

    vclamp = torch.clamp(value, max=15)
    rp = r - 1
    if mask & 1:
        s7 = (rp == 7) if not (mask & 8) else torch.zeros_like(rp, dtype=torch.bool)
        s8 = (rp == 8) if not (mask & 16) else torch.zeros_like(rp, dtype=torch.bool)
        q6 = rp // 6
        rem6 = rp % 6
        n16_gen = q6 + (rem6 >= 3).to(I32)
        left_gen = torch.where(rem6 < 3, rem6, 0)
        n16 = torch.where(s7 | s8, 2, n16_gen)
        nz_left = torch.where(s7 | s8, 0, left_gen)
    else:
        n16 = zeros
        nz_left = rp
    nz_lit = 1 + nz_left

    n16 = torch.where(zero, 0, n16)
    n17 = torch.where(zero, n17, 0)
    n18 = torch.where(zero, n18, 0)
    lit_count = torch.where(zero, z_lit, nz_lit)
    lit_value = torch.where(zero, 0, vclamp)
    return n16, n17, n18, lit_count, lit_value


def _rle_runs(lens, n_def, mask):
    is_start, r = _run_structure(lens, n_def)
    counts = _run_counts(lens, torch.clamp(r, min=1), mask)
    n16, n17, n18, lit_c = (torch.where(is_start, x, 0) for x in counts[:4])
    return is_start, n16, n17, n18, lit_c, counts[4]


def rle_histogram_plain(lens: torch.Tensor, n_def: torch.Tensor, mask: int) -> torch.Tensor:
    """CL-symbol histogram of the RLE walk over each lane's lengths
    (update_var_lengths_entropy). lens (B, L), n_def (B,) -> (B, 19)."""
    B = lens.shape[0]
    is_start, n16, n17, n18, lit_c, lit_v = _rle_runs(lens, n_def, mask)
    idx = torch.where(is_start, torch.clamp(lit_v, 0, 15), NCODELENSYMS)
    hist = torch.zeros((B, NCODELENSYMS + 1), dtype=lit_c.dtype, device=lens.device)
    hist.scatter_add_(1, idx.to(I64), lit_c)
    hist = hist[:, :NCODELENSYMS].clone()
    hist[:, 16] += n16.sum(dim=1, dtype=I32)
    hist[:, 17] += n17.sum(dim=1, dtype=I32)
    hist[:, 18] += n18.sum(dim=1, dtype=I32)
    return hist


def rle_bits_plain(lens: torch.Tensor, n_def: torch.Tensor, te_lens: torch.Tensor,
                   mask: int) -> torch.Tensor:
    """Bit size of the RLE-coded table under CL lengths ``te_lens``
    (get_var_lengths_size). -> (B,)."""
    _, n16, n17, n18, lit_c, lit_v = _rle_runs(lens, n_def, mask)
    lit_len = torch.gather(te_lens, 1, torch.clamp(lit_v, 0, 15).to(I64))
    bits = (lit_c * lit_len).sum(dim=1, dtype=I32)
    bits = bits + n16.sum(dim=1, dtype=I32) * (te_lens[:, 16] + 2)
    bits = bits + n17.sum(dim=1, dtype=I32) * (te_lens[:, 17] + 3)
    bits = bits + n18.sum(dim=1, dtype=I32) * (te_lens[:, 18] + 7)
    return bits


def _run_counts_scalar(value: int, r: int, mask: int):
    """One run's (n16, n17, n18, lit_count, lit_value) in closed form, as
    a thread of the ``rle_stats`` kernel computes it at the run's start."""
    if value == 0:
        n18, after = 0, r
        if mask & 4 and r >= 11:
            q, rem = divmod(r, 138)
            n18, after = q + (rem >= 11), (0 if rem >= 11 else rem)
        n17 = 0
        if mask & 2 and r >= 3 and after >= 3:
            q, rem = divmod(after, 10)
            n17, after = q + (rem >= 3), (0 if rem >= 3 else rem)
        return 0, n17, n18, after, 0
    rp = r - 1
    n16, left = 0, rp
    if mask & 1:
        if (rp == 7 and not mask & 8) or (rp == 8 and not mask & 16):
            n16, left = 2, 0
        else:
            q, rem = divmod(rp, 6)
            n16, left = q + (rem >= 3), (rem if rem < 3 else 0)
    return n16, 0, 0, 1 + left, min(value, 15)


ZERO_RUN = 16  # the CL symbol field of a run of zeros (csrc/rle.cu)


def _find_runs(lv: list, ov: list, nd_given, min_lit: int, min_off: int, stats: dict):
    """One lane's row and runs as ``find_runs`` finds them, by one warp:
    n_lit, n_off by max reductions, the row concatenated word by word, the
    start ballots, each start's end from the rest of its word or the first
    start of the next nonzero word, the runs compacted in order ->
    (runs [(length, CL symbol)], n_lit, n_off)."""
    n_lit = max(max((i + 1 for i, v in enumerate(lv) if v), default=0), min_lit)
    n_off = max(max((j + 1 for j, v in enumerate(ov) if v), default=0), min_off)
    nd = n_lit + n_off if nd_given is None else nd_given
    n = min(nd, n_lit + n_off)
    row = [lv[i] if i < n_lit else (ov[i - n_lit] if i - n_lit < n_off else 0)
           for i in range(MAX_L)]
    words = _start_words(row, n)
    firsts = [k * WARP + (w & -w).bit_length() - 1 if w else None for k, w in enumerate(words)]
    runs = []
    for k, word in enumerate(words):
        after = next((f for f in firsts[k + 1:] if f is not None), None)
        for lane in range(WARP):
            if not word >> lane & 1:
                continue
            i = k * WARP + lane
            rest = word & ~((2 << lane) - 1) & 0xFFFFFFFF
            e = k * WARP + (rest & -rest).bit_length() - 1 if rest else after
            assert e is None or e == _next_start(words, i)
            end = nd if e is None else min(e, nd)
            runs.append((max(end - i, 1), ZERO_RUN if row[i] == 0 else min(max(row[i], 0), 15)))
    stats["lanes"] += 1
    stats["runs"] += len(runs)
    return runs, n_lit, n_off



def _nonzero_class_mask(c: int) -> int:
    """A mask of nonzero-run class c (csrc/rle.cu nonzero_class_mask)."""
    return 0 if c == 0 else 1 | (8 if (c - 1) & 1 else 0) | (16 if (c - 1) & 2 else 0)


def _nonzero_class(mask: int) -> int:
    return 1 + (mask >> 3 & 1) + 2 * (mask >> 4 & 1) if mask & 1 else 0


def rle_stats_model(lit, off, n_def, masks, te_lens=None):
    """The ``rle_stats`` kernels' schedule on CPU tensors, as the C entry
    takes it: rows lit[b, :n_lit] ++ off[b, :n_off] (``off`` (B, 32) with
    ``n_def`` None: the fused statistics of ``rle_histogram_tables`` /
    ``rle_bits_tables``; ``off`` None with ``n_def``: rows already
    concatenated). -> (the (M * B, 19) histograms, or with ``te_lens``
    the (M * B,) bit sizes; n_lit, n_off (B,); {counter: count} over
    ``STATS_COUNTERS``). Each lane's runs are found once
    (``_find_runs``). One mask: the warp takes them in steps of 32, each
    run's counts in closed form (``_run_counts_scalar``), the bins summed
    packed (n_def < 2^PACK_BITS, asserting that no field overflows) or
    else one add a group of lanes of equal symbol. Several masks: each run adds its counts under every
    class of its kind (five for a nonzero run, by mask bits 1, 8, 16; four
    for a run of zeros, by bits 2, 4) and each mask's row is read from its
    two classes (bits: the dot product with its CL lengths). Sums wrap as
    int32. Asserts that every row is written once, that a lane's runs are
    found once, and that a class's counts are those of each of its masks."""
    lits = lit.tolist()
    B, L_lit = lit.shape
    offs = [[] for _ in range(B)] if off is None else off.tolist()
    nds = [None] * B if n_def is None else n_def.tolist()
    min_lit, min_off = (L_lit, 0) if off is None else (257, 1)
    masks = [int(m) for m in masks]
    M = len(masks)
    te = None if te_lens is None else te_lens.tolist()
    stats = dict.fromkeys(STATS_COUNTERS, 0)
    out = [None] * (M * B)
    n_lit_out, n_off_out = [0] * B, [0] * B
    for b in range(B):
        runs, n_lit_out[b], n_off_out[b] = _find_runs(lits[b], offs[b], nds[b], min_lit,
                                                      min_off, stats)
        rows = {}
        if M == 1:  # a warp a lane, 32 runs a step
            nd = n_lit_out[b] + n_off_out[b] if nds[b] is None else nds[b]
            packed = nd < 1 << PACK_BITS
            stats["packed_rows"] += packed
            hist = [0] * NCODELENSYMS
            for base in range(0, len(runs), WARP):
                stats["steps"] += 1
                step = []
                for r, sym in runs[base:base + WARP]:
                    n16, n17, n18, lit_c, _ = _run_counts_scalar(0 if sym == ZERO_RUN else 1, r,
                                                                 masks[0])
                    step.append((0 if sym == ZERO_RUN else sym, lit_c))
                    for k, v in ((16, n16), (17, n17), (18, n18)):
                        hist[k] = _i32(hist[k] + v)
                if not packed:
                    stats["group_adds"] += len({bin_ for bin_, _ in step})
                for bin_, lit_c in step:
                    hist[bin_] = _i32(hist[bin_] + lit_c)
            if packed:  # every field's total fits its bits: the bins' sum is at most nd
                assert sum(hist) <= max(nd, 0) and max(hist) < 1 << PACK_BITS
            rows[0] = hist
        else:  # a block a lane: every class once, a thread a run
            lit_cls = [[0] * 16 for _ in range(5)]
            n16_cls = [0] * 5
            zero_cls = [[0, 0, 0] for _ in range(4)]
            for r, sym in runs:
                if sym == ZERO_RUN:
                    for c in range(4):
                        _, n17, n18, lit_c, _ = _run_counts_scalar(0, r, c << 1)
                        zero_cls[c] = [_i32(x + y) for x, y in zip(zero_cls[c], (lit_c, n17, n18))]
                        stats["class_counts"] += 1
                else:
                    for c in range(5):
                        n16, _, _, lit_c, _ = _run_counts_scalar(1, r, _nonzero_class_mask(c))
                        lit_cls[c][sym] = _i32(lit_cls[c][sym] + lit_c)
                        n16_cls[c] = _i32(n16_cls[c] + n16)
                        stats["class_counts"] += 1
            for m, mask in enumerate(masks):
                nc, zc = _nonzero_class(mask), mask >> 1 & 3
                for r, sym in runs:  # the classes are exact: each mask's own counts
                    got = _run_counts_scalar(0 if sym == ZERO_RUN else 1, r,
                                             (zc << 1) if sym == ZERO_RUN else _nonzero_class_mask(nc))
                    assert got[:4] == _run_counts_scalar(0 if sym == ZERO_RUN else 1, r, mask)[:4]
                hist = list(lit_cls[nc]) + [n16_cls[nc], zero_cls[zc][1], zero_cls[zc][2]]
                hist[0] = _i32(hist[0] + zero_cls[zc][0])
                rows[m] = hist
        for m, hist in rows.items():
            stats["rows"] += 1
            row = m * B + b
            assert out[row] is None
            if te is None:
                out[row] = hist
            else:
                t = te[row]
                bits = sum(hist[k] * t[k] for k in range(16))
                bits += hist[16] * (t[16] + 2) + hist[17] * (t[17] + 3) + hist[18] * (t[18] + 7)
                out[row] = _i32(bits)
    shape = (M * B, NCODELENSYMS) if te is None else (M * B,)
    return (torch.tensor(out, dtype=I32).view(shape), torch.tensor(n_lit_out, dtype=I32),
            torch.tensor(n_off_out, dtype=I32), stats)
