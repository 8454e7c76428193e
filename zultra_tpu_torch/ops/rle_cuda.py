"""The RLE decision sweep and the RLE statistics of code-length tables
(kernels ``csrc/rle.cu``), their plain PyTorch versions, and plain models
of the kernels' schedules.

``optimize_for_rle`` is the Zopfli histogram rewrite
(zultra_tpu.ops.entropy_jax.optimize_for_rle_jax, :462-545; reference
huffutils.c:34-114): a decision sweep over the ORIGINAL counts, then one
rewrite of the decided segments. The JAX package runs the sweep as a
``lax.scan`` inside the planner's one compiled program; its plain form
here is a Python loop of L + 1 steps of tensor ops. The ``rle_sweep``
kernel runs a warp per row: the warp finds the good-for-RLE runs and the
four-wide limits, lane 0 runs the sweep with its carry in registers, and
the warp writes the decided segments.

``rle_histogram_masks`` and ``rle_bits_masks`` are the CL-symbol
histogram (entropy_jax.rle_histogram, :255) and the bit size
(entropy_jax.rle_bits, :276) of each lane's concatenated lengths under
several CL masks at once, mask-major: row m * B + b is lane b under
masks[m]. The ``rle_stats`` kernel runs a warp per row in either mode:
the run starts by ballot, each start's emission counts in closed form
(entropy_jax._run_counts, :202-252), a warp sum into 19 bins or one bit
total. One launch covers all of a call's masks.

Why the sweep's schedule is exact: every step reads the original counts
(``c``, ``good``, ``limit4`` are functions of the input row alone), and a
write decided at step i covers [i - stride, i), behind the cursor, so the
decisions never see a rewritten value and the segments, each starting at
the previous boundary, are disjoint and can be written after the sweep.
A step past ``eff`` changes nothing, so the sweep stops at ``eff``.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import NCODELENSYMS
from .. import _build
from . import count_launch

INF32 = 2**30
I32 = torch.int32
I64 = torch.int64
MAX_L = 320  # the kernels' rows: 288 literal/length + 32 offset lengths
MAX_MASKS = 32  # masks a rle_stats launch takes by value
WARP = 32
SWEEP_COUNTERS = ("rows", "steps", "boundaries", "segments", "rewritten")
STATS_COUNTERS = ("rows", "runs", "words")


def _arange(n, dev, dtype=I32):
    return torch.arange(n, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# The decision sweep
# ---------------------------------------------------------------------------


def optimize_for_rle(counts: torch.Tensor) -> torch.Tensor:
    """counts (B, L) int32, L <= 320 -> (B, L) int32: the histograms
    rewritten for RLE (optimize_histogram_for_rle, batched). A CPU tensor
    takes the plain form; a CUDA tensor one ``rle_sweep`` launch."""
    if counts.device.type == "cpu":
        return optimize_for_rle_plain(counts)
    _build.check_cuda("rle_sweep counts", counts, I32, 2)
    B, L = counts.shape
    if not 1 <= L <= MAX_L:
        raise ValueError(f"rle_sweep: rows of {L} counts, the kernel takes 1..{MAX_L}")
    out = torch.empty_like(counts)
    if B:
        _build.launch("zt_rle_sweep", counts.data_ptr(), out.data_ptr(), B, L)
        count_launch("rle_sweep")
    return out


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


def rle_sweep_model(counts: torch.Tensor):
    """The ``rle_sweep`` kernel's schedule on a CPU tensor, row by row ->
    (the (B, L) rewrite of ``optimize_for_rle_plain``, {counter: count}
    over ``SWEEP_COUNTERS``). The warp's part: ``eff`` by a max, the run
    starts as ballot words, each position's run from the starts around
    it, ``good`` and ``limit4`` for every position. Lane 0's part: the
    sweep over i = 0..eff with (stride, limit, total) carried, appending
    each decided segment. Then the warp writes the segments. Asserts
    that every segment lies behind the cursor and after the one before."""
    B, L = counts.shape
    out = counts.tolist()
    stats = dict.fromkeys(SWEEP_COUNTERS, 0)
    for row_out, c in zip(out, counts.tolist()):
        stats["rows"] += 1
        eff = max((i + 1 for i, v in enumerate(c) if v != 0), default=0)
        words = _start_words(c, eff)
        good = [False] * L
        for i in range(eff):
            s = _prev_start(words, i)
            ns = _next_start(words, i)
            run = (eff if ns is None else ns) - s
            good[i] = run >= (5 if c[i] == 0 else 7)
        c4 = c + [0, 0, 0, 0]
        limit4 = [_i32(c4[i] + c4[i + 1] + c4[i + 2] + c4[i + 3] + 2) // 4 for i in range(L)]
        stride, limit, total = 0, c4[0], 0
        segments = []
        for i in range(eff + 1):
            stats["steps"] += 1
            inside = i < eff
            ci = c4[i]
            if i == eff or (good[i] or abs(ci - limit) >= 4):
                stats["boundaries"] += 1
                if stride >= 4 or (stride >= 3 and total == 0):
                    val = 0 if total == 0 else max(_i32(total + stride // 2) // stride, 1)
                    start = i - stride
                    assert start >= (segments[-1][1] if segments else 0) and i <= eff
                    segments.append((start, i, val))
                limit = limit4[i] if i < eff - 3 else (ci if inside else 0)
                stride = total = 0
            stride += 1
            total = _i32(total + (ci if inside else 0))
        for start, end, val in segments:
            stats["segments"] += 1
            stats["rewritten"] += end - start
            row_out[start:end] = [val] * (end - start)
    return torch.tensor(out, dtype=I32).view(B, L), stats


# ---------------------------------------------------------------------------
# The RLE statistics of code-length tables
# ---------------------------------------------------------------------------


def _check_stats(lens: torch.Tensor, n_def: torch.Tensor, masks) -> None:
    _build.check_cuda("rle_stats lens", lens, I32, 2)
    _build.check_cuda("rle_stats n_def", n_def, I32, 1)
    if n_def.shape[0] != lens.shape[0]:
        raise ValueError("rle_stats: n_def must have one entry per lane")
    if not 1 <= lens.shape[1] <= MAX_L:
        raise ValueError(f"rle_stats: rows of {lens.shape[1]} lengths, the kernel takes 1..{MAX_L}")
    if not 1 <= len(masks) <= MAX_MASKS or any(not 0 <= m < 32 for m in masks):
        raise ValueError(f"rle_stats: 1..{MAX_MASKS} masks in 0..31, got {list(masks)}")


def _launch_stats(lens, n_def, masks, te, out, mode: int) -> None:
    B, L = lens.shape
    if B:
        arr = (ctypes.c_int * len(masks))(*masks)
        _build.launch("zt_rle_stats", lens.data_ptr(), n_def.data_ptr(),
                      0 if te is None else te.data_ptr(), out.data_ptr(), B, L,
                      ctypes.addressof(arr), len(masks), mode)
        count_launch("rle_stats")


def rle_histogram_masks(lens: torch.Tensor, n_def: torch.Tensor, masks) -> torch.Tensor:
    """lens (B, L) int32, n_def (B,) int32, masks a sequence of M static
    CL masks -> (M * B, 19) int32 CL-symbol histograms of the RLE walk
    over each lane's first n_def lengths, mask-major. A CUDA tensor takes
    one ``rle_stats`` launch (histogram mode)."""
    masks = tuple(int(m) for m in masks)
    if lens.device.type == "cpu":
        return torch.cat([rle_histogram_plain(lens, n_def, m) for m in masks])
    _check_stats(lens, n_def, masks)
    out = torch.empty((len(masks) * lens.shape[0], NCODELENSYMS), dtype=I32, device=lens.device)
    _launch_stats(lens, n_def, masks, None, out, 0)
    return out


def rle_bits_masks(lens: torch.Tensor, n_def: torch.Tensor, te_lens: torch.Tensor,
                   masks) -> torch.Tensor:
    """lens (B, L), n_def (B,), te_lens (M * B, 19) int32 CL code lengths
    (row m * B + b for lane b under masks[m]) -> (M * B,) int32 bit sizes
    of the RLE-coded tables. A CUDA tensor takes one ``rle_stats`` launch
    (bits mode)."""
    masks = tuple(int(m) for m in masks)
    B = lens.shape[0]
    if te_lens.shape != (len(masks) * B, NCODELENSYMS):
        raise ValueError(f"rle_stats: te_lens of shape {tuple(te_lens.shape)}, expected "
                         f"({len(masks) * B}, {NCODELENSYMS})")
    if lens.device.type == "cpu":
        return torch.cat([rle_bits_plain(lens, n_def, te_lens[i * B:(i + 1) * B], m)
                          for i, m in enumerate(masks)])
    _check_stats(lens, n_def, masks)
    _build.check_cuda("rle_stats te_lens", te_lens, I32, 2)
    out = torch.empty(len(masks) * B, dtype=I32, device=lens.device)
    _launch_stats(lens, n_def, masks, te_lens, out, 1)
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


def rle_stats_model(lens: torch.Tensor, n_def: torch.Tensor, masks, te_lens=None):
    """The ``rle_stats`` kernel's schedule on CPU tensors, row by row ->
    (the (M * B, 19) histograms, or with ``te_lens`` the (M * B,) bit
    sizes, {counter: count} over ``STATS_COUNTERS``). Row m * B + b: lane
    b's run starts as ballot words over its first n_def lengths, each
    start's run ending at the next start or n_def, its counts in closed
    form (``_run_counts_scalar``), summed with int32 wrap-around."""
    B, L = lens.shape
    masks = [int(m) for m in masks]
    stats = dict.fromkeys(STATS_COUNTERS, 0)
    rows = lens.tolist()
    nd = n_def.tolist()
    te = None if te_lens is None else te_lens.tolist()
    out = []
    for m, mask in enumerate(masks):
        for b in range(B):
            stats["rows"] += 1
            row = rows[b]
            words = _start_words(row, nd[b])
            stats["words"] += len(words)
            hist = [0] * NCODELENSYMS
            for i in range(min(nd[b], L)):
                if not words[i // WARP] >> (i % WARP) & 1:
                    continue
                stats["runs"] += 1
                ns = _next_start(words, i)
                r = max((nd[b] if ns is None else min(ns, nd[b])) - i, 1)
                n16, n17, n18, lit_c, lit_v = _run_counts_scalar(row[i], r, mask)
                idx = min(max(lit_v, 0), 15)
                for k, v in ((idx, lit_c), (16, n16), (17, n17), (18, n18)):
                    hist[k] = _i32(hist[k] + v)
            if te is None:
                out.append(hist)
            else:
                t = te[m * B + b]
                bits = sum(hist[k] * t[k] for k in range(16))
                bits += hist[16] * (t[16] + 2) + hist[17] * (t[17] + 3) + hist[18] * (t[18] + 7)
                out.append(_i32(bits))
    shape = (len(masks) * B, NCODELENSYMS) if te is None else (len(masks) * B,)
    return torch.tensor(out, dtype=I32).view(shape), stats
