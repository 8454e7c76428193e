"""The staircase match finder: every position's match rows from
device-wide sorts and scans, with no sequential interval walk; and the
per-window match tables of a stream's window spans
(``match_tables_for_spans``), from the walk on one device or from the
staircase sharded over a list of devices.

Port of zultra_tpu/ops/matchfinder_jax.py: ``_staircase_kernel`` (:216),
``_core_kernel`` (:351), ``_chunk_kernel`` (:360), ``_sharded_chunk_fn``
(:371), ``match_tables_for_spans`` (:431), ``FALLBACK_STATS`` (:553).

The rows are the staircase of previous occurrences: scanning j = p - 1
down, every j whose clamped lcp(p, j) strictly exceeds all nearer lcps
(longest first, at most 8, offsets at most 32768). Per ancestor
LCP-interval I of p's suffix, that is the within-interval predecessor
max{j in members(I), j < p}; the rows are where it strictly increases.
The walk (``walk_cuda``) gives the same rows. Steps, all batched over
the segments:

1. suffix array and rank tables up to 256-grams (``suffix_torch``);
2. adjacent LCPs, clamped to 0 below 3 and to 258;
3. interval nodes: each boundary t with L[t] >= 3 names the interval of
   value L[t] around it; its rank range [a, b) comes from two descents of
   a zero-padded sparse-min table of L (``nsv_torch``); boundaries naming
   the same interval (a, v) are deduplicated by a sort;
4. memberships: each node expands to its rank range (an exclusive cumsum
   of the sizes gives the offsets, node ids go in at the starts, a
   running max fills forward), at most ``budget_factor * n`` of them;
5. within-interval predecessors from one sort by (interval, position);
6. a stable sort by (position, value descending), a segmented running
   count, and one scatter of the rows.

A segment whose memberships overflow the budget (long single-byte runs)
reports no rows and an ``overflow`` flag; ``match_tables_for_spans``
walks those segments with the walk kernel on the same device. That is
the JAX package's own algorithmic fallback (its host walk, :535), not a
device fallback: a CUDA tensor never takes a CPU path here.

On the card ``staircase_segments`` runs as one program of
``ops/programs.py`` per (S, n, budget, core) shape, the counterpart of the
JAX package's jitted ``_chunk_kernel``: no host sync inside, the overflow
flags read back once after the replay. Its form there too is torch ops:
it replaces an XLA program, not a Pallas kernel.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..constants import MAX_MATCH_SIZE, MAX_OFFSET, MIN_MATCH_SIZE, NMATCHES_PER_OFFSET
from . import programs
from .block_torch import on_device, to_device, to_host
from .matchfinder_torch import HALO, SEG_CORE, build_segments, salcp_batch
from .nsv_torch import build_sparse_min, find_left, find_right
from .suffix_torch import adjacent_lcp, doubling_rounds, doubling_rounds_fixed
from .walk_cuda import walk_segments

STAIRCASE_CORE = 65536  # core positions a staircase segment, unless the caller picks
# Segments one staircase program holds: every call has this many (the
# last of a device's share padded with segments of sentinels alone), so a
# core size makes one graph whatever the input. About 16 n memberships a
# segment (the budget), each some 60 bytes of transient tensors at the
# peak: 8 segments of 98,562 positions take some 0.8 GB.
PROGRAM_SEGMENTS = 8
WALK_SEGMENTS = 128  # segments one walk call takes on the local path
KEY_NONE = 1 << 30  # the sort key of an unused slot, above every real key

I32 = torch.int32
I64 = torch.int64

# Segments the staircase ran, and those whose membership budget overflowed
# (walked instead). Device threads share it: add under ``_stats_lock``.
FALLBACK_STATS = {"segments": 0, "overflowed": 0}
_stats_lock = threading.Lock()


def _shift_in(x: torch.Tensor, first) -> torch.Tensor:
    """x shifted one place right along dim 1, ``first`` in column 0."""
    return torch.cat([torch.full_like(x[:, :1], first), x[:, :-1]], dim=1)


def _staircase_rows(bufs: torch.Tensor, budget_factor: int):
    """Packed rows (S, n, 8) int32, len << 16 | off, and overflow (S,)
    bool for (S, n) int32 buffers of bytes and unique sentinels >= 256."""
    S, n = bufs.shape
    dev = bufs.device
    rounds = doubling_rounds_fixed if bufs.is_cuda else doubling_rounds
    sa, ranks, _ = rounds(bufs.to(I32), store_levels=8)  # LCPs clamp at 258 <= 256 + 128 + ... + 1
    pos = sa  # pos[r] = position of rank r

    # L[r] = clamped lcp of ranks r - 1 and r; L[0] = L[n] = 0.
    raw = adjacent_lcp(sa, ranks)
    clamped = torch.where(raw < MIN_MATCH_SIZE, 0, torch.clamp(raw, max=MAX_MATCH_SIZE))
    zero = clamped.new_zeros((S, 1))
    L = torch.cat([zero, clamped, zero], dim=1)  # (S, n + 1)
    lev = max(1, n.bit_length())  # ceil(log2(n + 1)): the table covers L's n + 1 entries
    pad = 1 << lev
    padded = torch.cat([clamped.new_zeros((S, pad)), L, clamped.new_zeros((S, pad))], dim=1)
    st = build_sparse_min(padded, lev)

    # Interval nodes: one candidate a boundary t with L[t] >= 3.
    t_idx = torch.arange(n, dtype=I32, device=dev).expand(S, n)
    v_t = L[:, :n]
    valid_t = v_t > 0
    thresh = torch.clamp(v_t, min=1)
    a_t = find_left(st, lev, pad, torch.clamp(t_idx - 1, min=0), thresh)
    b_t = find_right(st, lev, pad, t_idx + 1, thresh)
    del st

    # Dedupe boundaries naming one interval (equal-L runs): lax.sort((key_t,
    # t_idx), num_keys=2) is lexicographic; key_t <= 2^30 and t < 2^30, so
    # one int64 key key_t << 30 | t sorts the same.
    key_t = torch.where(valid_t, a_t * 512 + v_t, KEY_NONE)
    both = torch.sort((key_t.to(I64) << 30) | t_idx, dim=1).values
    key_sorted, t_sorted = both >> 30, both & ((1 << 30) - 1)
    first = torch.cat([torch.ones_like(valid_t[:, :1]), key_sorted[:, 1:] != key_sorted[:, :-1]],
                      dim=1) & (key_sorted < KEY_NONE)
    is_node = torch.zeros_like(valid_t).scatter(1, t_sorted, first)

    # Exclusive offsets of each node's memberships. JAX cumsums int32;
    # int64 here is exact, and so is ``total > cap``.
    sizes = torch.where(is_node, b_t - a_t, 0).to(I64)
    cum = torch.cumsum(sizes, dim=1) - sizes
    total = cum[:, -1] + sizes[:, -1]
    cap = budget_factor * n
    overflow = total > cap

    # Expand memberships: node ids at their starts, forward filled.
    # ``.at[starts].max(..., mode="drop")`` drops index cap; torch has no
    # drop mode, so the target has one spare slot, cut off after.
    arange_cap = torch.arange(cap, dtype=I64, device=dev)
    starts = torch.where(is_node & (sizes > 0) & ~overflow[:, None], cum, cap)
    node_at = torch.full((S, cap + 1), -1, dtype=I32, device=dev).scatter_reduce(
        1, starts, t_idx, "amax")[:, :cap]
    mem_node = torch.cummax(node_at, dim=1).values  # lax.cummax; node ids ascend with offsets
    in_use = (arange_cap < total[:, None]) & (mem_node >= 0) & ~overflow[:, None]
    run_start = torch.cummax(torch.where(node_at >= 0, arange_cap, 0), dim=1).values
    del node_at
    pav = a_t * 512 + v_t  # a_t < n < 2^21, v_t <= 258 < 2^9
    pav_e = torch.gather(pav, 1, torch.clamp(mem_node, min=0).to(I64))
    rank_e = (pav_e >> 9) + (arange_cap - run_start)
    del run_start
    pos_e = torch.gather(pos, 1, torch.clamp(rank_e, 0, n - 1))
    del rank_e
    val_e = pav_e & 511

    # Sort 1 by (interval, position): each entry's predecessor is its sorted
    # neighbour. lax.sort((key1, pv), num_keys=2) is lexicographic; key1 <=
    # 2^30 and pv <= 2^30 < 2^31, so one int64 key key1 << 31 | pv.
    key1 = torch.where(in_use, mem_node, KEY_NONE)
    pv = torch.where(in_use, pos_e * 512 + (511 - val_e), KEY_NONE)
    del mem_node, pos_e, val_e, pav_e, in_use
    both = torch.sort((key1.to(I64) << 31) | pv, dim=1).values
    del key1, pv
    k_sorted, pv_sorted = both >> 31, both & ((1 << 31) - 1)
    del both
    prev_same = torch.cat([torch.zeros_like(k_sorted[:, :1], dtype=torch.bool),
                           k_sorted[:, 1:] == k_sorted[:, :-1]], dim=1)
    pred = torch.where(prev_same & (k_sorted < KEY_NONE), _shift_in(pv_sorted >> 9, -1), -1)
    del k_sorted, prev_same

    # Sort 2 by position, value descending: lax.sort((pv_sorted, pred),
    # num_keys=1) is stable on pv alone, so a stable sort and a gather.
    pv2, order = torch.sort(pv_sorted, dim=1, stable=True)
    del pv_sorted
    pred2 = torch.gather(pred, 1, order)
    del pred, order
    p2 = pv2 >> 9
    val2 = 511 - (pv2 & 511)

    # Emit where pred strictly exceeds every deeper pred of the chain
    # (predecessors only grow along a chain, so the previous one is the
    # running max); append (at most 8 rows) where the offset fits.
    same_pos = torch.cat([torch.zeros_like(p2[:, :1], dtype=torch.bool),
                          p2[:, 1:] == p2[:, :-1]], dim=1)
    last = torch.where(same_pos, _shift_in(pred2, -1), -1)
    emit = (pred2 > last) & (pred2 >= 0) & (pv2 < KEY_NONE)
    offs = p2 - pred2
    append = emit & (offs <= MAX_OFFSET)

    # Segmented running count of appended rows: the exclusive count at each
    # position's first entry only grows, so a running max fills it forward.
    app_i = append.to(I64)
    csum = torch.cumsum(app_i, dim=1)
    base = torch.cummax(torch.where(~same_pos, csum - app_i, 0), dim=1).values
    row = csum - base - 1  # 0-based slot among the appended rows
    write = append & (row < NMATCHES_PER_OFFSET)
    # ``.at[flat].set(..., mode="drop")``: index n * 8 is the spare slot.
    flat = torch.where(write, p2 * NMATCHES_PER_OFFSET + row, n * NMATCHES_PER_OFFSET)
    packed = torch.zeros((S, n * NMATCHES_PER_OFFSET + 1), dtype=I32, device=dev).scatter(
        1, flat, ((val2 << 16) | offs).to(I32))
    return packed[:, : n * NMATCHES_PER_OFFSET].reshape(S, n, NMATCHES_PER_OFFSET), overflow


def staircase_program(bufs: torch.Tensor, *, budget_factor: int, core_off: int, core_len: int):
    """The rows of the core positions [core_off, core_off + core_len) of
    every segment, packed len << 16 | off, (S, core_len, 8) int32, and
    the overflow flags (S,) bool: the function ``programs.run`` captures
    (zultra_tpu's ``_core_kernel``, vmapped)."""
    rows, overflow = _staircase_rows(bufs, budget_factor)
    return rows[:, core_off : core_off + core_len].contiguous(), overflow


def staircase_segments(bufs: torch.Tensor, budget_factor: int, core_off: int, core_len: int):
    """(S, n) int32 segment buffers (bytes and unique sentinels >= 256)
    -> lens, offs (S, core_len, 8) int32 of the core positions [core_off,
    core_off + core_len), and overflow (S,) bool: segments whose
    memberships passed ``budget_factor * n`` report no rows. A graph
    replay on the card once its shape has come twice."""
    rows, overflow = programs.run(staircase_program, bufs, budget_factor=budget_factor,
                                  core_off=core_off, core_len=core_len)
    return rows >> 16, rows & 0xFFFF, overflow


def _device_rows(bufs: np.ndarray, device: torch.device, budget_factor: int,
                 seg_core: int) -> torch.Tensor:
    """One device's share of the segments, (S, L) int32 on the host ->
    packed rows (S, seg_core, 8) on ``device``: programs of
    PROGRAM_SEGMENTS segments (the last padded with segments of sentinels
    alone), then one wait for the overflow flags, then the walk over the
    segments that overflowed."""
    S, L = bufs.shape
    batch = PROGRAM_SEGMENTS
    calls = -(-S // batch)
    host = np.tile(256 + np.arange(L, dtype=np.int32), (calls * batch, 1))
    host[:S] = bufs
    dev_bufs = to_device(host, device)
    rows, overflow = [], []
    for i in range(calls):
        r, o = programs.run(staircase_program, dev_bufs[i * batch : (i + 1) * batch],
                            budget_factor=budget_factor, core_off=HALO, core_len=seg_core)
        rows.append(r)
        overflow.append(o)
    rows = torch.cat(rows)[:S]
    [over] = to_host(torch.cat(overflow)[:S])
    hit = np.flatnonzero(over)
    if hit.size:
        idx = torch.from_numpy(hit).to(device)
        rows[idx] = walk_segments(salcp_batch(dev_bufs[idx]), HALO, seg_core)
    with _stats_lock:
        FALLBACK_STATS["segments"] += S
        FALLBACK_STATS["overflowed"] += int(hit.size)
    return rows


def sharded_rows(segbufs: np.ndarray, devices, budget_factor: int = 16,
                 seg_core: int = STAIRCASE_CORE) -> torch.Tensor:
    """Packed staircase rows (S, seg_core, 8) int32 of window-major
    segment buffers (S, HALO + seg_core + TAIL), on the first device.

    The segments are cut into ``len(devices)`` contiguous shares, each
    run on its own device from a host thread of its own, as
    ``compress_device(devices=)`` runs its batches: a flat list, so one
    window's segments may fall on two devices (the JAX package's ("dp",
    "sp") flattening, ``_sharded_chunk_fn``). A device may appear twice.
    Each share runs in programs of PROGRAM_SEGMENTS segments."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("sharded_rows: no devices")
    S = segbufs.shape[0]
    per = max(1, -(-S // len(devs)))
    shares = [(d, segbufs[i * per : (i + 1) * per]) for i, d in enumerate(devs)
              if i * per < S]

    def run(share):
        d, bufs = share
        with on_device(d):
            return _device_rows(bufs, d, budget_factor, seg_core)

    if len(shares) > 1:
        with ThreadPoolExecutor(len(shares)) as pool:
            parts = list(pool.map(run, shares))
    else:
        parts = [run(s) for s in shares]
    if not parts:
        return torch.zeros((0, seg_core, NMATCHES_PER_OFFSET), dtype=I32, device=devs[0])
    return torch.cat([p.to(devs[0]) for p in parts])


def walk_rows(segbufs: np.ndarray, device, seg_core: int = SEG_CORE) -> torch.Tensor:
    """Packed walk rows (S, seg_core, 8) int32 of segment buffers on
    ``device``, WALK_SEGMENTS segments a call."""
    dev = torch.device(device)
    parts = [walk_segments(salcp_batch(to_device(segbufs[i : i + WALK_SEGMENTS], dev)),
                           HALO, seg_core)
             for i in range(0, segbufs.shape[0], WALK_SEGMENTS)]
    with _stats_lock:
        FALLBACK_STATS["segments"] += segbufs.shape[0]
    if not parts:
        return torch.zeros((0, seg_core, NMATCHES_PER_OFFSET), dtype=I32, device=dev)
    return torch.cat(parts)


def match_tables_for_spans(data: np.ndarray, spans, seg_core: int | None = None,
                           budget_factor: int = 16, devices=None, device="cuda") -> list:
    """Per-window match tables of a stream's window spans: one (prev +
    in_size, 8, 2) int32 numpy table per window, prev = min(HALO, lo),
    rows [0, prev) zero (the JAX package's ``match_tables_for_spans``).

    ``devices=None`` runs the walk on ``device``, the port's local match
    path (the JAX local path's counterpart); ``seg_core`` defaults to the
    walk's SEG_CORE. A list of ``devices`` runs the staircase sharded over
    them (``sharded_rows``; the mesh path's counterpart); ``seg_core``
    defaults to STAIRCASE_CORE. Matches reach up to 32 KB back into the
    previous window, never before a window's own history, and lengths
    clamp at the window's end; the cut into segments changes no row."""
    data = np.asarray(data, dtype=np.uint8)
    if seg_core is None:
        seg_core = SEG_CORE if devices is None else STAIRCASE_CORE
    segbufs, metas = build_segments(data, spans, seg_core)
    if devices is None:
        rows = walk_rows(segbufs, device, seg_core)
    else:
        rows = sharded_rows(segbufs, devices, budget_factor, seg_core)
    [rows] = to_host(rows)
    tables = [np.zeros((min(HALO, lo) + hi - lo, NMATCHES_PER_OFFSET, 2), dtype=np.int32)
              for lo, hi in spans]
    for s, (w, core_abs, core_len) in enumerate(metas):
        w_lo = spans[w][0]
        rel = core_abs - w_lo + min(HALO, w_lo)  # row index inside the window buffer
        tables[w][rel : rel + core_len, :, 0] = rows[s, :core_len] >> 16
        tables[w][rel : rel + core_len, :, 1] = rows[s, :core_len] & 0xFFFF
    return tables
