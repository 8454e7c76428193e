"""Match tables for a batch of windows: segments -> suffix array + LCP
-> the lazy-walk kernel -> (W, HALO + mbs, 8) lengths and offsets; and
the per-window tables (``match_table_device``, ``match_table``).

Port of the local (no mesh) path of
zultra_tpu.ops.matchfinder_jax.match_tables_device_stacked, and of its
per-window forms ``match_table_device`` (:556) and ``match_table_jax``
(:734). Windows are
cut into segments [32 KB history halo | core | 258-byte tail], padded
with unique sentinels (>= 256). The cut is exact for any core size: a
reported row (len, off) with off <= 32768 depends only on candidates in
(p - 32768, p), and clamped lengths need 258 bytes of lookahead.

Segment geometry: SEG_CORE = 32768 core positions, so a segment buffer
is HALO + 32768 + TAIL = 65794 words and its walk tables (2n+2 int32)
take about 0.5 MB of global memory. The JAX package sized its segments
to fit a TPU core's scalar memory; here the tables live in global memory
whatever the size, and a 32 KiB core (one segment per 32 KiB of input,
half of each walk spent warming the halo) trades halo overhead for more
segments walking in parallel. Every legal block size is a multiple of
32 KiB up to the last partial window.

Where the segments are built. The host computes only their geometry
(``segment_geometry``: where each segment's bytes lie in the batch's
corpus slice and where they land in the segment) and the window lanes'
(``window_geometry``), and copies the slice to the device once
(``upload_batch``). The device builds the segments from it
(``segments_from_corpus``: one gather and one select) and the lanes'
window bytes from the same copy. ``match_program``, segments to lanes,
is one program of ``ops/programs.py`` (a CUDA graph a batch shape on the
card, the counterpart of the JAX package's jitted ``_salcp_batch``, walk,
``_extract_batch`` and ``_assemble_stacked``). Its shapes depend on the
window count W and k = ceil(mbs / SEG_CORE) alone: the slice is padded
to HALO + W*k*SEG_CORE + TAIL bytes and the segments to W*k (all
sentinels), so a shorter last window or a preset dictionary changes the
geometry's values and not the program. ``build_segments`` is the plain
numpy form of the segments.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    HISTORY_SIZE,
    LCP_SHIFT,
    MAX_MATCH_SIZE,
    MAX_OFFSET,
    MIN_MATCH_SIZE,
    NMATCHES_PER_OFFSET,
)

from .. import profiling
from ..matchfinder import find_all_matches
from . import programs
from .block_torch import to_device
from .suffix_torch import adjacent_lcp, doubling_rounds, doubling_rounds_fixed, num_levels
from .walk_cuda import walk_segments

HALO = MAX_OFFSET  # 32768 history bytes make segment rows exact
TAIL = MAX_MATCH_SIZE  # 258 lookahead bytes make clamped lengths exact
SEG_CORE = 32768
SEG_LEN = HALO + SEG_CORE + TAIL


def segment_geometry(spans, seg_core: int = SEG_CORE, origin: int = 0):
    """The host half of the segment cut (zultra_tpu.ops.matchfinder_jax.
    build_segments). -> (geometry (S, 3) int32, metas): segment s takes
    ``count`` corpus bytes from ``src_lo`` (relative to ``origin``) into
    its positions ``dst`` on, and metas[s] = (window_index, core_lo_abs,
    core_len). Matches reach up to 32 KB back into the previous window,
    never before the window's own history, and LCPs clamp at the window's
    end."""
    geom = []
    metas = []
    for w, (w_lo, w_hi) in enumerate(spans):
        buf_start_abs = w_lo - min(HALO, w_lo)
        core = w_lo
        while core < w_hi:
            core_hi = min(core + seg_core, w_hi)
            lo = max(core - HALO, buf_start_abs)
            hi = min(core_hi + TAIL, w_hi)
            geom.append((lo - origin, HALO - (core - lo), hi - lo))
            metas.append((w, core, core_hi - core))
            core = core_hi
    return np.array(geom, np.int32).reshape(-1, 3), metas


def window_geometry(spans, origin: int = 0) -> np.ndarray:
    """The window lanes' rows in the ``segment_geometry`` form: lane w
    holds its history (at most HISTORY_SIZE bytes) just below HALO and its
    input from HALO, zeros elsewhere. (W, 3) int32."""
    rows = []
    for w_lo, w_hi in spans:
        prev = min(HISTORY_SIZE, w_lo)
        rows.append((w_lo - prev - origin, HALO - prev, prev + w_hi - w_lo))
    return np.array(rows, np.int32).reshape(-1, 3)


def build_segments(data: np.ndarray, spans, seg_core: int):
    """The segments on the host, the plain form of ``segments_from_corpus``
    (zultra_tpu.ops.matchfinder_jax.build_segments). -> (segbufs (S, L)
    int32, metas) with L = HALO + seg_core + TAIL."""
    geom, metas = segment_geometry(spans, seg_core)
    bufs = np.tile(256 + np.arange(HALO + seg_core + TAIL, dtype=np.int32), (len(geom), 1))
    for buf, (src_lo, dst, count) in zip(bufs, geom):
        buf[dst : dst + count] = data[src_lo : src_lo + count]
    return bufs, metas


def upload_batch(corpus: np.ndarray, spans, mbs: int, device):
    """A batch's one copy to ``device``: its corpus slice, from the first
    window's history to the last window's end, padded with zeros to HALO
    + W*k*SEG_CORE + TAIL bytes, and the geometry rows, W*k segments (the
    missing ones all sentinels: count 0) then W windows.
    -> (corpus_dev (HALO + W*k*SEG_CORE + TAIL,) uint8, meta (W*k + W, 3)
    int32, W, k)."""
    W = len(spans)
    k = -(-mbs // SEG_CORE)
    if W == 0 or any(hi - lo != mbs for lo, hi in spans[:-1]) \
            or not 0 < spans[-1][1] - spans[-1][0] <= mbs:
        raise ValueError("need spans of mbs bytes, the last one of at most mbs")
    origin = spans[0][0] - min(HALO, spans[0][0])
    size = HALO + W * k * SEG_CORE + TAIL
    if spans[-1][1] - origin > size:
        raise ValueError("the spans of a batch must follow one another")
    with profiling.span("zultra.upload"):
        buf = np.zeros(size, np.uint8)
        buf[: spans[-1][1] - origin] = corpus[origin : spans[-1][1]]
        seg, _ = segment_geometry(spans, SEG_CORE, origin)
        meta = np.zeros((W * k + W, 3), np.int32)
        meta[: len(seg)] = seg
        meta[W * k :] = window_geometry(spans, origin)
        return to_device(buf, device), to_device(meta, device), W, k


def _gather(corpus_dev: torch.Tensor, geom: torch.Tensor, width: int):
    """Rows of ``width`` positions filled from the corpus by their geometry
    rows: -> (bytes (R, width) uint8, inside (R, width) bool), bytes 0
    outside [dst, dst + count)."""
    j = torch.arange(width, dtype=torch.int32, device=corpus_dev.device)[None, :]
    rel = j - geom[:, 1:2]
    inside = (rel >= 0) & (rel < geom[:, 2:3])
    idx = torch.where(inside, geom[:, 0:1] + rel, 0)
    return torch.where(inside, corpus_dev[idx.to(torch.int64)], 0), inside


def segments_from_corpus(corpus_dev: torch.Tensor, seg_meta: torch.Tensor,
                         L: int) -> torch.Tensor:
    """The segment buffers (S, L) int32 on the device, equal to
    ``build_segments``: corpus bytes where a segment's geometry row puts
    them, the unique sentinel 256 + j at every other position j."""
    data, inside = _gather(corpus_dev, seg_meta, L)
    sentinel = 256 + torch.arange(L, dtype=torch.int32, device=corpus_dev.device)
    return torch.where(inside, data.to(torch.int32), sentinel[None, :])


def salcp_batch(bufs: torch.Tensor) -> torch.Tensor:
    """SA | clamped adjacent LCP << LCP_SHIFT in rank order, per segment:
    the walk's input (``salcp_rounds`` without its count)."""
    return salcp_rounds(bufs)[0]


def salcp_rounds(bufs: torch.Tensor):
    """SA | clamped adjacent LCP << LCP_SHIFT in rank order, per segment
    (the walk's input), and the doubling rounds each segment ran (S,)
    int32. LCPs clamp at MAX_MATCH_SIZE, so rank tables up to 256-grams
    suffice (256 + 128 + ... + 1 >= 258). On the card the doubling launches
    its fixed count of rounds (no host sync: a graph holds it), and a
    segment whose ranks are distinct skips the rest; on the CPU it stops
    once every rank is distinct. Both give the same words and counts."""
    rounds = doubling_rounds_fixed if bufs.is_cuda else doubling_rounds
    sa, ranks, run = rounds(bufs, store_levels=8)
    raw = adjacent_lcp(sa, ranks)
    clamped = torch.where(raw < MIN_MATCH_SIZE, 0, torch.clamp(raw, max=MAX_MATCH_SIZE))
    lcp_at_rank = torch.cat([torch.zeros_like(clamped[:, :1]), clamped], dim=1)
    return sa | (lcp_at_rank << LCP_SHIFT), run


def assemble_lanes(rows: torch.Tensor, corpus_dev: torch.Tensor, win_meta: torch.Tensor,
                   W: int, k: int, seg_core: int = SEG_CORE):
    """(W*k, seg_core, 8) packed rows -> lens, offs (W, HALO + k*seg_core,
    8) int32 and the window bytes (W, HALO + k*seg_core) uint8, the stacked
    lane layout (zultra_tpu.ops.matchfinder_jax._assemble_stacked and the
    window stack of zultra_tpu.device_pipeline._begin_windows_batched).
    Segment cores tile each window, so a lane's rows are a reshape; rows
    past the window's input and the HALO rows below it are zero."""
    n_core = k * seg_core
    win, _ = _gather(corpus_dev, win_meta, HALO + n_core)
    in_sizes = win_meta[:, 2] - (HALO - win_meta[:, 1])  # count - prev
    rows = rows.reshape(W, n_core, NMATCHES_PER_OFFSET)
    live = torch.arange(n_core, dtype=torch.int32, device=rows.device)[None, :, None] \
        < in_sizes[:, None, None]
    rows = torch.where(live, rows, 0)
    rows = torch.cat([rows.new_zeros((W, HALO, NMATCHES_PER_OFFSET)), rows], dim=1)
    return rows >> 16, rows & 0xFFFF, win


def match_program(corpus_dev: torch.Tensor, meta: torch.Tensor, *, W: int, k: int):
    """A batch's whole match stage on the device, from ``upload_batch``'s
    copy: segments, suffix arrays and rank tables (8 stored levels),
    adjacent LCPs, the walk kernel, the lanes. -> (lens, offs, win) as
    ``assemble_lanes`` gives them, lanes HALO + k*SEG_CORE wide, and the
    doubling rounds each of the W*k segments ran (W*k,) int32."""
    bufs = segments_from_corpus(corpus_dev, meta[: W * k], SEG_LEN)
    salcp, run = salcp_rounds(bufs)
    rows = walk_segments(salcp, HALO, SEG_CORE)  # (W*k, SEG_CORE, 8)
    return (*assemble_lanes(rows, corpus_dev, meta[W * k :], W, k), run)


def match_stacks(corpus: np.ndarray, spans, mbs: int, device):
    """The match tables and window bytes of a batch of window spans in the
    stacked lane layout: (lens, offs) each (W, HALO + mbs, 8) int32 and
    win (W, HALO + mbs) uint8 on ``device``. Lane w's rows [HALO, HALO +
    in_size_w) are window w's input positions, and its bytes from HALO -
    min(HISTORY_SIZE, lo_w) to HALO + in_size_w its history and input;
    every other row and byte is zero. Every span but the last must be
    exactly ``mbs`` long, and the spans must follow one another. One copy
    to the device, then ``match_program`` (a graph replay on the card
    once its shape has come twice). While tracing is on it counts the
    doubling rounds the program launches for its segments
    (``match.rounds``) and keeps the tensor of rounds they ran, which
    ``profiling.report`` sums into ``match.rounds_run``."""
    with profiling.span("zultra.match"):
        corpus_dev, meta, W, k = upload_batch(np.asarray(corpus, dtype=np.uint8), spans, mbs,
                                              device)
        lens, offs, win, run = programs.run(match_program, corpus_dev, meta, W=W, k=k)
    if profiling.enabled():
        profiling.count("match.positions", W * k * SEG_CORE)
        profiling.count("match.input", sum(hi - lo for lo, hi in spans))
        profiling.count("match.rounds", W * k * num_levels(SEG_LEN))
        profiling.keep("match.rounds_run", run)
    n_lane = HALO + mbs
    return lens[:, :n_lane], offs[:, :n_lane], win[:, :n_lane]


def match_tables_device_stacked(corpus: np.ndarray, spans, mbs: int, device):
    """Match tables for a batch of window spans in the stacked lane
    layout: (lens, offs), each (W, HALO + mbs, 8) int32 on ``device``, as
    ``match_stacks`` gives them."""
    lens, offs, _ = match_stacks(corpus, spans, mbs, device)
    return lens, offs


def match_table_device(window: np.ndarray, start: int, end: int, device="cuda"):
    """One window's match table on ``device``: (lens, offs), each (end, 8)
    int32, rows [0, start) zero. ``window[:start]`` is history (at most
    its last HALO bytes are used, as in the JAX form), ``window[start:end]``
    the input. A one-window batch of ``match_tables_device_stacked``."""
    window = np.asarray(window, dtype=np.uint8)
    if not 0 <= start < end <= window.shape[0]:
        raise ValueError(f"match_table_device: need 0 <= start < end <= {window.shape[0]}, "
                         f"got {start}, {end}")
    lens, offs = match_tables_device_stacked(window[:end], [(start, end)], end - start,
                                             torch.device(device))
    head = lens.new_zeros((start, NMATCHES_PER_OFFSET))
    return torch.cat([head, lens[0, HALO:]]), torch.cat([head, offs[0, HALO:]])


def match_table(window: np.ndarray, start: int, end: int, device="cuda") -> np.ndarray:
    """One window's match table on the host: (end, 8, 2) int32 of
    (length, offset), equal to ``matchfinder.find_all_matches``. With
    more history than a match can reach (start > HALO, which the
    streaming core never makes) the host walk runs it, as the JAX form
    does (matchfinder_jax._host_walk)."""
    window = np.asarray(window, dtype=np.uint8)
    if start > HALO:
        return find_all_matches(window[:end].copy(), start, end)
    lens, offs = match_table_device(window, start, end, device)
    return torch.stack([lens, offs], dim=2).cpu().numpy().astype(np.int32)
