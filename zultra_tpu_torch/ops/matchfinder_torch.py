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
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    LCP_SHIFT,
    MAX_MATCH_SIZE,
    MAX_OFFSET,
    MIN_MATCH_SIZE,
    NMATCHES_PER_OFFSET,
)

from ..matchfinder import find_all_matches
from .suffix_torch import adjacent_lcp, doubling_rounds
from .walk_cuda import walk_segments

HALO = MAX_OFFSET  # 32768 history bytes make segment rows exact
TAIL = MAX_MATCH_SIZE  # 258 lookahead bytes make clamped lengths exact
SEG_CORE = 32768


def build_segments(data: np.ndarray, spans, seg_core: int):
    """Cut the corpus into per-window segments with the uniform layout
    (copy of zultra_tpu.ops.matchfinder_jax.build_segments, which is
    numpy-only but lives in a module that imports jax).

    Returns (segbufs (S, L) int32, metas) with L = HALO + seg_core + TAIL
    and metas[s] = (window_index, core_lo_abs, core_len)."""
    L = HALO + seg_core + TAIL
    bufs = []
    metas = []
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = min(HALO, w_lo)
        buf_start_abs = w_lo - prev
        core = w_lo
        while core < w_hi:
            core_hi = min(core + seg_core, w_hi)
            lo = max(core - HALO, buf_start_abs)
            hi = min(core_hi + TAIL, w_hi)  # lcps clamp at the window end
            buf = 256 + np.arange(L, dtype=np.int32)
            dst = HALO - (core - lo)
            buf[dst : dst + (hi - lo)] = data[lo:hi]
            bufs.append(buf)
            metas.append((w, core, core_hi - core))
            core = core_hi
    return np.stack(bufs), metas


def salcp_batch(bufs: torch.Tensor) -> torch.Tensor:
    """SA | clamped adjacent LCP << LCP_SHIFT in rank order, per segment
    (the walk's input). LCPs clamp at MAX_MATCH_SIZE, so rank tables up
    to 256-grams suffice (256 + 128 + ... + 1 >= 258)."""
    sa, ranks = doubling_rounds(bufs, store_levels=8)
    raw = adjacent_lcp(sa, ranks)
    clamped = torch.where(raw < MIN_MATCH_SIZE, 0, torch.clamp(raw, max=MAX_MATCH_SIZE))
    lcp_at_rank = torch.cat([torch.zeros_like(clamped[:, :1]), clamped], dim=1)
    return sa | (lcp_at_rank << LCP_SHIFT)


def match_tables_device_stacked(corpus: np.ndarray, spans, mbs: int, device):
    """Match tables for a batch of window spans in the stacked lane
    layout: (lens, offs), each (W, HALO + mbs, 8) int32 on ``device``.
    Lane w's rows [HALO, HALO + in_size_w) are window w's input
    positions; every other row is zero. Every span but the last must be
    exactly ``mbs`` long."""
    corpus = np.asarray(corpus, dtype=np.uint8)
    W = len(spans)
    for w_lo, w_hi in spans[:-1]:
        if w_hi - w_lo != mbs:
            raise ValueError("only the last span may be partial")
    k = -(-mbs // SEG_CORE)
    segbufs, _ = build_segments(corpus, spans, SEG_CORE)
    S = segbufs.shape[0]
    bufs = torch.from_numpy(segbufs).to(device)
    rows = walk_segments(salcp_batch(bufs), HALO, SEG_CORE)  # (S, SEG_CORE, 8)
    if W * k > S:  # the last window's missing segments
        rows = torch.cat([rows, rows.new_zeros((W * k - S, SEG_CORE, NMATCHES_PER_OFFSET))])
    rows = rows.reshape(W, k * SEG_CORE, NMATCHES_PER_OFFSET)[:, :mbs]
    in_sizes = torch.tensor([hi - lo for lo, hi in spans], dtype=torch.int32, device=device)
    live = torch.arange(mbs, dtype=torch.int32, device=device)[None, :, None] < in_sizes[:, None, None]
    rows = torch.where(live, rows, 0)
    rows = torch.cat([rows.new_zeros((W, HALO, NMATCHES_PER_OFFSET)), rows], dim=1)
    return rows >> 16, rows & 0xFFFF


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
