"""Many devices and many processes.

Port of zultra_tpu/parallel/__init__.py. Compression decomposes
data-parallel over windows: after its 32 KB history halo every window's
match finding and parse are independent. The JAX package lays its
devices out as a mesh of two axes, ``dp`` (windows) and ``sp`` (the bytes
of one window); the port takes a flat list of ``devices`` in their
place, a device free to appear more than once.

* ``compress_sharded``: one stream whose match stage (the staircase
  match finder, ``ops/staircase_torch.py``) is sharded over ``devices``,
  then planned with the port's planner on the first device and emitted
  in order. Its segments are window-major and cut into contiguous shares,
  so one window's segments may fall on two devices: the ``sp`` axis of
  compression proper, the JAX ("dp", "sp") flattening.
* ``sharded_corpus_stats``: per-window suffix arrays and final ranks,
  the corpus byte histogram (the byte-histogram kernel,
  ``ops/histogram_cuda.py``, once per device, summed) and Adler-32
  partial sums, with windows sharded over ``devices``. It keeps a flat
  list of devices for whole windows: none of its outputs depends on how a
  window's bytes are split (the JAX ``sp`` all-gather and psum,
  :48-79, gather the bytes back and sum them whole).
* ``compress_corpus``: independent streams compressed on host threads.
* ``multihost``: one stream planned across processes
  (``torch.distributed``), and independent members per process.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frame
from ..constants import HISTORY_SIZE
from ..device_pipeline import WINDOWS_PER_BATCH, emit_window_from_plan, plan_windows
from ..ops.block_torch import on_device, to_device
from ..ops.histogram_cuda import byte_histogram
from ..ops.matchfinder_torch import HALO, assemble_lanes, build_segments, window_geometry
from ..ops.staircase_torch import sharded_rows
from ..ops.suffix_torch import doubling_rounds
from ..stream import StreamError, clamp_block_size, memory_bound
from .multihost import window_spans


def _window_step(windows: torch.Tensor):
    """One device's windows (w, L) uint8: suffix arrays and final ranks
    (all ceil(log2 L) doubling rounds, as the JAX step runs them), the
    byte histogram of every byte, and the Adler partial sums per window
    (sum b, sum (L - i) * b), exact in int64."""
    sa, ranks, _ = doubling_rounds(windows.to(torch.int32))
    hist = byte_histogram(windows.reshape(-1))
    b = windows.to(torch.int64)
    weights = torch.arange(windows.shape[1], 0, -1, dtype=torch.int64, device=windows.device)
    return sa, ranks[-1], hist, b.sum(dim=1), (b * weights).sum(dim=1)


def sharded_corpus_stats(data: bytes, devices=("cuda",), window_bytes: int = 1 << 16) -> dict:
    """Cut a corpus into ``window_bytes`` windows (zero padded, their
    count rounded up to a multiple of ``len(devices)``, as the JAX form
    rounds to its ``dp`` axis), give each device a contiguous share, and
    return per-window suffix structures and corpus statistics (the
    counterpart of zultra_tpu.parallel.sharded_corpus_stats):

    ``suffix_arrays``, ``ranks`` (n_windows, window_bytes) int32 on the
    first device; ``corpus_histogram`` (256,) int64 over every window
    byte, padding included; ``adler_s1``, ``adler_s2`` (n_windows,) int64
    numpy; ``n_windows``. The JAX form sums s2 in int32, which wraps for
    windows above 4096 bytes; here it is exact."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("sharded_corpus_stats: no devices")
    arr = np.frombuffer(data, dtype=np.uint8)
    n_windows = max(1, -(-len(arr) // window_bytes))
    n_windows = -(-n_windows // len(devs)) * len(devs)
    padded = np.zeros(n_windows * window_bytes, dtype=np.uint8)
    padded[: len(arr)] = arr
    windows = torch.from_numpy(padded).view(n_windows, window_bytes)
    per = n_windows // len(devs)
    # Every device's work is queued before any result is read back.
    parts = [_window_step(windows[i * per : (i + 1) * per].to(d)) for i, d in enumerate(devs)]
    first = devs[0]
    return {
        "suffix_arrays": torch.cat([p[0].to(first) for p in parts]),
        "ranks": torch.cat([p[1].to(first) for p in parts]),
        "corpus_histogram": sum(p[2].cpu() for p in parts).numpy(),
        "adler_s1": torch.cat([p[3].cpu() for p in parts]).numpy(),
        "adler_s2": torch.cat([p[4].cpu() for p in parts]).numpy(),
        "n_windows": n_windows,
    }


def compress_sharded(data: bytes, devices=("cuda",), flags: int = 0, max_block_size: int = 0,
                     seg_core: int = 65536, budget_factor: int = 16,
                     dictionary: bytes | None = None) -> bytes:
    """Compress one stream with its match stage sharded over ``devices``
    (the counterpart of zultra_tpu.parallel.compress_sharded, :130): the
    corpus is cut into the stream's windows, each window into segments of
    ``seg_core`` positions with a 32 KB halo, and every segment runs the
    staircase match finder, the segments in contiguous shares a device
    (``staircase_torch.sharded_rows``). The windows are then planned on the
    first device with the port's planner, ``WINDOWS_PER_BATCH`` at a time
    (the JAX form plans on the host with the native planner), and emitted
    in order. A preset dictionary's last 32 KB act as history before the
    first window. The bytes equal zultra_tpu's ``compress_sharded`` and
    ``compress``."""
    mbs = clamp_block_size(max_block_size)
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    if not arr.size:
        raise StreamError("cannot finalize an empty stream")
    dict_tail = bytes(dictionary or b"")[-HISTORY_SIZE:]
    d = len(dict_tail)
    full = np.concatenate([np.frombuffer(dict_tail, np.uint8), arr]) if d else arr
    spans = [(lo + d, hi + d) for lo, hi in window_spans(len(arr), mbs)]

    segbufs, _ = build_segments(full, spans, seg_core)
    rows = sharded_rows(segbufs, devices, budget_factor, seg_core)
    dev = rows.device
    k = -(-mbs // seg_core)  # segments a window (all but the last window are mbs long)

    out = bytearray(frame.encode_header(flags, dict_tail if d else None))
    checksum = frame.update_checksum(frame.init_checksum(flags), arr, flags)
    buf = bytearray(memory_bound(mbs, flags, mbs))
    bits_data, bits_count = 0, 0
    for g in range(0, len(spans), WINDOWS_PER_BATCH):
        batch = spans[g : g + WINDOWS_PER_BATCH]
        W = len(batch)
        part = rows[g * k : (g + W) * k]
        if part.shape[0] < W * k:  # the last window's missing segments
            part = torch.cat([part, part.new_zeros((W * k - part.shape[0], *part.shape[1:]))])
        origin = batch[0][0] - min(HALO, batch[0][0])
        with on_device(dev):
            corpus_dev = to_device(full[origin : batch[-1][1]].copy(), dev)
            win_meta = to_device(window_geometry(batch, origin), dev)
            lens, offs, win = assemble_lanes(part, corpus_dev, win_meta, W, k, seg_core)
            n_lane = HALO + mbs
            handles = plan_windows(full, batch, mbs, lens[:, :n_lane], offs[:, :n_lane],
                                   win[:, :n_lane])
        for i, handle in enumerate(handles):
            n, bits_data, bits_count = emit_window_from_plan(
                handle, g + i + 1 == len(spans), buf, bits_data, bits_count)
            out += buf[:n]
    out += frame.encode_footer(flags, checksum, len(arr))
    return bytes(out)


def compress_corpus(blobs, flags=0, max_block_size: int = 0, workers: int | None = None,
                    device="cuda"):
    """Compress independent byte streams on host worker threads, each
    its own gzip/zlib member, all on ``device`` (multi-process setups
    shard the blob list by rank: ``multihost.shard_blobs``)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..stream import compress

    if workers is None:
        import os

        workers = os.cpu_count() or 2

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda b: compress(b, flags, max_block_size, device=device), blobs))
