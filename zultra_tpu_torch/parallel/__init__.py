"""Many devices and many processes.

Port of zultra_tpu/parallel/__init__.py. Compression decomposes
data-parallel over windows: after its 32 KB history halo every window's
match finding and parse are independent. The JAX package shards windows
over a mesh axis ``dp`` and, on ``sp``, the bytes of one window across
TPU chips; the port takes a list of ``devices`` for the windows and has
no ``sp``: splitting one window's bytes across cards changes none of the
results, and a window fits one card.

* ``sharded_corpus_stats``: per-window suffix arrays and final ranks,
  the corpus byte histogram (the byte-histogram kernel,
  ``ops/histogram_cuda.py``, once per device, summed) and Adler-32
  partial sums, with windows sharded over ``devices``.
* ``compress_corpus``: independent streams compressed on host threads.
* ``multihost``: one stream planned across processes
  (``torch.distributed``), and independent members per process.

Not ported: ``compress_sharded`` (:130), which runs the JAX package's
staircase match finder and its native host planner (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.histogram_cuda import byte_histogram
from ..ops.suffix_torch import doubling_rounds


def _window_step(windows: torch.Tensor):
    """One device's windows (w, L) uint8: suffix arrays and final ranks
    (all ceil(log2 L) doubling rounds, as the JAX step runs them), the
    byte histogram of every byte, and the Adler partial sums per window
    (sum b, sum (L - i) * b), exact in int64."""
    sa, ranks = doubling_rounds(windows.to(torch.int32))
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
