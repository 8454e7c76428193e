"""Many processes: independent members, and one stream planned across
processes ("windows" mode), on ``torch.distributed``.

Port of zultra_tpu/parallel/multihost.py. The corpus shards by process
rank; the only traffic between processes is the sum of corpus
statistics, the plans, and the checksum partials, each small.

* ``members``: each shard becomes its own gzip/zlib member
  (concatenated gzip members are a valid gzip stream).
* ``windows``: the stream's windows are cut at max-block-size
  boundaries; each process plans a contiguous span of them (each window
  needs only its bytes and the 32 KB before them), the plans are
  serialized (``serialize_plan``: an explicit fixed layout, without the
  window bytes) and gathered, and rank 0 emits them in stream order at
  the true bit phase. The output equals one process's ``compress_device``.

``compress_windows_distributed`` is the form for a process group that
is already up (the counterpart of ``compress_windows_jax_distributed``):
two ``all_gather`` collectives on CPU tensors, so the gloo backend
carries them whatever device plans. NCCL refuses two ranks on one card;
gloo does not. ``run_windows_distributed`` starts such a group of
processes on one machine. ``compress_windows_multihost`` fans the same
decomposition out to a pool of worker processes without a group. Both
start their processes from the ``spawn`` context: a process forked after
CUDA has started cannot use CUDA.

The host code (``shard_blobs``, ``window_spans``, the checksum partials
and their combine, ``stitch_window_plans``) is copied from the JAX
package; where the JAX package plans with its native library
(``zn_window_begin``), the port plans with its own device path
(``device_pipeline.begin_windows_batched``).
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np
import torch

from ..constants import FLAG_GZIP_FRAMING, FLAG_ZLIB_FRAMING, HISTORY_SIZE

PLAN_MAGIC = 0x5A545031  # "1PTZ" little-endian: a serialized window plan


def process_info():
    """(rank, world size) of the default ``torch.distributed`` group if
    one is up, else a single process (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_blobs(blobs, process_index: int, process_count: int):
    """Round-robin shard a corpus file list across hosts."""
    return [b for i, b in enumerate(blobs) if i % process_count == process_index]


def compress_shard_members(blobs, flags=0, max_block_size: int = 0, device="cuda"):
    """Compress this process's shard of a corpus; returns the list of
    compressed members (order preserved within the shard)."""
    from ..stream import compress

    return [compress(b, flags, max_block_size, device=device) for b in blobs]


def corpus_histogram_allreduce(local_hist, group=None):
    """Sum a per-process histogram over the process group: one
    ``dist.all_reduce`` of a CPU int64 tensor (the counterpart of
    corpus_histogram_psum and allreduce_sum_over_devices, :60, :87).
    Returns the total in the input's kind (numpy array, or a tensor on
    its device); passes it through for a single process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return local_hist
    total = torch.as_tensor(local_hist).to(device="cpu", dtype=torch.int64).clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    if torch.is_tensor(local_hist):
        return total.to(local_hist.device)
    return total.numpy()


# ---------------------------------------------------------------------------
# "windows" mode: one deflate stream planned across processes
# ---------------------------------------------------------------------------


def window_spans(total: int, max_block_size: int):
    """The stream's window boundaries: [lo, hi) byte ranges, one per
    window, exactly as the streaming core cuts them."""
    spans = []
    pos = 0
    while pos < total:
        in_size = min(max_block_size, total - pos)
        spans.append((pos, pos + in_size))
        pos += in_size
    return spans


def span_checksum_partial(data, lo: int, hi: int, flags: int):
    """Worker-side checksum partial over the contiguous byte span
    [lo, hi): (value, length), combined on rank 0 by
    ``combine_checksum_partials`` (reference src/frame.c:454-480 runs the
    running checksum inline; windows mode distributes it)."""
    import zlib

    chunk = bytes(data[lo:hi])
    if flags & FLAG_GZIP_FRAMING:
        return zlib.crc32(chunk) & 0xFFFFFFFF, hi - lo
    if flags & FLAG_ZLIB_FRAMING:
        return zlib.adler32(chunk) & 0xFFFFFFFF, hi - lo
    return 0, hi - lo


def combine_checksum_partials(parts, flags: int) -> int:
    """Tree-combinable reduction of ordered (value, length) partials into
    the stream checksum (ops.checksum.crc32_combine/adler32_combine)."""
    from ..ops.checksum import adler32_combine, crc32_combine

    if flags & FLAG_GZIP_FRAMING:
        acc = 0
        for value, length in parts:
            acc = crc32_combine(acc, value, length)
        return acc
    if flags & FLAG_ZLIB_FRAMING:
        acc = 1
        for value, length in parts:
            acc = adler32_combine(acc, value, length)
        return acc
    return 0


# A serialized window plan, little-endian:
#   u32 PLAN_MAGIC, u32 prev, u32 in_size, u32 n_blocks,
#   n_blocks x (u32 start, u32 end)            block spans, window coords
#   n_blocks x (u8 is_dynamic, u32 best_mask, u32 n_lit, u32 n_off,
#               u64 total_bits, then the arrays lit_len, off_len,
#               cl_len, words, each as 4s numpy dtype string, u32 count,
#               count items)
# The window bytes are left out: rank 0 rebuilds them from the corpus.
_HEAD = struct.Struct("<IIII")
_SPAN = struct.Struct("<II")
_BLOCK = struct.Struct("<BIIIQ")
_ARRAY = struct.Struct("<4sI")
_ARRAYS = ("lit_len", "off_len", "cl_len", "words")


def serialize_plan(handle) -> bytes:
    """One planned window (``device_pipeline._WindowPlan``) as bytes."""
    out = bytearray(_HEAD.pack(PLAN_MAGIC, handle.prev, handle.in_size, len(handle.plans)))
    for s, e in handle.block_spans:
        out += _SPAN.pack(s, e)
    for plan in handle.plans:
        out += _BLOCK.pack(int(plan["is_dynamic"]), plan["best_mask"], plan["n_lit"],
                           plan["n_off"], plan["total_bits"])
        for key in _ARRAYS:
            a = np.ascontiguousarray(plan[key])
            out += _ARRAY.pack(a.dtype.str.encode(), a.size) + a.tobytes()
    return bytes(out)


def deserialize_plan(blob: bytes, window: np.ndarray):
    """Inverse of ``serialize_plan``; ``window`` is the window's bytes
    (prev history bytes, then in_size input bytes)."""
    from ..device_pipeline import _WindowPlan

    magic, prev, in_size, n_blocks = _HEAD.unpack_from(blob, 0)
    if magic != PLAN_MAGIC:
        raise ValueError(f"not a serialized window plan (magic {magic:#x})")
    o = _HEAD.size
    spans = []
    for _ in range(n_blocks):
        spans.append(_SPAN.unpack_from(blob, o))
        o += _SPAN.size
    plans = []
    for _ in range(n_blocks):
        is_dyn, best_mask, n_lit, n_off, total_bits = _BLOCK.unpack_from(blob, o)
        o += _BLOCK.size
        plan = {"is_dynamic": bool(is_dyn), "best_mask": best_mask, "n_lit": n_lit,
                "n_off": n_off, "total_bits": total_bits}
        for key in _ARRAYS:
            code, count = _ARRAY.unpack_from(blob, o)
            o += _ARRAY.size
            dtype = np.dtype(code.rstrip(b"\0").decode())
            plan[key] = np.frombuffer(blob, dtype, count, o).copy()
            o += count * dtype.itemsize
        plans.append(plan)
    if o != len(blob):
        raise ValueError(f"serialized window plan: {len(blob) - o} trailing bytes")
    return _WindowPlan(plans, spans, np.asarray(window, np.uint8), prev, in_size)


def plan_window_span(data, spans, device="cuda"):
    """Plan the windows ``spans`` ([lo, hi) in ``data``'s coordinates,
    consecutive, every one but the stream's last of one size) of
    ``data`` (the full corpus, or a memoryview) on ``device``, in device
    batches of WINDOWS_PER_BATCH; returns one serialized plan per
    window. Only data[lo - 32768 : hi] of each window is read."""
    from ..device_pipeline import WINDOWS_PER_BATCH, begin_windows_on

    corpus = np.frombuffer(data, dtype=np.uint8)
    dev = torch.device(device)
    mbs = max((hi - lo for lo, hi in spans), default=0)
    blobs = []
    for g in range(0, len(spans), WINDOWS_PER_BATCH):
        for handle in begin_windows_on(dev, corpus, spans[g : g + WINDOWS_PER_BATCH], mbs):
            blobs.append(serialize_plan(handle))
    return blobs


def stitch_window_plans(blobs, flags, data, max_block_size: int,
                        checksum_parts=None, data_len: int | None = None,
                        dictionary: bytes | None = None) -> bytes:
    """Rank-0 step: emit planned windows in stream order at the true bit
    phase and wrap them in the container framing. With
    ``checksum_parts`` (ordered (value, length) partials) the stream
    checksum is an O(workers) combine; without them it hashes ``data``."""
    from .. import frame
    from ..device_pipeline import emit_window_from_plan
    from ..stream import clamp_block_size, memory_bound

    max_block_size = clamp_block_size(max_block_size)
    if data_len is None:
        data_len = len(data)
    out = bytearray()
    out += frame.encode_header(flags, dictionary)
    if checksum_parts is not None:
        total = sum(length for _, length in checksum_parts)
        if total != data_len:
            raise ValueError("checksum partials do not cover the stream")
        checksum = combine_checksum_partials(checksum_parts, flags)
    else:
        checksum = frame.update_checksum(
            frame.init_checksum(flags), np.frombuffer(data, dtype=np.uint8), flags)

    # Window byte spans (the blobs carry no window bytes): the same cut
    # every planner used, in dict + data corpus coordinates.
    dict_b = dictionary if dictionary else b""
    base = len(dict_b)
    spans = [(base + lo, base + hi) for lo, hi in window_spans(data_len, max_block_size)]
    if len(blobs) != len(spans):
        raise ValueError(f"{len(blobs)} plans for {len(spans)} windows")
    corpus = np.frombuffer(dict_b + bytes(data), np.uint8)

    buf = bytearray(memory_bound(max_block_size, flags, max_block_size))
    bits_data, bits_count = 0, 0
    for i, blob in enumerate(blobs):
        lo, hi = spans[i]
        handle = deserialize_plan(blob, corpus[lo - min(HISTORY_SIZE, lo) : hi])
        n, bits_data, bits_count = emit_window_from_plan(
            handle, i + 1 == len(blobs), buf, bits_data, bits_count)
        out += buf[:n]
    out += frame.encode_footer(flags, checksum, data_len)
    return bytes(out)


def _stream_spans(data, max_block_size: int, dictionary):
    """(clamped block size, dict bytes, corpus bytes, window spans in
    corpus coordinates) of one stream."""
    from ..stream import StreamError, clamp_block_size

    max_block_size = clamp_block_size(max_block_size)
    dict_b = bytes(dictionary) if dictionary else b""
    if len(dict_b) > HISTORY_SIZE:
        raise StreamError(f"dictionary exceeds the {HISTORY_SIZE}-byte history window")
    base = len(dict_b)
    corpus = dict_b + bytes(data)
    spans = [(base + lo, base + hi) for lo, hi in window_spans(len(data), max_block_size)]
    return max_block_size, dict_b, corpus, spans


def _plan_span_worker(args):
    """Pool worker: plan a contiguous run of windows from the corpus
    bytes they need, and hash their input span."""
    piece, offset, spans, flags, device = args
    torch.set_num_threads(1)
    local = [(lo - offset, hi - offset) for lo, hi in spans]
    blobs = plan_window_span(piece, local, device)
    part = span_checksum_partial(piece, local[0][0], local[-1][1], flags)
    return blobs, part


def compress_windows_multihost(data: bytes, flags: int = 0, max_block_size: int = 0,
                               workers: int = 2, dictionary: bytes | None = None,
                               devices=("cuda",)) -> bytes:
    """One stream with its window planning fanned out to ``workers``
    processes (spawned; worker i plans on ``devices[i % len(devices)]``),
    each given a contiguous, balanced run of windows and the bytes they
    need; this process stitches. Equal to one process's stream, a
    preset ``dictionary`` (<= 32 KB) included."""
    import multiprocessing as mp

    max_block_size, dict_b, corpus, spans = _stream_spans(data, max_block_size, dictionary)
    if workers <= 1 or len(spans) == 1:
        blobs = plan_window_span(corpus, spans, devices[0])
        return stitch_window_plans(blobs, flags, data, max_block_size, data_len=len(data),
                                   dictionary=dict_b if dict_b else None)

    per = -(-len(spans) // workers)
    chunks = [spans[i : i + per] for i in range(0, len(spans), per)]
    jobs = []
    for i, c in enumerate(chunks):
        offset = c[0][0] - min(HISTORY_SIZE, c[0][0])
        jobs.append((corpus[offset : c[-1][1]], offset, c, flags, str(devices[i % len(devices)])))
    with mp.get_context("spawn").Pool(len(chunks)) as pool:
        results = pool.map(_plan_span_worker, jobs)
    blobs = [b for blobs_c, _ in results for b in blobs_c]
    parts = [part for _, part in results]
    return stitch_window_plans(blobs, flags, data, max_block_size, checksum_parts=parts,
                               data_len=len(data), dictionary=dict_b if dict_b else None)


def compress_windows_distributed(data: bytes, flags: int = 0, max_block_size: int = 0,
                                 dictionary: bytes | None = None, group=None, device="cuda",
                                 stats: dict | None = None) -> bytes | None:
    """Windows mode over an initialized ``torch.distributed`` group: this
    rank plans its contiguous span of the stream's windows on ``device``,
    the ranks exchange their serialized plans and checksum partials with
    two ``all_gather`` collectives of CPU tensors (the sizes, then the
    buffers padded to the largest), and rank 0 stitches the stream.

    Returns the bytes on rank 0, None elsewhere; equal to one process's
    stream. ``data`` is the full corpus on every rank; each rank plans
    only its own span. With ``stats``, the rank's seconds go there
    (plan, checksum, serialize, allgather; stitch on rank 0)."""
    import torch.distributed as dist

    marks = [("start", time.perf_counter())]
    rank, count = dist.get_rank(group), dist.get_world_size(group)
    max_block_size, dict_b, corpus, spans = _stream_spans(data, max_block_size, dictionary)
    per = -(-len(spans) // count)
    mine = spans[rank * per : (rank + 1) * per]
    blobs = plan_window_span(corpus, mine, device)  # host bytes: the device work is done
    marks.append(("plan", time.perf_counter()))
    part = span_checksum_partial(corpus, mine[0][0], mine[-1][1], flags) if mine else (0, 0)
    marks.append(("checksum", time.perf_counter()))

    # This rank's record: the 12-byte checksum partial (value u32, length
    # u64), then each plan with a u32 length prefix.
    local = bytearray(struct.pack("<IQ", int(part[0]), int(part[1])))
    for b in blobs:
        local += struct.pack("<I", len(b)) + b
    size = torch.tensor([len(local)], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(count)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8)
    padded[: len(local)] = torch.frombuffer(local, dtype=torch.uint8)
    marks.append(("serialize", time.perf_counter()))
    rows = [torch.empty(max(sizes), dtype=torch.uint8) for _ in range(count)]
    dist.all_gather(rows, padded, group=group)
    marks.append(("allgather", time.perf_counter()))
    if stats is not None:
        stats.update({f"{marks[i][0]}_s": marks[i][1] - marks[i - 1][1]
                      for i in range(1, len(marks))})

    if rank != 0:
        return None
    all_blobs = []
    parts = []
    for row, n in zip(rows, sizes):
        row = row.numpy().tobytes()[:n]
        parts.append(struct.unpack_from("<IQ", row, 0))
        o = 12
        while o < len(row):
            (ln,) = struct.unpack_from("<I", row, o)
            all_blobs.append(row[o + 4 : o + 4 + ln])
            o += 4 + ln
    t0 = time.perf_counter()
    out = stitch_window_plans(all_blobs, flags, data, max_block_size, checksum_parts=parts,
                              data_len=len(data), dictionary=dict_b if dict_b else None)
    if stats is not None:
        stats["stitch_s"] = time.perf_counter() - t0
    return out


def _distributed_worker(rank, world_size, init_method, data, flags, max_block_size,
                        dictionary, device, queue):
    """One rank of ``run_windows_distributed``: join the gloo group, run
    windows mode, report (rank, output, stats, error text) and leave. The
    stats hold the rank's kernel launches in the run (``launches``)."""
    import traceback

    import torch.distributed as dist

    from ..ops import launch_counts, reset_launch_counts

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
        try:
            stats = {}
            reset_launch_counts()
            out = compress_windows_distributed(data, flags, max_block_size, dictionary,
                                               device=device, stats=stats)
            stats["launches"] = launch_counts()
        finally:
            dist.destroy_process_group()
        queue.put((rank, out, stats, None))
    except BaseException:
        queue.put((rank, None, None, traceback.format_exc()))
        raise


def run_windows_distributed(data: bytes, flags: int = 0, max_block_size: int = 0,
                            world_size: int = 2, device="cuda", init_method: str | None = None,
                            dictionary: bytes | None = None, timeout: float = 600.0):
    """Start ``world_size`` spawned processes that form a gloo group and
    compress ``data`` in windows mode, every rank planning on ``device``.
    Returns (rank 0's bytes, each rank's stats). ``init_method`` defaults
    to a ``file://`` rendezvous in a fresh temporary directory, so that
    no port is shared."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        if init_method is None:
            init_method = "file://" + os.path.join(tmp, "rendezvous")
        q = ctx.Queue()
        procs = [ctx.Process(target=_distributed_worker,
                             args=(r, world_size, init_method, bytes(data), flags,
                                   max_block_size, dictionary, str(device), q))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results = {}
        try:
            deadline = time.monotonic() + timeout
            while len(results) < world_size:
                try:
                    rank, out, st, err = q.get(timeout=max(1.0, deadline - time.monotonic()))
                except queue_mod.Empty:
                    raise RuntimeError(f"windows mode: {world_size - len(results)} ranks sent "
                                       f"nothing in {timeout} s") from None
                if err is not None:
                    raise RuntimeError(f"windows mode: rank {rank} failed:\n{err}")
                results[rank] = (out, st)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return results[0][0], [results[r][1] for r in range(world_size)]


# ---------------------------------------------------------------------------
# Scaling measurement (process-parallel shards on one machine)
# ---------------------------------------------------------------------------


def bench_scaling(data: bytes, worker_counts=(1, 2), flags=0, max_block_size: int = 0,
                  device="cuda"):
    """Shard-parallel throughput at several worker counts and the
    resulting scaling efficiency: each worker is a fresh process that
    compresses its shard with the port on ``device`` (after a 4 KiB
    warm-up call, which loads the kernels); the parallel time is the
    slowest worker's compression time. Returns a dict keyed by worker
    count."""
    import subprocess
    import sys
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        blob_path = os.path.join(tmp, "corpus.bin")
        with open(blob_path, "wb") as f:
            f.write(data)

        for workers in worker_counts:
            shard_size = -(-len(data) // workers)
            spans = [(w * shard_size, min((w + 1) * shard_size, len(data)))
                     for w in range(workers)]
            script = (
                "import sys, time\n"
                "sys.path.insert(0, %r)\n"
                "import torch\n"
                "torch.set_num_threads(1)\n"
                "import zultra_tpu_torch as ztt\n"
                "lo, hi = int(sys.argv[1]), int(sys.argv[2])\n"
                "data = open(%r, 'rb').read()[lo:hi]\n"
                "ztt.compress(data[:4096], %d, %d, device=%r)\n"
                "if torch.device(%r).type == 'cuda':\n"
                "    torch.cuda.synchronize()\n"
                "t0 = time.perf_counter()\n"
                "out = ztt.compress(data, %d, %d, device=%r)\n"
                "elapsed = time.perf_counter() - t0\n"
                "print(len(out), elapsed)\n"
            ) % (repo, blob_path, flags, max_block_size, str(device), str(device),
                 flags, max_block_size, str(device))

            procs = [subprocess.Popen([sys.executable, "-c", script, str(lo), str(hi)],
                                      stdout=subprocess.PIPE, text=True)
                     for lo, hi in spans]
            worker_times = []
            for p in procs:
                out, _ = p.communicate()
                if p.returncode != 0:
                    raise RuntimeError(f"bench_scaling worker exited {p.returncode}: {out}")
                _, elapsed = out.split()
                worker_times.append(float(elapsed))
            wall = max(worker_times)
            results[workers] = {"wall_s": wall, "MBps": len(data) / 1e6 / wall}

    base = results[min(worker_counts)]["MBps"] * min(worker_counts)
    for workers, r in results.items():
        r["efficiency"] = r["MBps"] / (base / min(worker_counts) * workers)
    return results
