"""One-shot compression on CUDA devices: match tables -> block split
-> block plans run on the device for a batch of windows; the host
writes the framing, the table bits and the ordered splice of the packed
token words.

Port of zultra_tpu/device_pipeline.py. The device half
(``_begin_windows_batched``, here the match stage ``match_stacks`` and
``plan_windows``, which plans from given match tables, as
``parallel.compress_sharded`` does from the staircase's;
``begin_window_device``, ``compress_device`` with ``windows_per_batch``
and ``devices``, ``DeviceWindowEngine`` with its queued stream batch and
the per-window contract) is written in PyTorch. The host half
(``put_packed_bits``, ``_encoder_from_lengths``,
``write_block_from_plan``, ``_WindowPlan`` and
``emit_window_from_plan``, device_pipeline.py:39-105 and :176-227) is a
numpy copy of the JAX package's own, so window cuts, history slides,
BFINAL placement, the stored fallback and the framing are the same code
in both packages.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import frame, profiling
from .bitwriter import BitWriter, BitWriterError
from .constants import (
    HISTORY_SIZE,
    NCODELENBITS,
    NCODELENSYMS,
    NVALIDLITERALSYMS,
    NVALIDOFFSETSYMS,
)
from .huffman import HuffmanEncoder, write_var_lengths
from .ops.block_torch import on_device, plan_blocks_device_multi, to_device, to_host
from .ops.matchfinder_torch import HALO, SEG_CORE, match_stacks, match_table
from .ops.split_torch import input_cap, split_batch, split_bucket, trig_cap_for
from .stream import StreamError, clamp_block_size, memory_bound

WINDOWS_PER_BATCH = 16  # windows planned together in one device batch (per device)


# ---------------------------------------------------------------------------
# Host half: table bits and the ordered bit-phase splice
# ---------------------------------------------------------------------------


def put_packed_bits(writer: BitWriter, words: np.ndarray, total_bits: int) -> None:
    """Append an LSB-first packed bitstream (uint32 words, bits beyond
    ``total_bits`` zero) at the writer's current bit phase — the
    vectorized equivalent of ``total_bits`` put_bits calls."""
    if total_bits == 0:
        return
    phase = writer.bits_count
    n_in = (total_bits + 7) // 8
    b = np.ascontiguousarray(words).view(np.uint8)[:n_in]
    x = np.zeros(n_in + 1, np.uint16)
    x[:n_in] = b.astype(np.uint16) << phase
    if phase:
        x[1:] |= b.astype(np.uint16) >> (8 - phase)
    x[0] |= writer.bits_data
    out_bytes = (x & 0xFF).astype(np.uint8)

    T = phase + total_bits
    full, left = T // 8, T & 7
    if writer.offset + full > writer.max_offset:
        raise BitWriterError("output buffer overflow")
    writer.out[writer.offset : writer.offset + full] = out_bytes[:full].tobytes()
    writer.offset += full
    writer.bits_data = int(out_bytes[full]) & ((1 << left) - 1) if left else 0
    writer.bits_count = left


def _encoder_from_lengths(n_symbols: int, max_code_length: int, lengths) -> HuffmanEncoder:
    """Rebuild an encoder (canonical codewords) from final code lengths —
    the 19-symbol CL table is the only alphabet the host still issues."""
    enc = HuffmanEncoder(n_symbols, max_code_length, 0)
    enc.code_length[:n_symbols] = [int(x) for x in lengths]
    used = [i for i in range(n_symbols) if enc.code_length[i]]
    enc._issue_canonical(sorted(used, key=lambda i: (enc.code_length[i], i)))
    return enc


def write_block_from_plan(plan: dict, writer: BitWriter) -> None:
    """Emit one planned block's content (tables + tokens) after the
    caller's BFINAL/BTYPE bits (reference src/blockdeflate.c:958-997)."""
    if plan["is_dynamic"]:
        n_lit, n_off = plan["n_lit"], plan["n_off"]
        te = _encoder_from_lengths(NCODELENSYMS, 7, plan["cl_len"])
        n_cl = te.get_raw_table_size()
        if n_lit > NVALIDLITERALSYMS or n_off > NVALIDOFFSETSYMS or n_cl > NCODELENSYMS:
            raise ValueError("invalid table sizes")
        writer.put_bits(n_lit - 257, 5)
        writer.put_bits(n_off - 1, 5)
        writer.put_bits(n_cl - 4, 4)
        te.write_raw_table(NCODELENBITS, n_cl, writer)
        code_lengths = [int(x) for x in plan["lit_len"][:n_lit]] + [
            int(x) for x in plan["off_len"][:n_off]
        ]
        write_var_lengths(te, n_lit + n_off, code_lengths, plan["best_mask"], writer)
    put_packed_bits(writer, plan["words"], plan["total_bits"])


class _WindowPlan:
    __slots__ = ("plans", "block_spans", "window", "prev", "in_size")

    def __init__(self, plans, block_spans, window, prev, in_size):
        self.plans = plans
        self.block_spans = block_spans
        self.window = window
        self.prev = prev
        self.in_size = in_size


def emit_window_from_plan(handle: _WindowPlan, window_is_last: bool,
                          out: bytearray, bits_data: int, bits_count: int):
    """Ordered, bit-phase-dependent emission of a planned window
    (reference src/libzultra.c:309-402), including the stored-block
    fallback."""
    writer = BitWriter(out, 0, len(out))
    writer.bits_data = bits_data
    writer.bits_count = bits_count

    n_blocks = len(handle.block_spans)
    for i, ((s, e), plan) in enumerate(zip(handle.block_spans, handle.plans)):
        block_size = e - s
        is_final = 1 if (window_is_last and i == n_blocks - 1) else 0
        saved = writer.state()
        writer.put_bits(is_final, 1)
        writer.put_bits(1 + (1 if plan["is_dynamic"] else 0), 2)
        prev_offset = writer.get_offset()
        try:
            write_block_from_plan(plan, writer)
            expanded = (writer.get_offset() - prev_offset) > block_size
        except BitWriterError:
            expanded = True

        if expanded:
            writer.restore(saved)
            sub_offset = 0
            remaining = block_size
            while remaining:
                sub_size = min(remaining, 65535)
                sub_final = is_final if sub_size == remaining else 0
                writer.put_bits(sub_final, 1)
                writer.put_bits(0, 2)
                writer.flush_bits()
                writer.put_bytes(
                    bytes(
                        [
                            sub_size & 0xFF,
                            (sub_size >> 8) & 0xFF,
                            (sub_size & 0xFF) ^ 0xFF,
                            ((sub_size >> 8) & 0xFF) ^ 0xFF,
                        ]
                    )
                )
                writer.put_bytes(
                    handle.window[s + sub_offset : s + sub_offset + sub_size].tobytes()
                )
                sub_offset += sub_size
                remaining -= sub_size

    if window_is_last:
        writer.flush_bits()
    return writer.get_offset(), writer.bits_data, writer.bits_count


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------


def begin_windows_batched(corpus: np.ndarray, spans, mbs: int, device) -> list:
    """Plan a batch of windows on ``device``. Every window occupies a
    (HALO + mbs) lane with its first input byte at offset HALO and its
    real history bytes (<= 32 KB) just below; the lanes' bytes and match
    tables come from ``match_stacks``. Returns one _WindowPlan per span,
    in order. ``launch_windows`` then ``finish_windows``."""
    return finish_windows(launch_windows(corpus, spans, mbs, device))


def plan_windows(corpus: np.ndarray, spans, mbs: int, lens_st: torch.Tensor,
                 offs_st: torch.Tensor, win_dev: torch.Tensor) -> list:
    """The planning half of ``begin_windows_batched``, on the device of the
    given stacks: block split and block plans of a batch of window spans
    from their match tables ``lens_st``, ``offs_st`` (W, HALO + mbs, 8)
    int32 and window bytes ``win_dev`` (W, HALO + mbs) uint8 in the lane
    layout ``match_stacks`` gives. Returns one _WindowPlan per span, in
    order."""
    return finish_windows(launch_split(corpus, spans, mbs, lens_st, offs_st, win_dev))


class _LaunchedBatch:
    """A batch whose device work is queued up to its split points and not
    waited for: the window stacks, the split program's inputs (for the
    exact retry) and its outputs."""

    __slots__ = ("corpus", "spans", "mbs", "stacks", "split_args", "split")

    def __init__(self, corpus, spans, mbs, stacks, split_args, split):
        self.corpus, self.spans, self.mbs = corpus, spans, mbs
        self.stacks, self.split_args, self.split = stacks, split_args, split


def launch_windows(corpus: np.ndarray, spans, mbs: int, device) -> _LaunchedBatch:
    """The first half of ``begin_windows_batched``: the batch's upload, its
    match program and its split program queued on ``device``, with no
    wait for the device."""
    return launch_split(corpus, spans, mbs, *match_stacks(corpus, spans, mbs, device))


def launch_split(corpus: np.ndarray, spans, mbs: int, lens_st: torch.Tensor,
                 offs_st: torch.Tensor, win_dev: torch.Tensor) -> _LaunchedBatch:
    """The first half of ``plan_windows``: the pads, the lanes' lengths and
    the split program queued on the device of the stacks, with no wait."""
    n_lane = HALO + mbs
    tail = split_bucket(n_lane) - n_lane
    with profiling.span("zultra.split"):
        win_p = torch.nn.functional.pad(win_dev, (0, tail))
        rl = torch.nn.functional.pad(lens_st[:, :, 0], (0, tail))
        ro = torch.nn.functional.pad(offs_st[:, :, 0], (0, tail))
        n_real = to_device(np.array([HALO + (hi - lo) for lo, hi in spans], np.int32),
                           win_dev.device)
        cap = input_cap(mbs)
        split_args = (win_p, rl, ro, HALO, n_real, cap)
        split = split_batch(*split_args, trig_cap_for(cap))
    return _LaunchedBatch(corpus, spans, mbs, (lens_st, offs_st, win_dev), split_args, split)


def finish_windows(batch: _LaunchedBatch) -> list:
    """The second half of ``begin_windows_batched`` and ``plan_windows``:
    the wait for the split points, the exact retry of the lanes whose
    candidates overflowed, and the block plans. Returns one _WindowPlan
    per span, in order."""
    corpus, spans, mbs = batch.corpus, batch.spans, batch.mbs
    lens_st, offs_st, win_dev = batch.stacks
    n_lane = HALO + mbs
    prevs = [min(HISTORY_SIZE, w_lo) for w_lo, _ in spans]

    splits, n_splits, tok_marks, ovf = batch.split
    # The batch's one wait before the plans: the split points and the
    # overflow flags come back together.
    splits, n_splits, ovf = to_host(splits, n_splits, ovf)
    if ovf.any():
        # Exact retry of the overflowing lanes with every candidate slot
        # evaluated.
        full_splits, full_n = to_host(*split_batch(*batch.split_args, 0)[:2])
        splits = np.where(ovf[:, None], full_splits, splits)
        n_splits = np.where(ovf, full_n, n_splits)
    if profiling.enabled():
        profiling.count("split.positions", len(spans) * batch.split_args[0].shape[1])
        profiling.count("split.input", sum(HALO + hi - lo for lo, hi in spans))
        profiling.count("split.retry", int(ovf.sum()))

    lanes = []
    spans_per_window = []
    for w, (w_lo, w_hi) in enumerate(spans):
        ends = [int(x) for x in splits[w, : int(n_splits[w])]]
        ends.append(HALO + (w_hi - w_lo))
        blocks = []
        s = HALO
        for e in ends:
            blocks.append((s, e))
            lanes.append((w, s, e - s))
            s = e
        spans_per_window.append(blocks)

    plans = plan_blocks_device_multi(win_dev, lens_st, offs_st, lanes,
                                     tok_stack=tok_marks[:, :n_lane])

    handles = []
    i = 0
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = prevs[w]
        shift = HALO - prev  # lane coords -> window-buffer coords
        blocks = [(s - shift, e - shift) for (s, e) in spans_per_window[w]]
        handles.append(_WindowPlan(plans[i : i + len(blocks)], blocks,
                                   corpus[w_lo - prev : w_hi], prev, w_hi - w_lo))
        i += len(blocks)
    return handles


def begin_window_device(window: np.ndarray, prev: int, in_size: int, n_threads: int = 0,
                        device="cuda") -> _WindowPlan:
    """Plan one window alone: ``window`` holds ``prev`` history bytes,
    then ``in_size`` input bytes. The counterpart of
    zultra_tpu.device_pipeline.begin_window_device (:107), run as a
    one-window batch of ``begin_windows_batched`` with the window itself
    as the corpus: the same split points and plans, since a window's
    lane layout changes neither (tests/test_torch_window.py). The
    handle's block spans are in ``window``'s coordinates. ``n_threads``
    is accepted for the engine contract."""
    window = np.asarray(window, dtype=np.uint8)
    [handle] = begin_windows_batched(window[: prev + in_size], [(prev, prev + in_size)],
                                     in_size, torch.device(device))
    cut = prev - handle.prev  # history beyond HISTORY_SIZE, which no match reaches
    handle.block_spans = [(s + cut, e + cut) for s, e in handle.block_spans]
    handle.window, handle.prev = window, prev
    return handle


def lane_width(spans, mbs: int) -> int:
    """The lane width a one-shot batch is planned at: its longest span
    rounded up to a power-of-two count of SEG_CORE segments, at most
    ``mbs``. A batch of several windows holds a whole window, so only a
    one-window batch shorter than the block size (a small input, or a
    long one's lone tail window) is narrowed. Powers of two keep the
    match and split programs to six shapes each at 1 MiB blocks. The
    bytes do not depend on the width: the match program's pad rows are
    sentinels, the split retries exactly where its candidate cap
    overflows, and the planner's lanes are the blocks."""
    longest = max(hi - lo for lo, hi in spans)
    width = SEG_CORE
    while width < longest:
        width *= 2
    return min(width, mbs)


def begin_windows_on(device: torch.device, corpus: np.ndarray, spans, mbs: int) -> list:
    """begin_windows_batched with ``device`` current."""
    return _on(device, begin_windows_batched, corpus, spans, mbs, device)


def _on(device: torch.device, fn, *args):
    """``fn(*args)`` with ``device`` current."""
    with on_device(device):
        return fn(*args)


def compress_device(data: bytes, flags: int = 0, max_block_size: int = 0,
                    dictionary: bytes | None = None, windows_per_batch: int = WINDOWS_PER_BATCH,
                    devices=None, device="cuda") -> bytes:
    """One-shot compression with windows batched through the device
    begin-phase; byte-identical to zultra_tpu's streaming core at the
    same block size (reference one-shot API, src/libzultra.c:601-619).

    ``windows_per_batch`` windows are planned in one device batch
    (zultra_tpu/device_pipeline.py:354). With ``devices``, a list of
    devices (the counterpart of ``mesh=``), a batch holds
    ``windows_per_batch * len(devices)`` windows, cut into
    ``len(devices)`` contiguous groups that are planned each on its own
    device from a host thread of its own, so that the launches on
    distinct cards overlap; the plans are emitted in stream order. A
    device may appear twice (two threads share its stream). ``device``
    is the one device when ``devices`` is None. Each batch is planned at
    ``lane_width``: a one-window batch shorter than the block size at its
    input's width, with the same bytes.

    The batches run one deep in a pipeline: batch g + 1's match and split
    programs are queued (``launch_windows``) before the host splices
    batch g, and the checksum runs behind batch 0's; the splice order,
    and so the bytes, are those of one batch after another."""
    with profiling.span("zultra.compress"):
        return _compress_device(data, flags, max_block_size, dictionary, windows_per_batch,
                                devices, device)


def _compress_device(data, flags, max_block_size, dictionary, windows_per_batch, devices,
                     device) -> bytes:
    devs = [torch.device(d) for d in (devices if devices is not None else [device])]
    if windows_per_batch < 1 or not devs:
        raise ValueError("compress_device: need windows_per_batch >= 1 and at least one device")
    mbs = clamp_block_size(max_block_size)
    data_b = bytes(data)
    if not data_b:
        raise StreamError("cannot finalize an empty stream")
    dict_b = bytes(dictionary) if dictionary else b""
    if len(dict_b) > HISTORY_SIZE:
        raise StreamError(f"dictionary exceeds the {HISTORY_SIZE}-byte history window")
    corpus = np.frombuffer(dict_b + data_b, dtype=np.uint8)
    base = len(dict_b)
    spans = []
    pos = 0
    while pos < len(data_b):
        hi = min(pos + mbs, len(data_b))
        spans.append((base + pos, base + hi))
        pos = hi
    per_batch = windows_per_batch * len(devs)
    batches = [spans[g : g + per_batch] for g in range(0, len(spans), per_batch)]

    out = bytearray(frame.encode_header(flags, dict_b if dict_b else None))
    buf = bytearray(memory_bound(mbs, flags, mbs))
    bits_data, bits_count, emitted = 0, 0, 0
    pool = ThreadPoolExecutor(len(devs)) if len(devs) > 1 else None

    def on_each(fn, work):
        """``fn(*args)`` with ``device`` current, for each (device, *args) of
        ``work``: on the pool's threads where there are several devices."""
        def call(w):
            return _on(w[0], fn, *w[1:])

        return list((map if pool is None else pool.map)(call, work))

    def launch(batch):
        width = lane_width(batch, mbs)
        profiling.count("lane.narrowed", int(width < mbs))
        per = -(-len(batch) // len(devs))
        work = [(d, corpus, batch[i * per : (i + 1) * per], width, d)
                for i, d in enumerate(devs) if batch[i * per : (i + 1) * per]]
        return [(w[0], launched) for w, launched in zip(work, on_each(launch_windows, work))]

    try:
        pending = launch(batches[0])
        with profiling.span("zultra.checksum"):
            checksum = frame.update_checksum(frame.init_checksum(flags), corpus[base:], flags)
        for g in range(len(batches)):
            # Batch g's plans reach the host here (the planner's collect) and
            # its device tensors go with ``pending``, before batch g + 1's
            # programs replay; their outputs are copies taken right after
            # each replay, never the graphs' static buffers.
            ready, pending = [h for hs in on_each(finish_windows, pending) for h in hs], None
            overlapped = g + 1 < len(batches)
            if overlapped:
                pending = launch(batches[g + 1])
            profiling.count("splice.overlapped", int(overlapped))
            for handle in ready:
                emitted += 1
                with profiling.span("zultra.splice"):
                    n, bits_data, bits_count = emit_window_from_plan(
                        handle, emitted == len(spans), buf, bits_data, bits_count)
                out += buf[:n]
    finally:
        if pool is not None:
            pool.shutdown()
    out += frame.encode_footer(flags, checksum, len(data_b))
    return bytes(out)


class _QueuedWindow:
    """Future-like handle for a window awaiting the batched begin-phase.
    ``result()`` forces the engine to plan every queued window in ONE
    device batch (the stream's pipeline-depth lookahead becomes the
    device batch). Copy of zultra_tpu/device_pipeline.py:412-431."""

    __slots__ = ("engine", "plan")

    def __init__(self, engine):
        self.engine = engine
        self.plan: _WindowPlan | None = None

    def done(self) -> bool:
        return self.plan is not None

    def result(self) -> _WindowPlan:
        if self.plan is None:
            self.engine._flush_queue()
        assert self.plan is not None
        return self.plan


class DeviceWindowEngine:
    """The port's engine: match finding, splitting and block planning on
    ``device``; the host writes the framing, the tables and the ordered
    bit splice.

    One-shot compression goes through ``compress_device``. The streaming
    push API (the port's ``Stream``, which creates this engine) queues
    windows with ``queue_window`` and plans the whole lookahead, up to
    ``pipeline_depth`` windows, in one ``begin_windows_batched`` call when
    the stream first needs a plan; so a stream runs the same device
    batches as the one-shot path. It always queues, on the CPU as on the
    card (zultra_tpu queues only on a TPU, to spare XLA compiles the port
    does not have). ``emit_window`` writes a planned window; with
    ``queue_window`` it is the engine contract that zultra_tpu's ``Stream``
    also accepts (it takes ``queue_window`` over ``begin_window``). The
    per-window contract (``begin_window``, ``emit_window``,
    ``free_window``, ``find_all_matches``) plans one window alone, for
    direct users and cross-checks. (zultra_tpu/device_pipeline.py:434-534)"""

    name = "torchdev"
    pipeline_depth = WINDOWS_PER_BATCH  # windows per device batch through the stream

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._queue: list[tuple[_QueuedWindow, np.ndarray, int, int]] = []
        self._mbs_seen = 0  # largest window input so far: the lane width of later batches

    def compress_corpus(self, data, flags=0, max_block_size=0, dictionary=None):
        return compress_device(data, flags, max_block_size, dictionary, device=self.device)

    # -- streaming batched begin-phase --------------------------------------

    def queue_window(self, window: np.ndarray, prev: int, in_size: int,
                     n_threads: int = 0) -> _QueuedWindow:
        """Record one stream window for the next batched device begin.
        Called in stream order on the stream's thread; O(window) copy."""
        qw = _QueuedWindow(self)
        self._queue.append((qw, np.asarray(window, np.uint8).copy(), prev, in_size))
        return qw

    def _flush_queue(self) -> None:
        """Plan every queued window in one device batch. Consecutive
        stream windows rebuild a contiguous corpus: the first window gives
        its full (history + input) bytes, each later one only its input;
        its <= 32 KB history prefix IS the previous window's tail
        (checked). Copy of zultra_tpu/device_pipeline.py:489-521."""
        entries = self._queue
        self._queue = []
        if not entries:
            return
        _, win0, prev0, in0 = entries[0]
        corpus = bytearray(win0[: prev0 + in0].tobytes())
        spans = [(prev0, prev0 + in0)]
        self._mbs_seen = max(self._mbs_seen, in0)

        for _, win, prev, in_size in entries[1:]:
            lo = len(corpus)
            if prev != min(HISTORY_SIZE, lo):
                raise ValueError("queued windows are not consecutive")
            if not np.array_equal(
                win[:prev], np.frombuffer(corpus, np.uint8, prev, lo - prev)
            ):
                raise ValueError("queued window history diverges from stream")
            corpus += win[prev : prev + in_size].tobytes()
            spans.append((lo, lo + in_size))
            self._mbs_seen = max(self._mbs_seen, in_size)

        handles = begin_windows_batched(
            np.frombuffer(bytes(corpus), np.uint8), spans, self._mbs_seen, self.device
        )
        for (qw, _, _, _), handle in zip(entries, handles):
            qw.plan = handle

    def emit_window(self, handle: _WindowPlan, window_is_last: bool, out: bytearray,
                    bits_data: int, bits_count: int):
        with profiling.span("zultra.splice"):
            return emit_window_from_plan(handle, window_is_last, out, bits_data, bits_count)

    # -- per-window contract (direct users and cross-checks) ----------------

    def begin_window(self, window: np.ndarray, prev: int, in_size: int,
                     n_threads: int = 0) -> _WindowPlan:
        return begin_window_device(window, prev, in_size, n_threads, self.device)

    def free_window(self, handle: _WindowPlan) -> None:
        pass

    def find_all_matches(self, window: np.ndarray, start: int, end: int) -> np.ndarray:
        """The (end, 8, 2) int32 match table of ``window`` (zultra_tpu's
        DeviceWindowEngine.find_all_matches, :474)."""
        return match_table(window, start, end, self.device)
