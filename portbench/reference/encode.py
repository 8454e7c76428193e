"""The benchmark's plain reference encoder: zultra's one-shot window loop
(zultra_tpu/stream.py:_compress_window, spec path) over the copied NumPy
modules of this package, cut so that a process pool can share it.

A window's plan is bit-phase independent: its match table and split
points (``window_plan``, one task a window) and then each block's static
or dynamic choice and content bits (``block_bits``, one task a block).
Only ``splice_window`` depends on the bit phase where the window starts:
it writes each block's BFINAL/BTYPE bits and content, and falls back to
stored sub-blocks where the content would not be smaller than the block
(reference src/libzultra.c:309-402), exactly as the sequential loop does.

Bit strings are Python ints, LSB first: bit ``i`` of the stream is bit
``i`` of the int.
"""

from __future__ import annotations

import numpy as np

from . import frame
from .bitwriter import BitWriter, BitWriterError
from .blocks import (
    block_deflate,
    block_split,
    evaluate_dynamic_cost,
    evaluate_static_cost,
    prepare_cost_evaluation,
)
from .constants import HISTORY_SIZE, MAX_SPLITS
from .matchfinder import find_all_matches

GZIP = 2  # the gzip container flag


def window_spans(n: int, mbs: int) -> list:
    """(lo, hi) input spans of the windows of an ``n``-byte input."""
    return [(lo, min(lo + mbs, n)) for lo in range(0, n, mbs)]


def window_of(data: bytes, lo: int, hi: int):
    """(window bytes, prev): the window holds up to 32 KiB of history
    before the input span [lo, hi)."""
    prev = min(HISTORY_SIZE, lo)
    return np.frombuffer(data, np.uint8, hi - lo + prev, lo - prev), prev


def window_plan(window: np.ndarray, prev: int) -> tuple:
    """(match table, block end offsets) of one window."""
    n = len(window)
    table = find_all_matches(window, prev, n)
    return table, block_split(window, table, prev, n - prev, MAX_SPLITS)


def block_bits(window: np.ndarray, table_part: np.ndarray, start: int, end: int) -> tuple:
    """(is_dynamic, content, n_bits) of the block [start, end) of a window,
    where ``table_part`` is the window's match table rows [start, end);
    ``content`` is None where the writer overflowed (an expanded block)."""
    table = np.zeros((end,) + table_part.shape[1:], np.int32)
    table[start:end] = table_part
    size = end - start
    lit_enc, off_enc = prepare_cost_evaluation(window, table, start, size)
    static_cost = evaluate_static_cost(lit_enc, off_enc)
    lit_enc.estimate_dynamic_codelens()
    off_enc.estimate_dynamic_codelens()
    is_dynamic = not (static_cost <= evaluate_dynamic_cost(lit_enc, off_enc))
    buf = bytearray(2 * size + 4096)
    writer = BitWriter(buf, 0, len(buf))
    best = np.zeros((end, 2), np.int32)
    try:
        block_deflate(window, table, best, start, size, is_dynamic, writer)
    except BitWriterError:
        return is_dynamic, None, 0
    n_bits = 8 * writer.offset + writer.bits_count
    return is_dynamic, int.from_bytes(bytes(buf[: writer.offset]), "little") | (
        writer.bits_data << (8 * writer.offset)), n_bits


def splice_window(window: np.ndarray, prev: int, ends: list, blocks: list, phase: int,
                  is_last: bool) -> tuple:
    """(bits, end_bit) of a planned window written from bit ``phase`` on:
    bits below ``phase`` are zero. ``blocks`` holds ``block_bits`` of each
    block. The last window of a stream ends padded to a byte."""
    acc, pos = 0, phase
    start = prev
    for i, (end, (is_dynamic, content, n_bits)) in enumerate(zip(ends, blocks)):
        size = end - start
        is_final = 1 if (is_last and i == len(ends) - 1) else 0
        head = is_final | ((2 if is_dynamic else 1) << 1)
        before = (pos + 3) // 8  # the writer's byte offset after BFINAL/BTYPE
        if content is not None and (pos + 3 + n_bits) // 8 - before <= size:
            acc |= (head | (content << 3)) << pos
            pos += 3 + n_bits
        else:  # stored sub-blocks of at most 65535 bytes
            off = start
            while off < end:
                sub = min(end - off, 65535)
                sub_final = is_final if off + sub == end else 0
                acc |= sub_final << pos
                pos = (pos + 3 + 7) // 8 * 8
                raw = bytes([sub & 0xFF, sub >> 8, (sub & 0xFF) ^ 0xFF, (sub >> 8) ^ 0xFF])
                raw += window[off : off + sub].tobytes()
                acc |= int.from_bytes(raw, "little") << pos
                pos += 8 * len(raw)
                off += sub
        start = end
    if is_last:
        pos = (pos + 7) // 8 * 8
    return acc, pos


def encode_window(window: np.ndarray, prev: int, phase: int = 0, is_last: bool = False):
    """Plan and splice one window in this process."""
    table, ends = window_plan(window, prev)
    starts = [prev] + list(ends[:-1])
    planned = [block_bits(window, table[s:e], s, e) for s, e in zip(starts, ends)]
    return splice_window(window, prev, ends, planned, phase, is_last)


def compress_gzip(data: bytes, mbs: int) -> bytes:
    """The whole gzip stream of ``data`` at block size ``mbs`` (no
    dictionary), as zultra writes it."""
    acc, pos = 0, 0
    spans = window_spans(len(data), mbs)
    for k, (lo, hi) in enumerate(spans):
        window, prev = window_of(data, lo, hi)
        bits, end = encode_window(window, prev, pos % 8, k == len(spans) - 1)
        acc |= bits << (pos - pos % 8)
        pos += end - pos % 8
    body = acc.to_bytes(pos // 8, "little")
    crc = frame.update_checksum(frame.init_checksum(GZIP), data, GZIP)
    return frame.encode_header(GZIP) + body + frame.encode_footer(GZIP, crc, len(data))


def find_window(stream: bytes, bits: int, end_bit: int, phase: int, first: int) -> int:
    """The byte of ``stream`` at or after ``first`` where the window bits
    ``bits`` (written from bit ``phase`` to ``end_bit``) lie whole, or -1.
    The window's first and last partial bytes are compared on their own
    bits; every byte between must match."""
    n_bytes = (end_bit + 7) // 8
    raw = bits.to_bytes(max(n_bytes, 1), "little")
    inner = raw[1 : end_bit // 8]
    if not inner:
        return -1
    at = stream.find(inner, first + 1)
    while at >= 0:
        lo = at - 1
        ok = (stream[lo] >> phase) == (raw[0] >> phase)
        tail = end_bit % 8
        if ok and tail:
            hi = lo + end_bit // 8
            ok = hi < len(stream) and (stream[hi] ^ raw[end_bit // 8]) & ((1 << tail) - 1) == 0
        if ok:
            return lo
        at = stream.find(inner, at + 1)
    return -1
