"""Copy of zultra_tpu/bitwriter.py (the JAX package's NumPy-only reference
semantics), part of the benchmark's plain reference encoder. It imports
only numpy, the standard library and its sibling copies.

LSB-first bit packer with save/rewind, mirroring the semantics of the
reference bit writer (src/huffman/bitwriter.c:32-98, bitwriter.h:59-91).

The writer appends bits least-significant-first into a bytearray; a partial
byte is held in ``bits_data``/``bits_count`` until eight bits accumulate.
``state()``/``restore()`` provide the save/rewind used for the stored-block
fallback, and ``set_offset`` supports the stored-block byte writes.
"""

from __future__ import annotations


class BitWriterError(Exception):
    pass


class BitWriter:
    __slots__ = ("out", "offset", "max_offset", "bits_data", "bits_count")

    def __init__(self, out: bytearray, offset: int = 0, max_offset: int | None = None):
        self.out = out
        self.offset = offset
        self.max_offset = len(out) if max_offset is None else max_offset
        self.bits_data = 0
        self.bits_count = 0

    # -- save / rewind -----------------------------------------------------
    def state(self):
        return (self.offset, self.bits_data, self.bits_count)

    def restore(self, state) -> None:
        self.offset, self.bits_data, self.bits_count = state

    # -- primitives --------------------------------------------------------
    def put_bits(self, value: int, nbits: int) -> None:
        if nbits > 16:
            raise BitWriterError("cannot write more than 16 bits at once")
        self.bits_data |= (value & 0xFFFFFFFF) << self.bits_count
        self.bits_count += nbits
        while self.bits_count >= 8:
            if self.offset >= self.max_offset:
                raise BitWriterError("output buffer overflow")
            self.out[self.offset] = self.bits_data & 0xFF
            self.offset += 1
            self.bits_data >>= 8
            self.bits_count -= 8

    def flush_bits(self) -> None:
        """Pad to a byte boundary with zero bits."""
        if self.bits_count > 8:
            raise BitWriterError("inconsistent bit count")
        if self.bits_count > 0:
            if self.offset >= self.max_offset:
                raise BitWriterError("output buffer overflow")
            self.out[self.offset] = self.bits_data & ((1 << self.bits_count) - 1)
            self.offset += 1
            self.bits_data = 0
            self.bits_count = 0

    def get_offset(self) -> int:
        if self.offset > self.max_offset:
            raise BitWriterError("output buffer overflow")
        return self.offset

    def set_offset(self, offset: int) -> None:
        self.offset = offset

    # -- helpers for stored blocks ----------------------------------------
    def put_bytes(self, data) -> None:
        """Write raw bytes at the current (byte-aligned) offset."""
        n = len(data)
        if self.offset + n > self.max_offset:
            raise BitWriterError("output buffer overflow")
        self.out[self.offset : self.offset + n] = data
        self.offset += n
