"""zlib-style cooperative streaming API. Copy of zultra_tpu/compat.py over
the port's ``Stream``; ``device`` passes through.

Mirrors the reference's `zultra_stream_t` contract
(src/libzultra.h:78-157): the caller provides input via ``next_in`` and
drains output through a bounded ``avail_out`` budget; ``compress``
returns OK while output remains and STREAM_END once the footer has been
fully consumed. State (window, bit phase, checksum) suspends/resumes at
any exhaustion point — the streaming API is itself the checkpoint/resume
mechanism, exactly like the reference.

The pythonic `zultra_tpu_torch.Stream` remains the primary API; this
wrapper exists for drop-in ports of zlib/zultra-shaped call sites.
"""

from __future__ import annotations

from .stream import CONTINUE, Stream, StreamError

OK = 0
STREAM_END = 1
ERROR_COMPRESSION = -5


class ZultraStream:
    """Cooperative push/pull compressor.

    Usage::

        strm = ZultraStream(flags)
        strm.next_in = chunk
        while True:
            status, out = strm.compress(FINALIZE, max_out=16384)
            sink(out)
            if status == STREAM_END or not out:
                break
    """

    def __init__(self, flags: int = 0, max_block_size: int = 0, device="cuda"):
        self._stream = Stream(flags, max_block_size, device=device)
        self.next_in: bytes = b""
        self.total_in = 0
        self.total_out = 0
        self._out_queue = bytearray()
        self._finished = False

    @property
    def adler(self) -> int:
        return self._stream.checksum

    def set_dictionary(self, dictionary: bytes) -> None:
        self._stream.set_dictionary(dictionary)

    def compress(self, finalize: int = CONTINUE, max_out: int | None = None):
        """Consume ``next_in`` (fully) and return (status, out_bytes) with
        ``len(out_bytes) <= max_out``; remaining output stays queued for
        subsequent calls, mirroring the avail_out drip of the C API."""
        if self._finished and not self._out_queue:
            return ERROR_COMPRESSION, b""

        if not self._finished:
            data = self.next_in
            self.next_in = b""
            self.total_in += len(data)
            try:
                self._out_queue += self._stream.compress(data, finalize)
            except StreamError:
                if finalize and self.total_in == 0:
                    return ERROR_COMPRESSION, b""
                raise
            if finalize:
                self._finished = True

        if max_out is None:
            out = bytes(self._out_queue)
            self._out_queue.clear()
        else:
            out = bytes(self._out_queue[:max_out])
            del self._out_queue[:max_out]
        self.total_out += len(out)

        if self._finished and not self._out_queue:
            return STREAM_END, out
        return OK, out


def memory_compress(data: bytes, flags: int = 0, max_block_size: int = 0,
                    device="cuda") -> bytes:
    """One-shot helper with the reference's naming."""
    from .stream import compress

    return compress(data, flags, max_block_size, device=device)
