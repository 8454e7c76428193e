"""Copy of zultra_tpu/frame.py (the JAX package's NumPy-only reference
semantics), part of the benchmark's plain reference encoder. It imports
only numpy, the standard library and its sibling copies.

Container framing (raw deflate / zlib RFC 1950 / gzip RFC 1952) and
checksums.

Mirrors reference src/frame.c:365-547. The Adler-32 and CRC-32 algorithms
are the standard ones (the reference vendors zlib's adler32 and Brumme's
slicing-by-4 crc32); we use the byte-identical implementations from
Python's zlib module on the host. JAX/psum-friendly checksum kernels live
in zultra_tpu.ops for the sharded path.
"""

from __future__ import annotations

import zlib

from .constants import FLAG_GZIP_FRAMING, FLAG_ZLIB_FRAMING

ENCODE_ERR = -1


def get_header_size(flags: int, dictionary: bytes | None = None) -> int:
    if flags & FLAG_GZIP_FRAMING:
        return 10
    if flags & FLAG_ZLIB_FRAMING:
        return 6 if dictionary else 2
    return 0


def encode_header(flags: int, dictionary: bytes | None = None) -> bytes:
    """(reference src/frame.c:387-445)"""
    if flags & FLAG_GZIP_FRAMING:
        # ID1 ID2, CM=deflate, FLG=0, MTIME=0, XFL=2 (max compression),
        # OS=255 (unknown)
        return bytes([0x1F, 0x8B, 0x08, 0, 0, 0, 0, 0, 2, 255])
    if flags & FLAG_ZLIB_FRAMING:
        cmf = 0x78  # 32 KB window, deflate
        flg = 0xC0  # highest compression level
        if dictionary:
            flg |= 0x20
        check = 31 - (((cmf << 8) | flg) % 31)
        flg |= check & 0x1F
        header = bytes([cmf, flg])
        if dictionary:
            dict_id = zlib.adler32(dictionary) & 0xFFFFFFFF
            header += dict_id.to_bytes(4, "big")
        return header
    return b""


def get_footer_size(flags: int) -> int:
    if flags & FLAG_GZIP_FRAMING:
        return 8
    if flags & FLAG_ZLIB_FRAMING:
        return 4
    return 0


def encode_footer(flags: int, checksum: int, original_size: int) -> bytes:
    """(reference src/frame.c:509-547)"""
    if flags & FLAG_GZIP_FRAMING:
        return (checksum & 0xFFFFFFFF).to_bytes(4, "little") + (
            original_size & 0xFFFFFFFF
        ).to_bytes(4, "little")
    if flags & FLAG_ZLIB_FRAMING:
        return (checksum & 0xFFFFFFFF).to_bytes(4, "big")
    return b""


def init_checksum(flags: int) -> int:
    if flags & FLAG_GZIP_FRAMING:
        return 0
    if flags & FLAG_ZLIB_FRAMING:
        return zlib.adler32(b"")
    return 0


def update_checksum(checksum: int, data, flags: int) -> int:
    if flags & FLAG_GZIP_FRAMING:
        return zlib.crc32(bytes(data), checksum) & 0xFFFFFFFF
    if flags & FLAG_ZLIB_FRAMING:
        return zlib.adler32(bytes(data), checksum) & 0xFFFFFFFF
    return 0
