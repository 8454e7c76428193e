"""Container checksums as device reductions and associative combines.

Port of zultra_tpu/ops/checksum.py. Adler-32 over a byte shard is a
pair of sums:
    a = 1 + sum b_i                 (mod 65521)
    b = len + sum (len - i) * b_i   (mod 65521)
and two shards combine associatively:
    a = a1 + a2 - 1
    b = b1 + b2 - 1 + (a1 - 1) * len2        (all mod 65521)
``adler32`` takes the per-chunk sums on the device as torch reductions
in int64 and folds them on the host. The JAX form cuts the data into
2048-byte chunks so that each weighted sum stays below 2^31; in int64 a
chunk of ``ADLER_CHUNK`` = 2^16 bytes stays far below 2^63 (255 * 2^31),
so the chunk is only there to bound the weight vector and the host's
fold (one term per 64 KiB).

CRC-32 distributes through its GF(2) structure:
    crc(s1 || s2) = shift(crc(s1), len2) XOR crc(0-prefix || s2)
``adler32_combine``, ``crc32_combine`` and ``crc32_sharded`` are host
integer code, copied from zultra_tpu/ops/checksum.py (:70, :100, :134).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

ADLER_BASE = 65521
ADLER_CHUNK = 1 << 16  # bytes per device partial sum


def adler_chunk_sums(chunks: torch.Tensor):
    """chunks (m, L) uint8 -> per-chunk (sum b, sum (L - i) * b), int64."""
    b = chunks.to(torch.int64)
    weights = torch.arange(chunks.shape[1], 0, -1, dtype=torch.int64, device=chunks.device)
    return b.sum(dim=1), (b * weights).sum(dim=1)


def adler32(data, value: int = 1, device="cuda") -> int:
    """Adler-32 of a byte array, continuing from the running checksum
    ``value`` (1 for a fresh stream), like zlib.adler32: per-chunk sums
    on ``device``, the modular fold on the host (adler32_jax, :45)."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.asarray(data, dtype=np.uint8)
    n = int(arr.shape[0])
    if n == 0:
        return value
    m = -(-n // ADLER_CHUNK)
    L = ADLER_CHUNK if m > 1 else n
    padded = np.zeros(m * L, np.uint8)
    padded[:n] = arr
    s1, s2 = adler_chunk_sums(torch.from_numpy(padded).to(device).view(m, L))
    s1 = s1.cpu().numpy() % ADLER_BASE
    s2 = s2.cpu().numpy() % ADLER_BASE
    # Byte g = c*L + i has global weight n - g = (n - (c+1)*L) + (L - i):
    # the chunk's weighted sum plus a per-chunk constant times its sum
    # (zero padding adds nothing to either).
    diffs = (n - np.arange(1, m + 1, dtype=np.int64) * L) % ADLER_BASE
    a = int(np.sum(s1) % ADLER_BASE)
    weighted = int(np.sum(s2 + diffs * s1) % ADLER_BASE)
    shard = (((weighted + n) % ADLER_BASE) << 16) | ((a + 1) % ADLER_BASE)
    return adler32_combine(value, shard, n)


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Combine adler32(seq1) and adler32(seq2) into adler32(seq1||seq2)."""
    a1, b1 = adler1 & 0xFFFF, (adler1 >> 16) & 0xFFFF
    a2, b2 = adler2 & 0xFFFF, (adler2 >> 16) & 0xFFFF
    a = (a1 + a2 - 1) % ADLER_BASE
    b = (b1 + b2 + (a1 - 1) * (len2 % ADLER_BASE)) % ADLER_BASE
    return (b << 16) | a


# -- CRC-32 GF(2) combine ----------------------------------------------------

_CRC_POLY = 0xEDB88320


def _gf2_matrix_times(mat, vec):
    total = 0
    i = 0
    while vec:
        if vec & 1:
            total ^= mat[i]
        vec >>= 1
        i += 1
    return total


def _gf2_matrix_square(square, mat):
    for i in range(32):
        square[i] = _gf2_matrix_times(mat, mat[i])


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(seq1||seq2) from crc32(seq1), crc32(seq2), len(seq2).
    Same GF(2) matrix-power method as zlib's crc32_combine."""
    if len2 <= 0:
        return crc1
    even = [0] * 32
    odd = [0] * 32

    odd[0] = _CRC_POLY
    row = 1
    for i in range(1, 32):
        odd[i] = row
        row <<= 1

    _gf2_matrix_square(even, odd)
    _gf2_matrix_square(odd, even)

    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break

    return crc1 ^ crc2


def crc32_sharded(shards) -> int:
    """CRC-32 of the concatenation of byte shards, each hashed
    independently (tree-combinable across hosts)."""
    crc = 0
    for shard in shards:
        crc = crc32_combine(crc, zlib.crc32(bytes(shard)) & 0xFFFFFFFF, len(shard))
    return crc
