"""The port's checksums (``ops/checksum.py``), token emission
(``ops/emit_torch.py``) and the other exports of ``zultra_tpu_torch.ops``
on the CPU, each held against the JAX function it ports and against
zlib / a sequential BitWriter, with exact equality (integers and bytes).

Inputs are seeded (``zultra_tpu_torch.corpus`` and numpy); the parses fed
to ``write_tokens`` come from the JAX package's native optimal parser."""

import zlib

import numpy as np
import pytest
import torch

from zultra_tpu import native
from zultra_tpu.bitwriter import BitWriter
from zultra_tpu.constants import (
    MATCHLEN_BASE,
    MATCHLEN_EXTRA_BITS,
    MATCHLEN_SYMBOL,
    MIN_MATCH_SIZE,
    NEODMARKERSYM,
    NLITERALSYMS,
    NOFFSETSYMS,
    OFFSET_BASE,
    OFFSET_EXTRA_BITS,
    OFFSET_SYMBOL,
    static_literal_code_lengths,
    static_offset_code_lengths,
)
from zultra_tpu.huffman import HuffmanEncoder
from zultra_tpu.ops import checksum as jax_checksum
from zultra_tpu.ops.emit_jax import write_tokens_jax
from zultra_tpu.ops.histogram import byte_histogram_pallas, token_histogram_jax
from zultra_tpu.ops.suffix_jax import plcp_jax, suffix_array_jax
from zultra_tpu_torch import ops
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import checksum
from zultra_tpu_torch.ops.emit_torch import write_tokens

# One intra-op thread in each pytest worker (see tests/test_torch_pipeline.py).
torch.set_num_threads(1)

LENGTHS = [0, 1, 2047, 2048, 2049, 65535, 65536, 65537, 3 * 65536 + 77]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("value", [1, 0xDEADBEEF & 0xFFF0FFF0])
def test_adler32_equals_zlib_and_jax(n, value):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    want = zlib.adler32(data.tobytes(), value)
    assert checksum.adler32(data, value, device="cpu") == want
    assert checksum.adler32(data.tobytes(), value, device="cpu") == want
    assert jax_checksum.adler32_jax(data, value) == want


def test_adler32_all_ff():
    """The largest sums: every byte 255."""
    data = np.full(5 * 65536 + 3, 255, np.uint8)
    assert checksum.adler32(data, device="cpu") == zlib.adler32(data.tobytes())


@pytest.mark.parametrize("split", [0, 1, 2048, 40000, 70001])
def test_combines_equal_zlib_and_jax(split):
    data = mixed_corpus(70001, seed=12)
    a, b = data[:split], data[split:]
    crc_a, crc_b = zlib.crc32(a), zlib.crc32(b)
    ad_a, ad_b = zlib.adler32(a), zlib.adler32(b)
    assert checksum.crc32_combine(crc_a, crc_b, len(b)) == zlib.crc32(data)
    assert checksum.crc32_combine(crc_a, crc_b, len(b)) == jax_checksum.crc32_combine(
        crc_a, crc_b, len(b))
    assert checksum.adler32_combine(ad_a, ad_b, len(b)) == zlib.adler32(data)
    assert checksum.adler32_combine(ad_a, ad_b, len(b)) == jax_checksum.adler32_combine(
        ad_a, ad_b, len(b))


def test_crc32_sharded_equals_zlib():
    data = mixed_corpus(100000, seed=13)
    shards = [data[i : i + 2047] for i in range(0, len(data), 2047)] + [b""]
    assert checksum.crc32_sharded(shards) == zlib.crc32(data)
    assert checksum.crc32_sharded(shards) == jax_checksum.crc32_sharded(shards)


def _encoders(data, best, dynamic):
    lit = HuffmanEncoder(NLITERALSYMS, 15)
    off = HuffmanEncoder(NOFFSETSYMS, 15)
    if not dynamic:
        lit.code_length[:NLITERALSYMS] = [int(x) for x in static_literal_code_lengths()]
        off.code_length[:NOFFSETSYMS] = [int(x) for x in static_offset_code_lengths()]
        lit.build_static_codewords()
        off.build_static_codewords()
        return lit, off
    i = 0
    while i < len(data):
        length = int(best[i, 0])
        if length >= MIN_MATCH_SIZE:
            lit.entropy[int(MATCHLEN_SYMBOL[min(length - MIN_MATCH_SIZE, 255)])] += 1
            offset = int(best[i, 1])
            oidx = offset - 1 if offset <= 256 else 256 + ((offset - 1 - 256) >> 7)
            off.entropy[int(OFFSET_SYMBOL[oidx])] += 1
            i += length
        else:
            lit.entropy[int(data[i])] += 1
            i += 1
    lit.entropy[NEODMARKERSYM] += 1
    lit.build_dynamic_codewords()
    off.build_dynamic_codewords()
    return lit, off


def _bitwriter_tokens(data, best, start, lit, off):
    """The sequential write loop (reference blockdeflate.c:471-507)."""
    buf = bytearray(4 * len(data) + 64)
    bw = BitWriter(buf, 0, len(buf))
    bits = 0
    i = start
    while i < len(data):
        length = int(best[i, 0])
        if length >= MIN_MATCH_SIZE:
            e = length - MIN_MATCH_SIZE
            eidx = min(e, 255)
            lit.write_codeword(int(MATCHLEN_SYMBOL[eidx]), bw)
            bw.put_bits(e - int(MATCHLEN_BASE[eidx]), int(MATCHLEN_EXTRA_BITS[eidx]))
            offset = int(best[i, 1])
            oidx = offset - 1 if offset <= 256 else 256 + ((offset - 1 - 256) >> 7)
            off.write_codeword(int(OFFSET_SYMBOL[oidx]), bw)
            bw.put_bits(offset - int(OFFSET_BASE[oidx]), int(OFFSET_EXTRA_BITS[oidx]))
            bits += lit.code_length[MATCHLEN_SYMBOL[eidx]] + int(MATCHLEN_EXTRA_BITS[eidx])
            bits += off.code_length[OFFSET_SYMBOL[oidx]] + int(OFFSET_EXTRA_BITS[oidx])
            i += length
        else:
            lit.write_codeword(int(data[i]), bw)
            bits += lit.code_length[data[i]]
            i += 1
    lit.write_codeword(NEODMARKERSYM, bw)
    bits += lit.code_length[NEODMARKERSYM]
    bw.flush_bits()
    return bytes(buf[: bw.get_offset()]), bits


TOKEN_CASES = {
    "corpus 20000": (lambda: np.frombuffer(mixed_corpus(20000, seed=21), np.uint8), 0, False),
    "history 4096": (lambda: np.frombuffer(mixed_corpus(9000, seed=22), np.uint8), 4096, False),
    "literal-heavy": (lambda: np.random.default_rng(5).integers(0, 256, 5000, np.uint8), 0, False),
    "match-heavy": (lambda: np.tile(np.frombuffer(b"abcab", np.uint8), 1500), 0, False),
    "dynamic codes": (lambda: np.frombuffer(mixed_corpus(16384, seed=23), np.uint8), 0, True),
    "dynamic, history 3000": (lambda: lz_data(12000, seed=24, alpha=16), 3000, True),
}


@pytest.mark.parametrize("case", list(TOKEN_CASES))
def test_write_tokens_equals_jax_and_bitwriter(case):
    make, start, dynamic = TOKEN_CASES[case]
    data = np.ascontiguousarray(make())
    n = data.shape[0]
    table = native.build_match_table(data, start)
    slit = np.asarray(static_literal_code_lengths(), np.int32)
    slit = np.concatenate([slit, np.zeros(NLITERALSYMS - slit.shape[0], np.int32)])
    soff = np.asarray(static_offset_code_lengths(), np.int32)
    best = native.optimize_matches(slit, soff, data, table, start, n).astype(np.int32)
    lit, off = _encoders(data[start:], best[start:], dynamic)

    ops.reset_launch_counts()
    got = write_tokens(data, best, start, n, lit, off, device="cpu")
    assert ops.launch_counts()["chain"] == 0  # the plain form on a CPU tensor
    assert got == write_tokens_jax(data, best, start, n, lit, off)
    assert got == _bitwriter_tokens(data, best, start, lit, off)


def test_ops_exports_equal_jax():
    """suffix_array, plcp, byte_histogram and token_histogram exported by
    zultra_tpu_torch.ops against the JAX package's exports."""
    data = np.frombuffer(mixed_corpus(3000, seed=31) + bytes(200), np.uint8)
    np.testing.assert_array_equal(ops.suffix_array(data, device="cpu"), suffix_array_jax(data))
    np.testing.assert_array_equal(ops.plcp(data, device="cpu"), plcp_jax(data))
    for tiny in (b"", b"a", b"ab", b"aa"):
        t = np.frombuffer(tiny, np.uint8)
        np.testing.assert_array_equal(ops.suffix_array(t, device="cpu"), suffix_array_jax(t))
        np.testing.assert_array_equal(ops.plcp(t, device="cpu"), plcp_jax(t))
    got = ops.byte_histogram(torch.from_numpy(data.copy()))
    np.testing.assert_array_equal(got.numpy(), byte_histogram_pallas(data, interpret=True))
    syms = np.random.default_rng(32).integers(0, 300, 4000).astype(np.int32)
    np.testing.assert_array_equal(ops.token_histogram(torch.from_numpy(syms)).numpy(),
                                  np.asarray(token_histogram_jax(syms)))
    assert ops.adler32(data, device="cpu") == zlib.adler32(data.tobytes())
