"""``parallel.compress_sharded`` of the port on the CPU (the staircase
sharded over a list of CPU devices, the plain forms of the planner's
kernels) against the JAX ``compress_sharded`` under a mesh and
``zultra_tpu.compress``: gzip at 32 KiB segment cores, zlib with a preset
dictionary, one window's segments split over two devices, and a
zero-heavy input whose segments overflow their membership budget.
Tolerance: exact bytes."""

import zlib

import numpy as np
import pytest
import torch

import zultra_tpu as zt
from zultra_tpu.parallel import compress_sharded as compress_sharded_jax
from zultra_tpu.parallel import make_mesh
from zultra_tpu_torch import StreamError, compress_device
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import staircase_torch
from zultra_tpu_torch.parallel import compress_sharded

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def test_gzip_two_devices_equals_jax_and_compress():
    """Two windows of 32 KiB blocks (the last 12000 bytes), 32 KiB cores,
    over two CPU devices."""
    data = mixed_corpus(32768 + 12000, seed=31)
    got = compress_sharded(data, ["cpu", "cpu"], zt.FLAG_GZIP_FRAMING, 32768, seg_core=32768)
    assert got == compress_sharded_jax(data, make_mesh(n_dp=2), zt.FLAG_GZIP_FRAMING, 32768,
                                       seg_core=32768)
    assert got == zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert zlib.decompress(got, 31) == data


def test_zlib_dictionary_equals_jax_and_compress():
    data = mixed_corpus(32768 + 777, seed=32)
    dictionary = mixed_corpus(4096, seed=33)
    got = compress_sharded(data, ["cpu"], zt.FLAG_ZLIB_FRAMING, 32768, seg_core=32768,
                           dictionary=dictionary)
    assert got == compress_sharded_jax(data, make_mesh(n_dp=1), zt.FLAG_ZLIB_FRAMING, 32768,
                                       seg_core=32768, dictionary=dictionary)
    assert got == zt.compress(data, zt.FLAG_ZLIB_FRAMING, 32768, dictionary=dictionary)
    d = zlib.decompressobj(zdict=dictionary)
    assert d.decompress(got) + d.flush() == data


def test_one_window_split_over_two_devices():
    """One 40000-byte window cut into three 16 KiB segments, shares of two
    and one: the window's segments run on two devices (the JAX mesh's
    ``sp`` axis)."""
    data = mixed_corpus(30000, seed=34) + lz_data(10000, seed=35).tobytes()
    segbufs, metas = staircase_torch.build_segments(np.frombuffer(data, np.uint8),
                                                    [(0, len(data))], 16384)
    assert [m[0] for m in metas] == [0, 0, 0]  # one window, three segments
    got = compress_sharded(data, ["cpu", "cpu"], zt.FLAG_DEFLATE_FRAMING, seg_core=16384)
    assert got == compress_sharded_jax(data, make_mesh(n_dp=1, n_sp=2),
                                       zt.FLAG_DEFLATE_FRAMING, seg_core=16384)
    assert got == zt.compress(data, zt.FLAG_DEFLATE_FRAMING)
    assert zlib.decompress(got, -15) == data


def test_overflowing_segments_equal_jax_and_compress_device(monkeypatch):
    """A zero-heavy input: the segments over the 40 KB zero run overflow
    their membership budget and are walked; the bytes stay equal and the
    counter records them."""
    monkeypatch.setattr(staircase_torch, "FALLBACK_STATS", {"segments": 0, "overflowed": 0})
    data = mixed_corpus(8000, seed=36) + bytes(40000) + mixed_corpus(8000, seed=37)
    got = compress_sharded(data, ["cpu", "cpu"], zt.FLAG_GZIP_FRAMING, 65536, seg_core=16384)
    stats = staircase_torch.FALLBACK_STATS
    assert stats["segments"] == 4 and stats["overflowed"] > 0
    assert got == compress_sharded_jax(data, make_mesh(n_dp=2), zt.FLAG_GZIP_FRAMING, 65536,
                                       seg_core=16384)
    assert got == compress_device(data, zt.FLAG_GZIP_FRAMING, 65536, device="cpu")
    assert zlib.decompress(got, 31) == data


def test_empty_input_raises():
    with pytest.raises(StreamError):
        compress_sharded(b"", ["cpu"])
