"""The lane width of a one-shot call on the CPU (plain forms of the
kernels), at 256 KiB blocks: ``compress_device`` plans a one-window batch
at its input's length rounded up to a power-of-two count of 32 KiB
segments (``device_pipeline.lane_width``), and a batch that holds a whole
window at the block size. The bytes are those of the block size the
caller gave: each framing, a preset dictionary and incompressible bytes
(the stored fallback) against ``zultra_tpu.compress`` on the native
engine, and the gzip case against the JAX package's ``compress_device``.
Tolerance: exact bytes."""

import zlib

import pytest
import torch

import zultra_tpu as zt
from zultra_tpu import device_pipeline as jax_dp
from zultra_tpu import engine
from zultra_tpu_torch import compress_device, device_pipeline
from zultra_tpu_torch.corpus import mixed_corpus, random_bytes
from zultra_tpu_torch.ops.matchfinder_torch import SEG_CORE

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

BLOCK = 262144


@pytest.fixture()
def native():
    engine.set_engine("native")
    yield
    engine._active_engine = None


@pytest.fixture()
def widths(monkeypatch):
    """(windows, width) of every batch ``compress_device`` launches
    (``launch_windows``)."""
    seen = []
    real = device_pipeline.launch_windows

    def recording(corpus, spans, mbs, device):
        seen.append((len(spans), mbs))
        return real(corpus, spans, mbs, device)

    monkeypatch.setattr(device_pipeline, "launch_windows", recording)
    return seen


class _Planned(Exception):
    pass


@pytest.fixture()
def first_width(monkeypatch):
    """The width of the first batch ``compress_device`` launches, which
    stops the compression there (no planning)."""
    seen = []

    def recording(corpus, spans, mbs, device):
        seen.append((len(spans), mbs))
        raise _Planned

    monkeypatch.setattr(device_pipeline, "launch_windows", recording)
    return seen


def _decode(out, flags, dictionary=None):
    wbits = {0: -15, 1: 15, 2: 31}[flags]
    d = zlib.decompressobj(wbits, zdict=dictionary) if dictionary else zlib.decompressobj(wbits)
    return d.decompress(out) + d.flush()


@pytest.mark.parametrize("name", ["deflate", "zlib", "gzip", "dictionary", "stored"])
def test_narrowed_lane_equals_native(native, widths, name):
    """A small input in each framing, with a preset dictionary, and 32,769
    incompressible bytes, whose lane is two segments wide."""
    flags = {"deflate": 0, "zlib": 1, "gzip": 2, "dictionary": 1, "stored": 2}[name]
    data = random_bytes(SEG_CORE + 1, seed=91) if name == "stored" \
        else mixed_corpus(3000, seed=92 + flags)
    dictionary = mixed_corpus(2000, seed=95) if name == "dictionary" else None
    got = compress_device(data, flags, BLOCK, dictionary, device="cpu")
    assert widths == [(1, 2 * SEG_CORE if name == "stored" else SEG_CORE)]
    assert got == zt.compress(data, flags, BLOCK, dictionary)
    assert _decode(got, flags, dictionary) == data


def test_narrowed_lane_equals_jax_compress_device(widths):
    data = mixed_corpus(3000, seed=96)
    got = compress_device(data, 2, BLOCK, device="cpu")
    assert widths == [(1, SEG_CORE)]
    assert got == jax_dp.compress_device(data, 2, BLOCK)


@pytest.mark.parametrize("size,windows,width", [
    (SEG_CORE, 1, SEG_CORE),
    (SEG_CORE + 1, 1, 2 * SEG_CORE),
    (2 * SEG_CORE + 1, 1, 4 * SEG_CORE),
    (BLOCK + 3000, 2, BLOCK),
], ids=["one_segment", "just_over_one", "just_over_two", "two_windows"])
def test_width_handed_to_the_batch(first_width, size, windows, width):
    """Inputs on each side of a power-of-two boundary, and two windows in
    one batch: the whole first window keeps the block width."""
    with pytest.raises(_Planned):
        compress_device(mixed_corpus(size, seed=97), 2, BLOCK, device="cpu")
    assert first_width == [(windows, width)]


def test_lane_width_takes_six_values_at_1_mib_blocks():
    """A batch's width is its longest span's power-of-two count of
    segments, at most the block size: a long input's lone tail window
    narrows, a batch with a whole window does not, and a block size that
    is no power-of-two count of segments caps the width."""
    mbs = 1 << 20
    sizes = list(range(1, mbs + 1, 4093)) + [mbs]
    assert {device_pipeline.lane_width([(0, n)], mbs) for n in sizes} \
        == {SEG_CORE << i for i in range(6)}
    assert device_pipeline.lane_width([(mbs, mbs + 3000)], mbs) == SEG_CORE
    assert device_pipeline.lane_width([(0, mbs), (mbs, mbs + 3000)], mbs) == mbs
    assert device_pipeline.lane_width([(0, 70000)], 3 * SEG_CORE) == 3 * SEG_CORE
    assert device_pipeline.lane_width([(0, 40000)], 3 * SEG_CORE) == 2 * SEG_CORE
