"""The port's streaming push API on the CPU (plain forms of the kernels),
at 32 KiB blocks: ``zultra_tpu_torch.Stream`` against ``zultra_tpu.Stream``
on the JAX package's queued ``DeviceWindowEngine`` and against
``zultra_tpu.compress`` on the native engine; several device batches per
stream; the queue's and the stream's errors. Tolerance: exact bytes.
The front ends over ``Stream`` (``ZultraStream``, the CLI and its guarded
arena) are in test_torch_cli.py."""

import zlib

import numpy as np
import pytest
import torch

import zultra_tpu as zt
from zultra_tpu import engine
from zultra_tpu.device_pipeline import DeviceWindowEngine as JaxDeviceWindowEngine
from zultra_tpu.stream import Stream as JaxStream
from zultra_tpu_torch import FINALIZE, Stream, StreamError, device_pipeline
from zultra_tpu_torch.corpus import mixed_corpus, random_bytes
from zultra_tpu_torch.device_pipeline import DeviceWindowEngine

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

BLOCK = 32768


@pytest.fixture()
def native():
    engine.set_engine("native")
    yield
    engine._active_engine = None


def _decode(out, flags, dictionary=None):
    wbits = {0: -15, 1: 15, 2: 31}[flags]
    d = zlib.decompressobj(wbits, zdict=dictionary) if dictionary else zlib.decompressobj(wbits)
    return d.decompress(out) + d.flush()


def _feed(stream, data: bytes, chunk: int) -> bytes:
    out = bytearray()
    for off in range(0, len(data), chunk):
        out += stream.compress(data[off : off + chunk])
    out += stream.compress(b"", FINALIZE)
    return bytes(out)


def test_stream_equals_jax_queued_stream(monkeypatch):
    """Three windows (the last 1531 bytes) in one flush, fed in 50 000-byte
    chunks that straddle windows; the JAX engine queues them too
    (ZULTRA_JAXDEV_QUEUE=1, its own switch for the CPU)."""
    monkeypatch.setenv("ZULTRA_JAXDEV_QUEUE", "1")
    data = mixed_corpus(2 * BLOCK + 1531, seed=71)
    jax_stream = JaxStream(2, BLOCK)
    jax_stream.engine = JaxDeviceWindowEngine()
    assert hasattr(jax_stream.engine, "queue_window")
    want = _feed(jax_stream, data, 50_000)
    got = _feed(Stream(2, BLOCK, device="cpu"), data, 50_000)
    assert got == want
    assert _decode(got, 2) == data


def test_several_device_batches_equal_native(native, monkeypatch):
    """pipeline_depth 2: five windows are planned 2 + 2 + 1, the lone
    short window at the lane width of the full ones (``_mbs_seen`` is kept
    across batches), and the first batches' bytes come out before the
    stream is finalized."""
    batches = []
    real = device_pipeline.begin_windows_batched

    def recording(corpus, spans, mbs, device):
        batches.append((len(spans), mbs))
        return real(corpus, spans, mbs, device)

    monkeypatch.setattr(device_pipeline, "begin_windows_batched", recording)
    data = mixed_corpus(4 * BLOCK + 2000, seed=72)
    stream = Stream(1, BLOCK, device="cpu")
    stream.engine.pipeline_depth = 2
    early = bytearray()
    for off in range(0, len(data), 50_000):
        early += stream.compress(data[off : off + 50_000])
    got = bytes(early) + stream.compress(b"", FINALIZE)
    assert batches == [(2, BLOCK), (2, BLOCK), (1, BLOCK)]
    assert len(early) > 2  # more than the zlib header
    assert got == zt.compress(data, 1, BLOCK)
    assert _decode(got, 1) == data


@pytest.mark.parametrize("name", ["deflate", "zlib", "gzip", "dictionary", "stored"])
def test_stream_equals_native(native, name):
    """Each framing, a preset dictionary and incompressible bytes (the
    stored fallback), fed in 4 KiB chunks."""
    flags = {"deflate": 0, "zlib": 1, "gzip": 2, "dictionary": 1, "stored": 0}[name]
    if name == "stored":
        data = random_bytes(9000, seed=73)
    else:
        data = mixed_corpus(9000, seed=74 + flags)
    dictionary = mixed_corpus(3000, seed=77) if name == "dictionary" else None
    stream = Stream(flags, BLOCK, device="cpu")
    if dictionary:
        stream.set_dictionary(dictionary)
    got = _feed(stream, data, 4096)
    assert got == zt.compress(data, flags, BLOCK, dictionary)
    assert _decode(got, flags, dictionary) == data
    if name == "stored":
        assert len(got) > len(data)


@pytest.mark.parametrize("fault", ["not_consecutive", "history_diverges"])
def test_flush_queue_rejects_broken_windows(fault):
    eng = DeviceWindowEngine("cpu")
    corpus = (np.arange(40000) % 251).astype(np.uint8)
    eng.queue_window(corpus[:10000], 0, 10000)
    if fault == "not_consecutive":
        handle = eng.queue_window(corpus[5000:20000], 5000, 10000)
        match = "not consecutive"
    else:
        window = corpus[:20000].copy()
        window[1234] ^= 1
        handle = eng.queue_window(window, 10000, 10000)
        match = "diverges"
    with pytest.raises(ValueError, match=match):
        handle.result()
    assert eng._queue == []


@pytest.mark.parametrize("case", ["empty_finalize", "after_finish", "dictionary_late",
                                  "dictionary_too_long"])
def test_stream_errors(case):
    stream = Stream(1, BLOCK, device="cpu")
    if case == "empty_finalize":
        with pytest.raises(StreamError, match="empty"):
            stream.compress(b"", FINALIZE)
    elif case == "after_finish":
        stream.compress(b"abcabcabc" * 20, FINALIZE)
        with pytest.raises(StreamError, match="finished"):
            stream.compress(b"more")
    elif case == "dictionary_late":
        stream.compress(b"some input")
        with pytest.raises(StreamError, match="before compressing"):
            stream.set_dictionary(b"dict")
    else:
        with pytest.raises(StreamError, match="history window"):
            stream.set_dictionary(bytes(32769))
