"""The port's one-shot path on the CPU against zultra_tpu's native
engine (the same oracle the card run uses, where JAX is absent): deflate,
zlib and gzip framing, a preset dictionary, incompressible data (stored
fallback), the per-window engine under zultra_tpu's Stream, and the
empty-input error. Tolerance: exact bytes."""

import zlib

import numpy as np
import pytest
import torch

import zultra_tpu as zt
from zultra_tpu import engine
from zultra_tpu.stream import FINALIZE, Stream
from zultra_tpu_torch import DeviceWindowEngine, compress
from zultra_tpu_torch.stream import StreamError
from zultra_tpu_torch.corpus import lz_data, mixed_corpus

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


@pytest.fixture()
def native():
    engine.set_engine("native")
    yield
    engine._active_engine = None


def _decode(out, flags, dictionary=None):
    wbits = {0: -15, 1: 15, 2: 31}[flags]
    d = zlib.decompressobj(wbits, zdict=dictionary) if dictionary else zlib.decompressobj(wbits)
    return d.decompress(out) + d.flush()


@pytest.mark.parametrize("flags,seed", [(0, 51), (1, 52), (2, 53)])
def test_framings_equal_native(native, flags, seed):
    data = mixed_corpus(30000, seed=seed) + lz_data(12000, seed=seed, alpha=7).tobytes()
    got = compress(data, flags, 32768, device="cpu")
    assert got == zt.compress(data, flags, 32768)
    assert _decode(got, flags) == data


@pytest.mark.parametrize("name", ["one_byte", "one_past_a_window", "zeros", "period6"])
def test_edge_inputs_equal_native(native, name):
    """A one-byte stream, a last window of one byte, a long zero run and
    a short-period run (the inputs where the JAX staircase needs its
    host fallback)."""
    data = {
        "one_byte": b"a",
        "one_past_a_window": mixed_corpus(32769, seed=58),
        "zeros": bytes(70000),
        "period6": np.tile(np.frombuffer(b"abcabd", np.uint8), 9000).tobytes(),
    }[name]
    got = compress(data, 2, 32768, device="cpu")
    assert got == zt.compress(data, 2, 32768)
    assert _decode(got, 2) == data


def test_dictionary_equals_native(native):
    dictionary = mixed_corpus(3000, seed=54)
    data = dictionary[1000:] + mixed_corpus(20000, seed=55)
    got = compress(data, 1, 32768, dictionary=dictionary, device="cpu")
    assert got == zt.compress(data, 1, 32768, dictionary=dictionary)
    assert _decode(got, 1, dictionary) == data


def test_stored_fallback_equals_native(native):
    data = np.random.default_rng(56).integers(0, 256, 40000, dtype=np.uint8).tobytes()
    got = compress(data, 0, 32768, device="cpu")
    assert got == zt.compress(data, 0, 32768)
    assert len(got) > len(data)  # stored blocks
    assert _decode(got, 0) == data


def test_stream_with_port_engine_equals_native(native):
    data = mixed_corpus(36000, seed=57)
    stream = Stream(2, 32768)
    stream.engine = DeviceWindowEngine("cpu")
    got = stream.compress(data[:20000]) + stream.compress(data[20000:], FINALIZE)
    assert got == zt.compress(data, 2, 32768)


def test_empty_input_raises():
    with pytest.raises(StreamError):
        compress(b"", 2, device="cpu")
