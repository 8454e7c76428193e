"""The plain reference encoder: zultra's bytes, windows found in a stream
where they belong, and the control (one parse pass fewer) told apart."""

import numpy as np
import pytest

from portbench import check, gen
from portbench.reference import blocks, encode


@pytest.mark.parametrize("kind,size,mbs", [("mixed", 70_000, 32768), ("random", 40_000, 32768),
                                           ("text", 5000, 1 << 20)])
def test_reference_equals_the_ports_cpu_form(kind, size, mbs):
    """The reference and the port's CPU form, two codes that share nothing,
    write the same stream, and zlib inflates it to the input."""
    import zultra_tpu_torch

    rng = np.random.default_rng(5)
    data = {"mixed": lambda: gen.mixed(size, rng), "text": lambda: gen.text(rng, size),
            "random": lambda: rng.integers(0, 256, size, np.uint8).tobytes()}[kind]()
    out = encode.compress_gzip(data, mbs)
    assert out == zultra_tpu_torch.compress(data, 2, mbs, device="cpu")
    assert check.roundtrip_ok(out, data)


@pytest.fixture(scope="module")
def three_windows():
    data = gen.mixed(80_000, np.random.default_rng(9))
    return data, encode.compress_gzip(data, 32768)


def test_every_window_is_found_where_it_belongs(three_windows):
    data, stream = three_windows
    pairs = [(0, 0), (0, 1), (0, 2)]
    refs = check.reference_windows([data], pairs, 32768, 2)
    assert all(check.window_found(stream, k, ref) for (_, k), ref in zip(pairs, refs))
    # Window 1 does not stand in for window 0, nor window 0 shifted by a byte.
    assert not check.window_found(stream, 0, refs[1])
    assert not check.window_found(stream[:10] + b"\0" + stream[10:], 0, refs[0])
    # One flipped bit inside a window hides it.
    bits, end = encode.splice_window(*refs[2][:4], 0, True)
    at = len(stream) - 8 - end // 8
    bad = bytearray(stream)
    bad[at + (end // 8) // 2] ^= 0x10
    assert not check.window_found(bytes(bad), 2, refs[2])


def test_control_one_pass_fewer_is_told_apart(three_windows):
    data, stream = three_windows
    pairs = [(0, 0), (0, 1), (0, 2)]
    sound = check.reference_windows([data], pairs, 32768, 2)
    weak = check.reference_windows([data], pairs, 32768, 2, passes=blocks.CONVERGENCE_PASSES - 1)
    weak_stream = b"\x1f\x8b" + b"\0" * 8 + b"".join(
        encode.splice_window(*w[:4], 0, w[4])[0].to_bytes(1 << 16, "little") for w in weak)
    assert sum(not check.window_found(weak_stream, k, ref) for (_, k), ref in zip(pairs, sound)) >= 1
    assert check.compare([data], [0], [stream], 32768, 1, 3, 2)["ref_mismatch"] == 0


def test_sample_is_drawn_from_the_seed_among_sent_inputs():
    inputs = [b"x" * 100, b"y" * 70_000, b"z" * 10]
    a = check.sample_windows(inputs, [1, 0, 1], 32768, 2, 5)
    assert a == check.sample_windows(inputs, [1, 0], 32768, 2, 5)
    assert all(i in (0, 1) for i, _ in a) and len(a) == 2
    assert check.sample_windows(inputs, [0], 32768, 8, 1) == [(0, 0)]


def test_sample_takes_one_window_from_each_run_of_a_long_input():
    inputs = [b"w" * (96 * 32768 - 5000)]
    seen = set()
    for seed in range(40):
        pairs = check.sample_windows(inputs, [0], 32768, 3, 2**33 + seed)
        assert [k // 32 for _, k in pairs] == [0, 1, 2]
        seen.update(k for _, k in pairs)
    assert len(seen) > 40 and min(seen) <= 5 and max(seen) >= 90
