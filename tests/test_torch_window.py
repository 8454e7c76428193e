"""The port's per-window forms and batch options on the CPU (plain forms of
the kernels), each held against the JAX function it ports, with exact
equality (all integer; bytes for bytes):

* ``begin_window_device`` / ``DeviceWindowEngine.begin_window``: split
  points and every plan dict against zultra_tpu's ``begin_window_device``
  (which lays the window in a ``_split_bucket(n)`` lane, where the port
  lays it in a HALO + mbs lane), and a stream of per-window plans
  against ``compress_device``;
* ``match_table_device`` / ``match_table`` against ``match_table_device``,
  ``match_table_jax`` and ``matchfinder.find_all_matches``, also with
  more history than HALO (the host walk, whose host copies equal the
  JAX package's);
* ``block_split`` (with its overflow retry), ``plan_blocks`` and
  ``plan_blocks_device`` against split_jax / block_jax;
* ``compress_device`` at ``windows_per_batch`` 1, 2 and 16 and with
  ``devices=["cpu", "cpu"]`` against JAX ``compress_device`` with and
  without ``mesh=``.

Inputs are seeded ``zultra_tpu_torch.corpus`` bytes of at most two 32 KiB
windows."""

import ast
import inspect
import textwrap
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zultra_tpu.device_pipeline as jax_dp
import zultra_tpu.matchfinder as jax_matchfinder
import zultra_tpu.suffix as jax_suffix
import zultra_tpu_torch.matchfinder as port_matchfinder
import zultra_tpu_torch.suffix as port_suffix
from zultra_tpu.ops.block_jax import plan_blocks as plan_blocks_jax
from zultra_tpu.ops.block_jax import plan_blocks_device as plan_blocks_device_jax
from zultra_tpu.ops.matchfinder_jax import match_table_device as match_table_device_jax
from zultra_tpu.ops.matchfinder_jax import match_table_jax
from zultra_tpu.ops.split_jax import block_split_jax
from zultra_tpu.parallel import make_mesh
from zultra_tpu_torch import compress_device, frame
from zultra_tpu_torch.constants import HISTORY_SIZE
from zultra_tpu_torch.corpus import mixed_corpus
from zultra_tpu_torch.device_pipeline import (
    DeviceWindowEngine,
    begin_window_device,
    emit_window_from_plan,
)
from zultra_tpu_torch.ops import split_torch
from zultra_tpu_torch.ops.block_torch import plan_blocks, plan_blocks_device
from zultra_tpu_torch.ops.matchfinder_torch import HALO, match_table, match_table_device
from zultra_tpu_torch.ops.split_torch import block_split
from zultra_tpu_torch.stream import memory_bound

# One intra-op thread in each pytest worker (see tests/test_torch_pipeline.py).
torch.set_num_threads(1)

PREV, IN_SIZE = 4096, 20000  # one window: 4 KiB of history, then its input
WINDOW = np.frombuffer(mixed_corpus(PREV + IN_SIZE, seed=5), np.uint8)
DATA = mixed_corpus(32768 + 9000, seed=3)  # two windows at 32 KiB blocks
PLAN_KEYS = ("is_dynamic", "lit_len", "off_len", "best_mask", "cl_len", "n_lit", "n_off",
             "total_bits", "words")


@pytest.fixture(scope="module")
def jax_window():
    return jax_dp.begin_window_device(WINDOW, PREV, IN_SIZE)


@pytest.fixture(scope="module")
def jax_tables():
    lens, offs = match_table_device_jax(WINDOW, PREV, PREV + IN_SIZE)
    return np.asarray(lens).astype(np.int32), np.asarray(offs).astype(np.int32)


@pytest.fixture(scope="module")
def jax_bytes():
    return jax_dp.compress_device(DATA, 2, 32768)


def assert_plans_equal(got: list, want: list):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w) == sorted(PLAN_KEYS), b
        for key in PLAN_KEYS:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]),
                                          err_msg=f"block {b}: {key}")


def emit_one(handle) -> bytes:
    buf = bytearray(memory_bound(IN_SIZE))
    n, bits_data, bits_count = emit_window_from_plan(handle, True, buf, 0, 0)
    return bytes(buf[:n]), bits_data, bits_count


def test_begin_window_equals_jax(jax_window):
    got = DeviceWindowEngine("cpu").begin_window(WINDOW, PREV, IN_SIZE)
    assert got.block_spans == jax_window.block_spans
    assert len(got.block_spans) > 1  # the window has a split point
    assert (got.prev, got.in_size) == (PREV, IN_SIZE)
    assert_plans_equal(got.plans, jax_window.plans)
    assert emit_one(got) == emit_one(jax_window)


def test_begin_window_history_beyond_reach():
    """More history than a match can reach (the streaming core never
    makes it): the same blocks, in the caller's window coordinates, as
    the window cut to its last HISTORY_SIZE bytes of history."""
    cut = 5000
    longer = np.concatenate([np.frombuffer(mixed_corpus(cut, seed=8), np.uint8),
                             np.frombuffer(mixed_corpus(HISTORY_SIZE + 9000, seed=9), np.uint8)])
    prev = cut + HISTORY_SIZE
    got = begin_window_device(longer, prev, 9000, device="cpu")
    want = begin_window_device(longer[cut:], HISTORY_SIZE, 9000, device="cpu")
    assert got.block_spans == [(s + cut, e + cut) for s, e in want.block_spans]
    assert got.prev == prev and got.window is not None and len(got.window) == len(longer)
    assert_plans_equal(got.plans, want.plans)


def test_per_window_stream_equals_one_shot(jax_bytes):
    """Every window of DATA planned alone through the engine's per-window
    contract and emitted in order: the bytes of compress_device."""
    engine = DeviceWindowEngine("cpu")
    corpus = np.frombuffer(DATA, np.uint8)
    out = bytearray(frame.encode_header(2, None))
    buf = bytearray(memory_bound(32768, 2, 32768))
    bits_data = bits_count = 0
    spans = [(lo, min(lo + 32768, len(DATA))) for lo in range(0, len(DATA), 32768)]
    for i, (lo, hi) in enumerate(spans):
        prev = min(HISTORY_SIZE, lo)
        handle = engine.begin_window(corpus[lo - prev : hi], prev, hi - lo)
        n, bits_data, bits_count = engine.emit_window(handle, i + 1 == len(spans), buf,
                                                      bits_data, bits_count)
        engine.free_window(handle)
        out += buf[:n]
    out += frame.encode_footer(2, frame.update_checksum(frame.init_checksum(2), corpus, 2),
                               len(DATA))
    assert bytes(out) == jax_bytes


def test_match_tables_equal_jax(jax_tables):
    end = PREV + IN_SIZE
    lens, offs = match_table_device(WINDOW, PREV, end, device="cpu")
    np.testing.assert_array_equal(lens.numpy(), jax_tables[0])
    np.testing.assert_array_equal(offs.numpy(), jax_tables[1])
    assert not lens[:PREV].any() and lens[PREV:].any()
    table = match_table(WINDOW, PREV, end, device="cpu")
    assert table.dtype == np.int32 and table.shape == (end, 8, 2)
    np.testing.assert_array_equal(table, np.stack(jax_tables, axis=2))
    np.testing.assert_array_equal(table, jax_matchfinder.find_all_matches(WINDOW.copy(), PREV, end))
    np.testing.assert_array_equal(DeviceWindowEngine("cpu").find_all_matches(WINDOW, PREV, end),
                                  table)


def test_match_table_history_beyond_halo():
    """start > HALO: the port's host walk against match_table_jax (the JAX
    package's host walk) and find_all_matches."""
    window = np.frombuffer(mixed_corpus(HALO + 400 + 3000, seed=7), np.uint8)
    start, end = HALO + 400, len(window)
    got = match_table(window, start, end, device="cpu")
    np.testing.assert_array_equal(got, match_table_jax(window, start, end))
    np.testing.assert_array_equal(got, jax_matchfinder.find_all_matches(window.copy(), start, end))
    assert got[start:].any()


def _body(fn) -> str:
    f = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    if isinstance(f.body[0], ast.Expr) and isinstance(f.body[0].value, ast.Constant):
        f.body = f.body[1:]
    return ast.dump(f)


@pytest.mark.parametrize("port,ref,name", [
    (port_matchfinder, jax_matchfinder, "build_intervals"),
    (port_matchfinder, jax_matchfinder, "MatchFinder"),
    (port_matchfinder, jax_matchfinder, "find_all_matches"),
    (port_suffix, jax_suffix, "suffix_array_numpy"),
    (port_suffix, jax_suffix, "plcp_numpy"),
])
def test_host_walk_is_a_copy(port, ref, name):
    """The host walk's modules are the JAX package's code (docstrings aside)."""
    assert _body(getattr(port, name)) == _body(getattr(ref, name))


def test_block_split_equals_jax(jax_window, monkeypatch):
    table = match_table(WINDOW, PREV, PREV + IN_SIZE, device="cpu")
    got = block_split(WINDOW, table, PREV, IN_SIZE, device="cpu")
    assert got == block_split_jax(WINDOW, table, PREV, IN_SIZE)
    assert got == [e for _, e in jax_window.block_spans]
    # The overflow retry: a budget of one triggered candidate a level
    # overflows, and the exact rerun gives the same split points.
    calls = []
    real = split_torch.split_batch

    def counting(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(split_torch, "split_batch", counting)
    monkeypatch.setattr(split_torch, "trig_cap_for", lambda cap: 1)
    assert block_split(WINDOW, table, PREV, IN_SIZE, device="cpu") == got
    assert calls == [1, 0]


def test_plan_blocks_equal_jax(jax_tables):
    # Two blocks in the 16384 bucket: the kernel shape begin_window_device
    # already compiled.
    spans = [(PREV, PREV + 10000), (PREV + 10000, PREV + IN_SIZE)]
    table = np.stack(jax_tables, axis=2)
    want = plan_blocks_jax(WINDOW, table, spans)
    assert_plans_equal(plan_blocks(WINDOW, table, spans, device="cpu"), want)
    win = torch.from_numpy(WINDOW.copy())
    got_dev = plan_blocks_device(win, torch.from_numpy(jax_tables[0]),
                                 torch.from_numpy(jax_tables[1]), spans)
    want_dev = plan_blocks_device_jax(jnp.asarray(WINDOW), jnp.asarray(jax_tables[0], jnp.uint16),
                                      jnp.asarray(jax_tables[1], jnp.uint16), spans)
    assert_plans_equal(got_dev, want_dev)
    assert_plans_equal(got_dev, want)


def test_compress_device_mesh_equals_devices(jax_bytes):
    """JAX's mesh form (two devices, one window each) and the port's
    ``devices`` form (two CPU devices on two threads, one window each)."""
    mesh = make_mesh(n_dp=2, n_sp=1, devices=jax.devices()[:2])
    want = jax_dp.compress_device(DATA, 2, 32768, windows_per_batch=1, mesh=mesh)
    assert want == jax_bytes
    got = compress_device(DATA, 2, 32768, windows_per_batch=1, devices=["cpu", "cpu"])
    assert got == want


@pytest.mark.parametrize("windows_per_batch", [1, 2, 16])
def test_windows_per_batch_equals_jax(jax_bytes, windows_per_batch):
    got = compress_device(DATA, 2, 32768, windows_per_batch=windows_per_batch, device="cpu")
    assert got == jax_bytes
    assert zlib.decompress(got, 31) == DATA
