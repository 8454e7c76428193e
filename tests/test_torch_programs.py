"""The programs of the port (zultra_tpu_torch.ops.programs): the match
stage, the planner and the splitter run as one CUDA graph a shape on the
card, eagerly on the CPU. On the CPU (the match program's own tests are
in tests/test_torch_match_program.py):

- a bucket padded to a power of two lanes (zero-length lanes, dropped)
  plans its real lanes as the JAX package's ``plan_blocks_device_multi``
  does (scan DP on the CPU), every plan field equal;
- the program keys the gzip, zlib and stream golden cases give: the real
  batching code driven with stand-ins for the device work (block ends from
  the native engine), a bounded set, equal across two calls;
- the keys of ``Stream`` and ``begin_window`` over many payload sizes: a
  few power-of-two shapes, whatever the sizes;
- the accounting of ``ops/programs.py`` through a stand-in for capture and
  replay: the first call of a key eager, the second captured, launches
  counted as executed, the least recently used program dropped past the
  bound, keys on the function itself;
- no host sync in the functions that run under a capture (AST).

Tolerance: exact (all integer)."""

import ast
import contextlib
import hashlib
import inspect
import json
import struct
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu import native
from zultra_tpu.ops.block_jax import plan_blocks_device_multi as plan_jax
from zultra_tpu_torch import FINALIZE, Stream, device_pipeline, interop, ops
from zultra_tpu_torch.constants import HISTORY_SIZE, MAX_SPLITS, NCODELENSYMS
from zultra_tpu_torch.corpus import case_inputs, lz_data, mixed_corpus
from zultra_tpu_torch.ops import (
    block_torch,
    dp_cuda,
    entropy_torch,
    matchfinder_torch,
    nsv_torch,
    plan_cuda,
    programs,
    rle_cuda,
    split_torch,
    staircase_torch,
    suffix_cuda,
    suffix_torch,
    symbol_map,
    walk_cuda,
)
from zultra_tpu_torch.ops.chain_cuda import chain_marks_plain
from zultra_tpu_torch.ops.matchfinder_torch import HALO, match_tables_device_stacked
from zultra_tpu_torch.stream import clamp_block_size

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

GOLDEN = Path(__file__).resolve().parent.parent / "zultra_tpu_torch" / "smoke_golden.json"


# ---------------------------------------------------------------------------
# Padded lanes against the JAX planner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_windows():
    """Two 16 KiB windows (the second with the first as history), their
    match tables and the splitter's greedy token marks."""
    mbs = 16384
    corpus = np.frombuffer(mixed_corpus(mbs + 6000, seed=71)
                           + lz_data(mbs - 6000, seed=72, alpha=5, p_match=0.6).tobytes(),
                           np.uint8)
    spans = [(0, mbs), (mbs, 2 * mbs)]
    lens, offs = match_tables_device_stacked(corpus, spans, mbs, "cpu")
    win = np.zeros((2, HALO + mbs), np.uint8)
    win[0, HALO:] = corpus[:mbs]
    win[1, HALO - mbs :] = corpus[: 2 * mbs]
    rl = lens[:, :, 0]
    tok = chain_marks_plain(torch.where(rl >= 3, rl, 1),
                            torch.full((2,), HALO, dtype=torch.int32),
                            torch.full((2,), HALO + mbs, dtype=torch.int32))
    return torch.from_numpy(win), lens, offs, tok


BUCKETS = {  # every lane at most 4096 long: one bucket of n_pad 4096
    "3 lanes": [(0, HALO, 1000), (0, HALO + 1000, 4096), (1, HALO, 3000)],
    "5 lanes": [(0, HALO, 700), (0, HALO + 700, 2000), (1, HALO + 100, 4000),
                (1, HALO + 4100, 3900), (0, HALO + 9000, 50)],
    "1 lane": [(1, HALO + 5000, 4096)],
}


@pytest.fixture(scope="module")
def jax_plans(two_windows):
    """The JAX planner's plan of every lane of BUCKETS, from one call (one
    XLA compile): a lane's plan does not depend on the other lanes."""
    win, lens, offs, tok = two_windows
    lanes = [lane for bucket in BUCKETS.values() for lane in bucket]
    host = interop.state_to_numpy({"lens": lens, "offs": offs, "tok": tok})
    plans = plan_jax(jnp.asarray(win.numpy()), jnp.asarray(host["lens"]),
                     jnp.asarray(host["offs"]), lanes, tok_stack=jnp.asarray(host["tok"]))
    return dict(zip(lanes, plans))


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_padded_bucket_equals_jax(two_windows, jax_plans, bucket, monkeypatch):
    win, lens, offs, tok = two_windows
    lanes = BUCKETS[bucket]
    widths = []
    real_core = block_torch.plan_block_core

    def core(window, *args):
        widths.append(window.shape)
        return real_core(window, *args)

    monkeypatch.setattr(block_torch, "plan_block_core", core)
    got = block_torch.plan_blocks_device_multi(win, lens, offs, lanes, tok)
    assert widths == [(block_torch.padded_lanes(len(lanes)), block_torch.TILE)]
    assert widths[0][0] & (widths[0][0] - 1) == 0 and widths[0][0] >= len(lanes)
    assert len(got) == len(lanes)
    for lane, g in zip(lanes, got):
        w = jax_plans[lane]
        assert w.keys() == g.keys()
        for key in w:
            np.testing.assert_array_equal(np.asarray(w[key]), np.asarray(g[key]), err_msg=key)
            assert np.asarray(w[key]).dtype == np.asarray(g[key]).dtype, key


def test_zero_length_lanes_plan_as_empty_blocks(two_windows):
    """A padded lane (window 0, start 0, length 0) goes through every stage
    of the plain forms and plans the empty block the JAX package plans."""
    win, lens, offs, _ = two_windows
    n = block_torch.TILE
    out = block_torch.plan_block_core(win[:1, :n].expand(2, n), lens[:1, :n].expand(2, n, 8),
                                      offs[:1, :n].expand(2, n, 8),
                                      torch.tensor([0, 100], dtype=torch.int32))
    assert int(out["total_bits"][0]) == 7  # the fixed code's EOD alone
    assert not bool(out["is_dynamic"][0])


# ---------------------------------------------------------------------------
# The program keys of the golden cases
# ---------------------------------------------------------------------------


def _native_block_ends(window: np.ndarray, prev: int, in_size: int) -> list:
    """Block end offsets (window coordinates) of the native engine's plan of
    one window, read from its documented wire format (zultra_native.cpp,
    ``zn_window_serialize``)."""
    handle = native.NativeEngine().begin_window(window, prev, in_size)
    try:
        blob = native.serialize_window(handle)
    finally:
        native.NativeEngine().free_window(handle)
    _, prev_b, in_b, n_plans = struct.unpack_from("<4i", blob, 0)
    assert (prev_b, in_b) == (prev, in_size)
    p = 16 + 5 * (prev + in_size)  # window bytes, then two u16 a position

    def skip_encoder(p):
        n_sym = struct.unpack_from("<H", blob, p)[0]
        return p + 3 + 3 * n_sym

    ends = []
    for _ in range(n_plans):
        start, size = struct.unpack_from("<2i", blob, p)
        dynamic = blob[p + 8]
        p = skip_encoder(skip_encoder(p + 9))
        if dynamic:
            n_lit, n_off = struct.unpack_from("<2i", blob, p + 4)
            p = skip_encoder(p + 12) + n_lit + n_off
        assert start == (ends[-1] if ends else prev)
        ends.append(start + size)
    assert ends[-1] == prev + in_size and p == len(blob)
    return ends


def _golden_keys(case: dict, monkeypatch) -> list:
    """The program keys, in call order, of a one-shot compression of a
    golden case: ``compress_device``'s own batching and bucketing, with the
    match tables, the splitter and the planner stood in for (block ends
    from the native engine, empty plans)."""
    data, dictionary = case_inputs(case)
    corpus = np.frombuffer((dictionary or b"") + data, np.uint8)
    base, mbs = len(dictionary or b""), clamp_block_size(case["block_size"])
    ends = {}  # sha256 of a window's input bytes -> its block ends in lane coordinates
    for lo in range(base, len(corpus), mbs):
        hi = min(lo + mbs, len(corpus))
        prev = min(HISTORY_SIZE, lo)
        window_ends = _native_block_ends(corpus[lo - prev : hi], prev, hi - lo)
        ends[hashlib.sha256(corpus[lo:hi].tobytes()).digest()] = [
            HALO + e - prev for e in window_ends[:-1]]

    def tables(corpus_, spans, mbs_, device):
        z = torch.zeros((len(spans), HALO + mbs_, 8), dtype=torch.int32)
        win = np.zeros((len(spans), HALO + mbs_), np.uint8)
        for w, (lo, hi) in enumerate(spans):
            prev = min(HISTORY_SIZE, lo)
            win[w, HALO - prev : HALO + hi - lo] = corpus_[lo - prev : hi]
        return z, z, torch.from_numpy(win)

    keys = []

    def run(fn, *inputs, **statics):
        keys.append(programs.program_key(fn, inputs, statics))
        if fn is split_torch.split_program:
            win_p, _, _, _, n_real = inputs
            W = win_p.shape[0]
            splits = torch.full((W, MAX_SPLITS), split_torch.INF32, dtype=torch.int32)
            n_splits = torch.zeros(W, dtype=torch.int32)
            for w in range(W):
                e = ends[hashlib.sha256(win_p[w, HALO : int(n_real[w])].numpy().tobytes()).digest()]
                splits[w, : len(e)] = torch.tensor(e, dtype=torch.int32)
                n_splits[w] = len(e)
            return splits, n_splits, torch.zeros(win_p.shape, dtype=torch.bool), \
                torch.zeros(W, dtype=torch.bool)
        B = inputs[3].shape[0]
        return {"is_dynamic": torch.zeros(B, dtype=torch.bool),
                "lit_len": torch.zeros((B, 288), dtype=torch.int32),
                "off_len": torch.zeros((B, 32), dtype=torch.int32),
                "best_mask": torch.zeros(B, dtype=torch.int32),
                "cl_len": torch.zeros((B, NCODELENSYMS), dtype=torch.int32),
                "n_lit": torch.zeros(B, dtype=torch.int32),
                "n_off": torch.zeros(B, dtype=torch.int32),
                "words": torch.zeros((B, 2), dtype=torch.int64),
                "total_bits": torch.zeros(B, dtype=torch.int32)}

    monkeypatch.setattr(device_pipeline, "match_stacks", tables)
    monkeypatch.setattr(programs, "run", run)
    device_pipeline.compress_device(data, case["flags"], case["block_size"], dictionary,
                                    device="cpu")
    return keys


def _check_planner_shapes(shapes) -> None:
    """A planner key's inputs: (B, n_pad) bytes, (B, n_pad, 8) tables,
    (B,) lengths, greedy marks or None; B and n_pad powers of two. The
    window stacks the lanes came from are not part of it."""
    (B, n_pad), dtype = shapes[0]
    assert dtype == "torch.uint8"
    assert shapes[1] == shapes[2] == ((B, n_pad, 8), "torch.int32")
    assert shapes[3] == ((B,), "torch.int32")
    assert shapes[4] in (None, ((B, n_pad), "torch.bool"))
    assert B & (B - 1) == 0 and n_pad & (n_pad - 1) == 0 and n_pad >= block_torch.TILE


def test_program_keys_of_golden_cases_are_few_and_stable(monkeypatch):
    cases = {c["name"]: c for c in json.loads(GOLDEN.read_text())["cases"]}
    all_keys = set()
    for name in ("gzip", "zlib", "stream"):
        keys = _golden_keys(cases[name], monkeypatch)
        assert keys == _golden_keys(cases[name], monkeypatch), name
        mbs = clamp_block_size(cases[name]["block_size"])
        size = len(case_inputs(cases[name])[0])
        n_windows = -(-size // mbs)
        for fn, shapes, statics in keys:
            st = dict(statics)
            if fn is split_torch.split_program:
                # A batch of whole windows is split at the block size; a
                # lone last window (the stream case's 33rd) at its own width.
                W, n = shapes[1][0]
                tail = size - (n_windows - 1) * mbs
                width = mbs if W > 1 else device_pipeline.lane_width([(0, tail)], mbs)
                assert n == split_torch.split_bucket(HALO + width)
                assert st["in_cap"] == split_torch.input_cap(width)
                assert st["trig_cap"] in (0, split_torch.trig_cap_for(st["in_cap"]))
            else:
                assert fn is block_torch.plan_block_core and not statics
                _check_planner_shapes(shapes)
                B, n_pad = shapes[0][0]
                assert B <= block_torch.padded_lanes(n_windows * MAX_SPLITS)
                assert n_pad <= block_torch.lane_bucket(mbs)
                assert shapes[4] is not None  # the splitter's greedy marks
        all_keys |= set(keys)
    # A few programs serve the three cases (8 windows... 33 windows):
    # bounded by the power-of-two lane counts and sizes.
    assert len(all_keys) <= 24, sorted(all_keys)


@pytest.mark.parametrize("path", ["Stream", "begin_window"])
def test_payload_sizes_share_the_programs(path, monkeypatch):
    """Payloads of many sizes under one block size, through ``Stream`` (its
    lane width follows the largest window so far) and the per-window
    ``begin_window`` (a lane as wide as the window): one match, one planner
    and one splitter key serve them all, since a key holds the batch's or
    the bucket's padded shape and not the window's width."""
    data = mixed_corpus(4000, seed=5)
    keys = {}
    real_run = programs.run

    def run(fn, *inputs, **statics):
        keys.setdefault(size, set()).add(programs.program_key(fn, inputs, statics))
        return real_run(fn, *inputs, **statics)

    monkeypatch.setattr(programs, "run", run)
    engine = device_pipeline.DeviceWindowEngine("cpu")
    corpus = np.frombuffer(data, np.uint8)
    for size in (700, 1500, 2600, 3500):
        if path == "Stream":
            stream = Stream(0, 16384, device="cpu")
            out = stream.compress(data[:size]) + stream.compress(b"", FINALIZE)
            assert zlib.decompress(out, -15) == data[:size]
        else:
            engine.begin_window(corpus[: 300 + size], 300, size)
    first = keys[700]
    assert all(k == first for k in keys.values()), keys
    assert sorted(fn.__name__ for fn, _, _ in first) == ["match_program", "plan_block_core",
                                                          "split_program"]
    for fn, shapes, _ in first:
        if fn is block_torch.plan_block_core:
            _check_planner_shapes(shapes)
            assert shapes[0][0] == (1, block_torch.TILE)


# ---------------------------------------------------------------------------
# Launch counts under capture and replay
# ---------------------------------------------------------------------------


class StandInGraphs:
    """Capture and replay stood in for on the CPU: a capture calls the
    function once (its launches go to the capture's counts) and keeps it;
    a replay calls it again into the captured outputs, its launches not
    counted, as a graph's launches are not seen by the wrappers."""

    def __init__(self):
        self.captures = self.replays = 0

    def current(self):
        return contextlib.nullcontext()

    def capture(self, fn, inputs, statics):
        self.captures += 1
        out = fn(*inputs, **statics)

        def graph():
            with ops.capturing_launches():
                for o, n in zip(out, fn(*inputs, **statics)):
                    o.copy_(n)
        return graph, out

    def replay(self, graph):
        self.replays += 1
        graph()


def _fake_program(x, *, k):
    ops.count_launch("dp")
    ops.count_launch("dp")
    ops.count_launch("chain")
    return (x * k,)


def test_launch_counts_under_capture_and_replay():
    """The first call of a key runs eagerly and counts its launches; the
    second captures (counting nothing) and replays (counting the
    captured launches); each later call replays on its own inputs."""
    progs = programs.DevicePrograms(StandInGraphs())
    x = torch.arange(5)
    ops.reset_launch_counts()
    (y,) = progs.run(_fake_program, (x,), {"k": 2})  # eager
    assert torch.equal(y, 2 * x)
    assert ops.launch_counts()["dp"] == 2 and sum(ops.launch_counts().values()) == 3
    assert not progs.programs and progs.graphs.captures == 0

    (y,) = progs.run(_fake_program, (x + 1,), {"k": 2})  # captured, then replayed
    assert torch.equal(y, 2 * (x + 1))
    counts = ops.launch_counts()
    assert (counts["dp"], counts["chain"]) == (4, 2) and sum(counts.values()) == 6
    [prog] = progs.programs.values()
    assert prog.launches == {"dp": 2, "chain": 1}
    assert prog.key == programs.program_key(_fake_program, (x,), {"k": 2})
    assert (progs.graphs.captures, progs.graphs.replays) == (1, 1)

    for i in range(3):  # each replay adds the captured launches
        (y,) = progs.run(_fake_program, (x + 2 + i,), {"k": 2})
        assert torch.equal(y, 2 * (x + 2 + i)) and y.data_ptr() != prog.outputs[0].data_ptr()
        assert torch.equal(prog.inputs[0], x + 2 + i)  # copied into the static buffer
        counts = ops.launch_counts()
        assert (counts["dp"], counts["chain"]) == (4 + 2 * (i + 1), 2 + (i + 1))
    assert (progs.graphs.captures, progs.graphs.replays) == (1, 4)

    progs.run(_fake_program, (x,), {"k": 3})  # another static: another key, eager
    progs.run(_fake_program, (x[:4],), {"k": 2})  # another shape: another key, eager
    assert len(progs.programs) == 1 and len(progs.seen) == 2
    assert (progs.graphs.captures, progs.graphs.replays) == (1, 4)
    assert ops.launch_counts()["dp"] == 10 + 4


def test_programs_are_bounded_least_recent_first():
    """Past MAX_PROGRAMS keys, the least recently used graph (and key seen
    once) goes; a key used again stays."""
    progs = programs.DevicePrograms(StandInGraphs())
    cap = programs.MAX_PROGRAMS
    keep = torch.arange(1)
    for _ in range(2):
        progs.run(_fake_program, (keep,), {"k": 1})
    for n in range(2, cap + 12):
        for _ in range(2):
            progs.run(_fake_program, (torch.arange(n),), {"k": 1})
        progs.run(_fake_program, (keep,), {"k": 1})  # a replay: the most recent again
        progs.run(_fake_program, (torch.arange(n),), {"k": 5})  # seen once
        assert len(progs.programs) <= cap and len(progs.seen) <= cap
    keys = list(progs.programs)
    assert len(keys) == cap
    assert programs.program_key(_fake_program, (keep,), {"k": 1}) in keys
    assert programs.program_key(_fake_program, (torch.arange(2),), {"k": 1}) not in keys
    assert programs.program_key(_fake_program, (torch.arange(cap + 11),), {"k": 1}) in keys
    assert progs.graphs.captures == cap + 11  # each key captured once
    before = progs.graphs.captures
    progs.run(_fake_program, (torch.arange(2),), {"k": 1})  # evicted: eager again
    assert progs.graphs.captures == before


def test_keys_are_the_functions_not_their_names():
    """Two functions of one name (a wrapper, a stand-in) are two programs."""

    def twin(x, *, k):
        return (x + k,)

    first = twin

    def twin(x, *, k):  # noqa: F811 -- the same name on purpose
        return (x - k,)

    assert first.__qualname__ == twin.__qualname__
    progs = programs.DevicePrograms(StandInGraphs())
    x = torch.arange(4)
    for _ in range(3):
        assert torch.equal(progs.run(first, (x,), {"k": 1})[0], x + 1)
        assert torch.equal(progs.run(twin, (x,), {"k": 1})[0], x - 1)
    assert len(progs.programs) == 2
    assert programs.key_text(programs.program_key(twin, (x, None), {"k": 1})) \
        == "test_keys_are_the_functions_not_their_names.<locals>.twin([4] int64, None, k=1)"


def test_launches_of_other_threads_count_during_a_capture():
    """A capture's counts are its thread's: another thread's launches
    during the capture go to the totals."""

    class Capturing(StandInGraphs):
        def capture(self, fn, inputs, statics):
            graph, out = super().capture(fn, inputs, statics)
            t = threading.Thread(target=ops.count_launch, args=("walk",))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            return graph, out

    progs = programs.DevicePrograms(Capturing())
    ops.reset_launch_counts()
    for _ in range(2):  # eager, then captured and replayed
        progs.run(_fake_program, (torch.arange(3),), {"k": 1})
    counts = ops.launch_counts()
    assert (counts["walk"], counts["dp"], counts["chain"]) == (1, 4, 2)
    assert next(iter(progs.programs.values())).launches == {"dp": 2, "chain": 1}


def test_cpu_tensors_call_the_function():
    before = dict(programs._devices)
    assert programs.run(_fake_program, torch.arange(3), k=4)[0].tolist() == [0, 4, 8]
    assert programs._devices == before


# ---------------------------------------------------------------------------
# No host sync under a capture
# ---------------------------------------------------------------------------

# Every function that runs inside the match, planner or splitter program
# on the card (the CPU-only forms it calls on a CPU tensor are not here).
CAPTURED = {
    matchfinder_torch: ("match_program", "segments_from_corpus", "_gather", "salcp_rounds",
                        "assemble_lanes"),
    suffix_torch: ("doubling_rounds_fixed", "stored_rounds", "later_rounds", "_step", "_on_card",
                   "_round", "_sort_rerank", "adjacent_lcp", "pair_lcp"),
    suffix_cuda: ("new_state", "launch_round"),
    walk_cuda: ("walk_segments",),
    block_torch: ("plan_block_core", "token_starts", "token_hist",
                  "offset_workaround", "_match_bits", "post_optimize", "emit_tokens"),
    entropy_torch: ("_scatter_dump", "_lex_order", "mk_inputs", "mk_lengths", "limited_lengths",
                    "kraft_inputs", "_kraft_repair", "build_lengths", "_reverse_bits16",
                    "canonical_codewords", "rle_histogram", "rle_bits", "raw_table_size",
                    "defined_count", "static_cost", "_concat_lengths", "_symbol_and_table_cost",
                    "dynamic_cost_given", "dynamic_cost", "mask_histograms", "mask_search"),
    dp_cuda: ("varlen_tables", "prep_lanes", "run_dp"),
    plan_cuda: ("_lanes", "launch_prep_lanes", "_strided_i32", "launch_token_hist", "num_words",
                "launch_emit_tokens", "launch_lex_order"),
    rle_cuda: ("_check_counts", "optimize_for_rle", "optimize_for_rle_pair"),
    split_torch: ("split_batch", "split_program", "token_structure", "_take", "_put"),
    symbol_map: ("floor_log2", "matchlen_sym_extra_base", "offset_sym_extra_base",
                 "offset_index", "select_by_symbol"),
    staircase_torch: ("staircase_program", "_staircase_rows", "_shift_in"),
    nsv_torch: ("build_sparse_min", "find_left", "find_right"),
}
HOST_CALLS = {"tensor", "as_tensor", "from_numpy", "nonzero", "pin_memory", "synchronize"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}


def _host_syncs(fn) -> list:
    found = []
    for node in ast.walk(ast.parse(inspect.getsource(fn).lstrip())):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("bool", "int", "float") and node.args \
                and not isinstance(node.args[0], ast.Constant):
            found.append(f"{f.id}(...)")
        elif isinstance(f, ast.Attribute) and (f.attr in HOST_METHODS or f.attr in HOST_CALLS):
            found.append(f".{f.attr}()")
    return found


@pytest.mark.parametrize("module", list(CAPTURED), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_no_host_sync_under_a_capture(module):
    found = {name: _host_syncs(getattr(module, name)) for name in CAPTURED[module]}
    assert not {k: v for k, v in found.items() if v}, found


def test_host_sync_guard_finds_syncs():
    def syncs(x):
        y = torch.as_tensor([1, 2], device=x.device)
        return bool(x.any()), x.sum().item(), x.tolist(), y.cpu(), int(x[0])

    assert sorted(_host_syncs(syncs)) == [".as_tensor()", ".cpu()", ".item()", ".tolist()",
                                          "bool(...)", "int(...)"]
