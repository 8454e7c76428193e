"""The port's tracer (zultra_tpu_torch.profiling): spans and counters of
the host orchestration, off by default. On the CPU:

- off, ``span`` is one shared no-op and a compression records nothing;
- a running ``torch.profiler`` turns it on without ``enable``, and only
  while it runs;
- on, the bytes are those of the tracer off, in every framing, with and
  without a dictionary;
- on, a compression records every ``zultra.*`` span, as often as its
  batches and buckets imply, and under ``torch.profiler`` the spans are
  ranges nested as the calls are;
- the program counters follow the ``MAX_PROGRAMS`` policy exactly;
- the padding counters equal their formulas, at a lane narrowed to
  its input too;
- the DP's counters count the planner's lanes past ``LONG_LANE``;
- the doubling's counters: the rounds the match program launches, and
  the kept rounds-run tensors summed at report time;
- the counters stay whole under two planning threads.

Every test turns the tracer off again at its end."""

import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from zultra_tpu_torch import device_pipeline, ops, profiling
from zultra_tpu_torch.corpus import mixed_corpus, random_bytes, text_corpus
from zultra_tpu_torch.ops import block_torch, programs, suffix_torch
from zultra_tpu_torch.ops import matchfinder_torch as mt
from zultra_tpu_torch.ops.block_torch import padded_lanes, plan_buckets
from zultra_tpu_torch.ops.matchfinder_torch import HALO, SEG_CORE
from zultra_tpu_torch.ops.split_torch import split_bucket

from test_torch_programs import StandInGraphs

torch.set_num_threads(1)

MBS = 32768
SPANS = ("zultra.compress", "zultra.checksum", "zultra.match", "zultra.upload", "zultra.split",
         "zultra.plan", "zultra.plan.slice", "zultra.plan.program", "zultra.plan.collect",
         "zultra.wait", "zultra.splice")


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


class _Lanes:
    """Records the lanes of every ``plan_blocks_device_multi`` call, wrapped
    at the name by which ``device_pipeline`` calls it."""

    def __enter__(self):
        self.calls, self.saved = [], device_pipeline.plan_blocks_device_multi

        def plan(*args, **kwargs):
            self.calls.append(list(args[3]))
            return self.saved(*args, **kwargs)

        device_pipeline.plan_blocks_device_multi = plan
        return self

    def __exit__(self, *exc):
        device_pipeline.plan_blocks_device_multi = self.saved


def _traced(data, block=MBS, **kwargs):
    """(output, report, lanes of each planner call) of a compression with
    the tracer on."""
    profiling.enable()
    try:
        with _Lanes() as lanes:
            out = device_pipeline.compress_device(data, 2, block, device="cpu", **kwargs)
    finally:
        profiling.enable(False)
    return out, profiling.report(reset=True), lanes.calls


@pytest.fixture(scope="module")
def two_windows():
    """Two whole windows, one a batch, under a CPU profiler with the tracer
    on: (data, output, report, the profiler's zultra.* ranges, the lanes
    of each planner call)."""
    data = mixed_corpus(2 * MBS, seed=61)
    profiling.reset()
    with profiling.trace(device="cpu") as prof:
        out, report, lanes = _traced(data, windows_per_batch=1)
    ranges = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events() if ev.name().startswith("zultra.")]
    return data, out, report, ranges, lanes


def test_off_span_is_one_noop_and_nothing_is_recorded():
    assert not profiling.enabled()
    a, b = profiling.span("zultra.x"), profiling.span("zultra.y")
    assert a is b
    with a:
        profiling.count("x", 5)
    out = device_pipeline.compress_device(mixed_corpus(3000, seed=62), 2, MBS, device="cpu")
    assert zlib.decompress(out, 31) == mixed_corpus(3000, seed=62)
    report = profiling.report()
    assert report["spans"] == {} and report["counters"] == {}
    assert report["launches"] == ops.launch_counts()


def test_a_running_profiler_turns_the_tracer_on():
    data = mixed_corpus(3000, seed=64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.enabled() and profiling.span("zultra.x") is not profiling.span("zultra.x")
        out = device_pipeline.compress_device(data, 2, MBS, device="cpu")
    assert not profiling.enabled()
    assert profiling.span("zultra.x") is profiling.span("zultra.y")
    profiling.count("match.input", 5)  # after the profiler: not counted
    report = profiling.report()
    assert report["spans"]["zultra.compress"]["calls"] == 1
    assert report["counters"]["match.input"] == len(data)
    assert sum(ev.name() == "zultra.compress" for ev in prof.profiler.kineto_results.events()) == 1
    assert zlib.decompress(out, 31) == data


@pytest.mark.parametrize("flags", [0, 1, 2], ids=["raw", "zlib", "gzip"])
@pytest.mark.parametrize("dictionary", [None, b"the quick brown fox " * 50],
                         ids=["nodict", "dict"])
def test_bytes_equal_on_and_off(flags, dictionary):
    data = mixed_corpus(3000, seed=63 + flags)
    off = device_pipeline.compress_device(data, flags, MBS, dictionary, device="cpu")
    profiling.enable()
    on = device_pipeline.compress_device(data, flags, MBS, dictionary, device="cpu")
    profiling.enable(False)
    assert on == off
    assert profiling.report()["spans"]["zultra.compress"]["calls"] == 1


def test_every_span_with_the_calls_its_batches_imply(two_windows):
    data, out, report, *_ = two_windows
    assert zlib.decompress(out, 31) == data
    spans, counters = report["spans"], report["counters"]
    assert set(spans) == set(SPANS)
    calls = {name: s["calls"] for name, s in spans.items()}
    buckets = counters["plan.buckets"]
    assert buckets >= 2  # at least one a batch
    assert calls == {"zultra.compress": 1, "zultra.checksum": 1, "zultra.match": 2,
                     "zultra.upload": 2, "zultra.split": 2, "zultra.plan": 2,
                     "zultra.plan.slice": buckets, "zultra.plan.program": buckets,
                     "zultra.plan.collect": buckets,
                     "zultra.wait": 2 + (counters["split.retry"] > 0) + buckets,
                     "zultra.splice": 2}
    assert all(s["total_s"] > 0 for s in spans.values())
    assert spans["zultra.compress"]["total_s"] >= spans["zultra.plan"]["total_s"]
    # Nothing of the programs' cache on the CPU: the functions run directly.
    assert not any(k.startswith("program.") for k in counters)
    assert counters["h2d.bytes"] > 2 * MBS and counters["d2h.bytes"] > 0


def test_spans_nest_as_ranges_under_the_profiler(two_windows):
    _, _, _, ranges, _ = two_windows
    names = {n for n, _, _ in ranges}
    assert names == set(SPANS)

    def inside(inner, outer):
        return [r for r in ranges if r[0] == inner
                and any(o[1] <= r[1] and r[2] <= o[2] for o in ranges if o[0] == outer)]

    collects = [r for r in ranges if r[0] == "zultra.plan.collect"]
    assert collects and inside("zultra.plan.collect", "zultra.plan") == collects
    waits_in_collect = inside("zultra.wait", "zultra.plan.collect")
    assert len(waits_in_collect) == len(collects)
    assert inside("zultra.upload", "zultra.match") == [r for r in ranges if r[0] == "zultra.upload"]
    outer = [r for r in ranges if r[0] == "zultra.compress"]
    assert len(outer) == 1
    assert all(outer[0][1] <= r[1] and r[2] <= outer[0][2] for r in ranges)


def test_program_counters_follow_the_policy():
    """A key's first call is eager, its second a capture, later ones
    replays; a graph dropped past MAX_PROGRAMS is an eviction (a key seen
    once and forgotten is not); an evicted key runs eagerly again."""
    progs = programs.DevicePrograms(StandInGraphs())
    cap = programs.MAX_PROGRAMS

    def fn(x, *, k):
        return (x * k,)

    profiling.enable()
    try:
        for _ in range(4):  # eager, capture, replay, replay
            progs.run(fn, (torch.arange(1),), {"k": 1})
        for n in range(2, cap + 5):  # cap + 3 more graphs: 4 evictions
            for _ in range(2):
                progs.run(fn, (torch.arange(n),), {"k": 1})
        for n in range(cap + 3):  # keys seen once, past the bound of seen keys
            progs.run(fn, (torch.arange(n + 1),), {"k": 7})
        progs.run(fn, (torch.arange(1),), {"k": 1})  # evicted: eager again
    finally:
        profiling.enable(False)
    c = profiling.report()["counters"]
    assert c["program.replay"] == 2
    assert c["program.capture"] == 1 + cap + 3 == progs.graphs.captures
    assert c["program.evict"] == 4
    assert c["program.eager"] == 1 + (cap + 3) + (cap + 3) + 1
    assert c["program.capture_s"] > 0
    assert len(progs.programs) == cap


@pytest.mark.parametrize("size,block,width", [(3000, MBS, MBS), (2 * MBS, MBS, MBS),
                                              (3000, 4 * SEG_CORE, SEG_CORE)],
                         ids=["far_below_the_block", "whole_windows", "narrowed_lane"])
def test_padding_counters_equal_their_formulas(size, block, width, two_windows):
    """At 32 KiB blocks a lane is the block wide; a small input under a
    block four segments wide is planned at a one-segment lane, and counts
    one narrowed batch."""
    if size == 2 * MBS:
        _, _, report, _, lanes = two_windows
        batches = [[(0, MBS)], [(MBS, 2 * MBS)]]
    else:
        _, report, lanes = _traced(mixed_corpus(size, seed=64), block)
        batches = [[(0, size)]]
    c = report["counters"]
    k = -(-width // SEG_CORE)
    assert c["match.positions"] == sum(len(b) * k * SEG_CORE for b in batches)
    assert c["match.input"] == size
    assert c["split.positions"] == sum(len(b) * split_bucket(HALO + width) for b in batches)
    assert c["split.input"] == sum(HALO + hi - lo for b in batches for lo, hi in b)
    assert c["lane.narrowed"] == (len(batches) if width < block else 0)
    # The planner's lanes are the blocks: their lengths sum to the input,
    # each bucket padded to a power of two lanes of its width.
    assert len(lanes) == len(batches)
    buckets = [b for call in lanes for b in plan_buckets(call)]
    assert c["plan.input"] == size == sum(ln for call in lanes for _, _, ln in call)
    assert c["plan.positions"] == sum(padded_lanes(len(idxs)) * n_pad for n_pad, idxs in buckets)
    assert c["plan.buckets"] == len(buckets)
    if size < block:
        assert 100 * (1 - c["match.input"] / c["match.positions"]) > 90
    else:
        assert c["match.input"] == c["match.positions"]


def test_doubling_round_counters(two_windows):
    """``match.rounds``: the 17 rounds a segment the match program launches;
    ``match.rounds_run``: the sum of its kept rounds-run tensors, the rounds
    each segment ran before its ranks were distinct. Off, nothing is kept;
    a reset drops what was."""
    data, _, report, _, _ = two_windows
    c = report["counters"]
    assert c["match.rounds"] == 2 * 17
    corpus = np.frombuffer(data, np.uint8)
    want = 0
    for span in ([(0, MBS)], [(MBS, 2 * MBS)]):
        corpus_dev, meta, W, k = mt.upload_batch(corpus, span, MBS, "cpu")
        bufs = mt.segments_from_corpus(corpus_dev, meta[: W * k], mt.SEG_LEN)
        want += int(suffix_torch.doubling_rounds(bufs, store_levels=8)[2].sum())
    assert c["match.rounds_run"] == want and 2 <= want < 2 * 17
    profiling.keep("kept", torch.ones(3, dtype=torch.int32))  # off: not kept
    assert "kept" not in profiling.report()["counters"]
    profiling.enable()
    profiling.keep("kept", torch.ones(3, dtype=torch.int32))
    assert profiling.report()["counters"]["kept"] == 3
    profiling.reset()
    assert "kept" not in profiling.report()["counters"]


def test_dp_counters_count_long_lanes(monkeypatch):
    """With LONG_LANE lowered to 4000, a window of 20,000 B of text and
    12,768 random bytes plans lanes of 2965, 17,058 and 12,745
    positions: dp.long_lanes and dp.long_positions count the two past
    4000, and their positions."""
    monkeypatch.setattr(block_torch, "LONG_LANE", 4000)
    data = text_corpus(20000, 8) + random_bytes(MBS - 20000, 8)
    out, report, lanes = _traced(data)
    assert zlib.decompress(out, 31) == data
    assert sorted(ln for call in lanes for _, _, ln in call) == [2965, 12745, 17058]
    c = report["counters"]
    assert (c["dp.long_lanes"], c["dp.long_positions"]) == (2, 12745 + 17058)


def test_counters_whole_under_two_threads(two_windows):
    """Two planning threads (two CPU devices, a window each) count what
    one thread counts batch by batch; and bare counts from threads that
    switch as often as the interpreter can lose none."""
    data, out, report, *_ = two_windows
    got, got_report, _ = _traced(data, windows_per_batch=1, devices=["cpu", "cpu"])
    assert got == out
    assert got_report["counters"] == report["counters"]
    assert {k: s["calls"] for k, s in got_report["spans"].items()} \
        == {k: s["calls"] for k, s in report["spans"].items()}

    per_thread = 5000

    def bump():
        for _ in range(per_thread):
            profiling.count("bump")
            with profiling.span("zultra.bump"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    try:
        threads = [threading.Thread(target=bump) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        profiling.enable(False)
    r = profiling.report()
    assert r["counters"]["bump"] == 2 * per_thread
    assert r["spans"]["zultra.bump"]["calls"] == 2 * per_thread


def test_stage_timer_stays_on_and_shares_the_totals():
    """``stage_timer`` times with the tracer off; its totals are among the
    report's spans, and ``reset`` clears them."""
    with profiling.stage_timer("unit"):
        pass
    assert profiling.stage_report()["unit"]["calls"] == 1
    assert profiling.report()["spans"]["unit"]["calls"] == 1
    profiling.reset()
    assert profiling.stage_report() == {} and profiling.report()["spans"] == {}
