"""The program's spans in the trace (progtrace.py) on synthetic event
lists, the four readers of the program's spans and counters on a
synthetic report, and the tiny cells run with and without the
program's tracer."""

import pytest

from portbench import devtrace, progtrace, spec
from portbench.tests.test_portbench_cell import run_tiny, tiny  # noqa: F401 -- the fixture

MiB = 1 << 20
NEW = ("host_wait_ms_per_MiB", "match_pad_pct", "plan_pad_pct", "graph_replay_pct")
ON_THE_CARD = ("graph_replay_pct",)

# Host ops: (name, start_us, end_us, correlation, thread). Times in us.
OPS = [
    ("portbench.window", 0, 100, 1, 1), ("portbench.call", 0, 90, 2, 1),
    ("zultra.compress", 5, 85, 3, 1), ("zultra.match", 10, 30, 4, 1),
    ("zultra.upload", 10, 15, 5, 1), ("aten::copy_", 11, 12, 6, 1),
    ("zultra.plan", 40, 80, 7, 1), ("zultra.plan.program", 45, 55, 8, 1),
    ("zultra.plan.collect", 60, 75, 9, 1), ("zultra.wait", 62, 74, 10, 1),
]
# Runtime calls: (correlation, linked op, start_us, thread). The
# correlations share numbers with the ops' own: they are another space.
RUNTIME = [(101, 6, 11.5, 1), (102, 4, 20, 1), (103, 8, 50, 1), (104, 0, 32, 1),
           (106, 10, 62.5, 1), (107, 0, -6, 1), (9, 3, 6, 1)]
# Device ops: (name, start_us, end_us, correlation, linked op).
DEV = [
    ("Memcpy HtoD (Pinned -> Device)", 12, 14, 101, 6),  # the upload's copy
    ("void k_match1<8>(int*)", 21, 29, 102, 4),  # a graph launched in zultra.match
    ("k_match2", 29, 35, 102, 4),  # ends after the span: still the match's
    ("k_plan", 51, 58, 103, 8),  # a graph launched in zultra.plan.program
    ("k_plan", 56, 59, 103, 8),  # overlaps the one before: each counts
    ("k_compress", 33, 34, 104, 0),  # no linked op: found by its runtime call
    ("k_runtime", 36, 37, 9, 0),  # runtime call 9, not the op numbered 9
    ("Memcpy DtoH (Device -> Pinned)", 63, 66, 106, 0),  # the runtime call's op
    ("k_early", -5, 3, 107, 0),  # launched before every span, clipped at 0
    ("k_late", 98, 110, 999, 0),  # no runtime call, clipped at 100
]


def test_device_time_on_the_innermost_span():
    r = progtrace.reduce(DEV, OPS, RUNTIME)
    us = 1e-6
    assert r["window_s"] == pytest.approx(100 * us)
    assert r["device_s"] == pytest.approx(36 * us)
    assert r["device_by_span"] == pytest.approx({
        "zultra.match": 14 * us, "zultra.plan.program": 10 * us, "zultra.wait": 3 * us,
        "zultra.upload": 2 * us, "zultra.compress": 2 * us})
    assert r["device_in_span"] == pytest.approx({
        "zultra.compress": 31 * us, "zultra.match": 16 * us, "zultra.upload": 2 * us,
        "zultra.plan": 13 * us, "zultra.plan.program": 10 * us, "zultra.plan.collect": 3 * us,
        "zultra.wait": 3 * us})
    assert r["unattributed_device_s"] == pytest.approx(5 * us)
    assert r["device_s"] == pytest.approx(sum(r["device_by_span"].values())
                                          + r["unattributed_device_s"])
    assert r["device_ops_by_span"]["zultra.match"] == [["k_match1", pytest.approx(8 * us)],
                                                       ["k_match2", pytest.approx(6 * us)]]
    assert r["device_ops_by_span"]["zultra.plan.program"] == [["k_plan", pytest.approx(10 * us)]]


def test_idle_by_span_sums_to_devtraces_idle():
    r = progtrace.reduce(DEV, OPS, RUNTIME)
    us = 1e-6
    assert r["idle_by_span"] == pytest.approx({
        "zultra.compress": 14 * us, "zultra.plan": 11 * us, "zultra.wait": 9 * us,
        "harness": 8 * us, "entry": 7 * us, "zultra.match": 6 * us,
        "zultra.plan.program": 6 * us, "zultra.upload": 3 * us, "zultra.plan.collect": 3 * us})
    d = devtrace.reduce([(n, s, e) for n, s, e, _, _ in DEV],
                        [(n, s, e) for n, s, e, _, _ in OPS if n.startswith("portbench.")])
    idle = d["window_s"] - d["busy_s"]
    assert r["idle_s"] == pytest.approx(idle)
    assert sum(r["idle_by_span"].values()) == pytest.approx(idle)
    # devtrace's device ops are the same ops, by the same names.
    assert sum(v for _, v in d["device_ops"]) == pytest.approx(r["device_s"])


def test_a_span_is_sought_on_the_launching_thread():
    """Thread 2 in zultra.split while thread 1 is in zultra.plan: an op
    launched from thread 2 goes on the split."""
    ops = OPS + [("zultra.split", 40, 50, 20, 2), ("aten::pad", 41, 42, 21, 2)]
    dev = DEV + [("k_split", 70, 71, 108, 21)]
    r = progtrace.reduce(dev, ops, RUNTIME + [(108, 21, 41.5, 2)])
    assert r["device_by_span"]["zultra.split"] == pytest.approx(1e-6)
    assert sum(r["idle_by_span"].values()) == pytest.approx(r["idle_s"])


def test_no_window_or_no_device_work_reads_nothing():
    assert progtrace.reduce(DEV, OPS[1:], RUNTIME) is None
    assert progtrace.reduce([d for d in DEV if d[1] > 200], OPS, RUNTIME) is None
    assert progtrace.segments([]) == []


def test_segments_and_subtract():
    segs = progtrace.segments([("a", 0, 10), ("b", 2, 4), ("c", 4, 6), ("d", 20, 30)])
    assert segs == [[0, 2, ("a",)], [2, 4, ("a", "b")], [4, 6, ("a", "c")], [6, 10, ("a",)],
                    [20, 30, ("d",)]]
    assert progtrace.subtract([[0, 10], [12, 20]], [[2, 3], [5, 13], [19, 25]]) \
        == [[0, 2], [3, 5], [13, 19]]


def read(name, ctx):
    return spec.reader(name)(ctx)


def test_the_four_readers_on_a_synthetic_report(monkeypatch):
    ctx = {"calls": [(0.0, 1.0, MiB, True), (1.0, 2.0, MiB, True)]}
    program = {"spans": {"zultra.wait": {"total_s": 0.010, "calls": 7}},
               "counters": {"match.positions": 32 * 32768, "match.input": 48944,
                            "plan.positions": 4 * 65536, "plan.input": 65536,
                            "program.replay": 99, "program.capture": 1}}
    monkeypatch.setattr(progtrace, "program_report", lambda: program)
    assert read("host_wait_ms_per_MiB", ctx) == pytest.approx(5.0)
    assert read("match_pad_pct", ctx) == pytest.approx(100 * (1 - 48944 / 2**20))
    assert read("plan_pad_pct", ctx) == pytest.approx(75.0)
    assert read("graph_replay_pct", ctx) == pytest.approx(99.0)
    # What a reader's input lacks, it reads as nothing.
    for report in (None, {"spans": {}, "counters": {}}):
        monkeypatch.setattr(progtrace, "program_report", lambda: report)
        for name in NEW:
            assert read(name, ctx) is None, name


def test_program_report_is_the_tracers_and_none_without_one(monkeypatch):
    from zultra_tpu_torch import profiling

    profiling.reset()
    profiling.enable()
    try:
        profiling.count("match.input", 3)
        assert progtrace.program_report()["counters"] == {"match.input": 3}
    finally:
        profiling.enable(False)
        profiling.reset()
    monkeypatch.delattr(profiling, "report")
    assert progtrace.program_report() is None


def test_a_traced_run_reads_the_programs_spans_and_counters(tiny):  # noqa: F811
    """The tracer is on while the window's profiler runs, and only then:
    the report holds the window's calls and not the warm-up's."""
    from zultra_tpu_torch import profiling

    profiling.reset()
    result, info = run_tiny(tiny, "tiny.pool", traced=True)
    assert result["correct"] is True
    got = result["metrics"]
    for name in set(NEW) - set(ON_THE_CARD):
        assert got[name]["value"] > 0, name
    assert not set(ON_THE_CARD) & set(got)  # no graphs on the CPU
    assert not profiling.enabled()
    report = profiling.report(reset=True)
    assert report["spans"]["zultra.compress"]["calls"] == result["attempted"]
    assert report["counters"]["match.input"] == 3000 * result["attempted"]


def test_a_program_without_the_tracer_reads_as_before(tiny, monkeypatch):  # noqa: F811
    from zultra_tpu_torch import profiling

    monkeypatch.delattr(profiling, "report")
    result, info = run_tiny(tiny, "tiny.pool", traced=True)
    assert result["correct"] is True
    got = set(result["metrics"])
    assert not got & set(NEW)
    assert {"entry_ms_per_MiB", "match_ms_per_MiB", "split_ms_per_MiB", "plan_ms_per_MiB",
            "splice_ms_per_MiB"} == got
    assert all(m["value"] > 0 for m in result["metrics"].values())
