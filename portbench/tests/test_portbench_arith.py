"""The metric arithmetic on synthetic inputs."""

import pytest

from portbench import devtrace, spec
from portbench.roofline import dp

MiB = 1 << 20


def read(name, ctx):
    return spec.reader(name)(ctx)


def test_rate_is_over_the_whole_window():
    # Three calls of 1 MB each; the window runs 0 -> 4 s with a gap
    # between calls that the rate must count.
    calls = [(0.0, 1.0, 10**6, True), (1.5, 2.5, 10**6, True), (3.0, 4.0, 10**6, True)]
    assert read("MBps", {"calls": calls, "window_s": 4.0}) == pytest.approx(0.75)
    # A failed call's bytes do not count.
    calls[1] = (1.5, 2.5, 10**6, False)
    assert read("MBps", {"calls": calls, "window_s": 4.0}) == pytest.approx(0.5)


def test_p95_is_of_every_call():
    calls = [(0.0, 0.001 * (i + 1), 100, True) for i in range(100)]  # 1..100 ms
    assert read("file_p95_ms", {"calls": calls}) == pytest.approx(95.05)
    assert read("file_p95_ms", {"calls": calls[:1]}) == pytest.approx(1.0)


def test_setup_is_passed_through():
    assert read("setup_s", {"setup_s": 12.5}) == 12.5


def test_stage_metrics_per_MiB_and_entry():
    calls = [(0.0, 1.0, MiB, True), (1.0, 2.0, MiB, True)]
    stages = {"match_stacks": 0.4, "split_batch": 0.2, "plan_blocks_device_multi": 0.6,
              "emit_window_from_plan": 0.3}
    ctx = {"calls": calls, "stage_s": stages}
    assert read("match_ms_per_MiB", ctx) == pytest.approx(200.0)
    assert read("split_ms_per_MiB", ctx) == pytest.approx(100.0)
    assert read("plan_ms_per_MiB", ctx) == pytest.approx(300.0)
    assert read("splice_ms_per_MiB", ctx) == pytest.approx(150.0)
    assert read("entry_ms_per_MiB", ctx) == pytest.approx(250.0)
    # A stage the program lacks reads nothing, and so does the entry.
    del stages["split_batch"]
    assert read("split_ms_per_MiB", ctx) is None
    assert read("entry_ms_per_MiB", ctx) is None
    assert read("match_ms_per_MiB", {"calls": calls}) is None


def test_union_of_device_intervals():
    assert devtrace.union([(5, 7), (0, 2), (1, 3), (6, 6.5), (8, 9)]) == [[0, 3], [5, 7], [8, 9]]
    # Overlapping kernels count once: 0-3, 5-7 busy in a 0-10 window.
    host = [("portbench.window", 0.0, 10e6), ("portbench.call", 0.0, 8e6),
            ("portbench.emit_window_from_plan", 3e6, 5e6)]
    dev = [("void dp_spec_kernel<4>(int const*)", 0.0, 2e6), ("k2", 1e6, 3e6), ("k3", 5e6, 7e6),
           ("Memcpy HtoD", 6e6, 7e6)]
    r = devtrace.reduce(dev, host)
    assert r["busy_s"] == pytest.approx(5.0)
    assert r["window_s"] == pytest.approx(10.0)
    assert dict(r["device_ops"]) == pytest.approx({"dp_spec_kernel": 2.0, "k2": 2.0, "k3": 2.0,
                                                   "Memcpy HtoD": 1.0})
    # Idle 3-5 in the splice, 7-8 in the call outside the stages, 8-10 in the harness.
    assert dict(r["idle_gaps"]) == pytest.approx({"emit_window_from_plan": 2.0, "entry": 1.0,
                                                  "harness": 2.0})
    ctx = {"trace": r}
    assert read("device_idle_pct", ctx) == pytest.approx(50.0)


def test_trace_without_window_or_device_work_reads_nothing():
    assert devtrace.reduce([("k", 0, 1)], []) is None
    assert devtrace.reduce([], [("portbench.window", 0, 10)]) is None
    assert read("device_idle_pct", {"trace": None}) is None
    assert read("dp_roofline", {"trace": None, "peaks": {"hbm_bytes_per_s": 1.0}}) is None


def test_dp_byte_count_and_roofline():
    # 8 candidates of 2 + 2 bytes, the literal, the 2 + 2 byte choice; 4 passes.
    assert dp.BYTES_PER_POSITION == 37
    assert dp.bytes_moved(1000) == 1000 * 4 * 37
    trace = {"device_ops": [("dp_spec_kernel", 0.004), ("dp_check_kernel", 0.0005),
                            ("dp_fixup_kernel", 0.0005), ("other", 1.0)]}
    ctx = {"trace": trace, "peaks": {"hbm_bytes_per_s": 3.35e12}, "dp_positions": MiB}
    least = MiB * 4 * 37 / 3.35e12
    assert read("dp_roofline", ctx) == pytest.approx(100 * least / 0.005)
    # No DP kernel in the trace: nothing, never 0.
    ctx["trace"] = {"device_ops": [("other", 1.0)]}
    assert read("dp_roofline", ctx) is None
    ctx["trace"], ctx["peaks"] = trace, None
    assert read("dp_roofline", ctx) is None


def test_peak_reserved_in_GB():
    assert read("peak_reserved_GB", {"peak_reserved_bytes": 8_500_000_000}) == pytest.approx(8.5)
    assert read("peak_reserved_GB", {}) is None


def test_op_names_are_short():
    assert devtrace.op_name("void dp_spec_kernel<4, 8>(int const*, int*)") == "dp_spec_kernel"
    assert devtrace.op_name("emit_tokens_kernel(Args)") == "emit_tokens_kernel"
    assert devtrace.op_name("Memset (Device)") == "Memset"
    assert devtrace.op_name("(anonymous namespace)::dp_spec_kernel(int const*, int)") == "dp_spec_kernel"
    assert devtrace.op_name("at::native::(anonymous namespace)::fill_kernel<int>(int)") == (
        "at::native::fill_kernel")
