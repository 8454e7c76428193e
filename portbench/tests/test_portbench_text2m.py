"""The cell of zultra's largest block size, ``text_gzip_2m.text32m``: its
configuration and traffic found by name, its input, the plain reference's
one block a text window, and every per-layer reader on a made-up traced
run of the cell."""

import numpy as np
import pytest

from portbench import gen, progtrace, spec
from portbench.reference import encode
from portbench.spans import STAGES

CELL = "text_gzip_2m.text32m"
MIB = 1 << 20


@pytest.fixture(scope="module")
def cell():
    return spec.cell(spec.load(), CELL)


@pytest.fixture(scope="module")
def made(cell):
    return gen.make(gen.load(cell["traffic"]), 2**33 + 5)


def test_configuration_and_traffic_load_by_name(cell):
    cfg = cell["config_data"]
    assert (cfg["entry"], cfg["flags"], cfg["container"]) == ("zultra_tpu_torch.compress", 2, "gzip")
    assert cfg["max_block_size"] == 2 * MIB and cfg["check"] == {"ref_windows": 3}
    assert cfg["input_bytes"] == 32 * MIB and cfg["reduced"] == ["input_bytes"]
    mix = gen.load(cell["traffic"])
    assert mix == {**mix, "content": "text", "inputs": 1, "size": 32 * MIB, "content_seed": 0,
                   "piece": 2 * MIB, "group": 16}
    assert [m["name"] for m in spec.metrics(spec.load(), CELL, True)] \
        == [m["name"] for m in spec.load()["per_layer"]]
    assert [m["name"] for m in spec.metrics(spec.load(), CELL, False)] == ["MBps", "setup_s"]


def test_input_is_the_fixed_text_in_a_seeded_order(cell, made):
    """One input of 33,554,432 B: the sixteen 2 MiB pieces of the content
    seed's text, in another order for another seed."""
    inputs, order = made
    assert order == [0] and len(inputs) == 1 and len(inputs[0]) == 32 * MIB
    other = gen.make(gen.load(cell["traffic"]), 7)[0][0]
    pieces = [inputs[0][i : i + 2 * MIB] for i in range(0, 32 * MIB, 2 * MIB)]
    assert sorted(pieces) == sorted(other[i : i + 2 * MIB] for i in range(0, 32 * MIB, 2 * MIB))
    assert other != inputs[0]
    assert gen.text(np.random.default_rng(0), 4096) in (p[:4096] for p in pieces)


def test_reference_keeps_a_text_window_one_block(made):
    """The plain reference plans a window of the text as one block (a
    256 KiB window after 32 KiB of history: the 2 MiB window's 146 s on
    the CPU, 40 of them the plan, are too long for a test)."""
    window, prev = encode.window_of(made[0][0], 32768, 9 * 32768)
    assert prev == 32768
    _, ends = encode.window_plan(window, prev)
    assert list(ends) == [len(window)]


def _report(monkeypatch, counters, spans):
    monkeypatch.setattr(progtrace, "program_report",
                        lambda: {"counters": counters, "spans": spans})


# A made-up traced run of the cell: 24 calls of the whole input in 15 s,
# the program's spans and counters, a device trace.
TRACED = {
    "calls": [(0.625 * i, 0.625 * (i + 1), 32 * MIB, True) for i in range(24)],
    "window_s": 15.0,
    "setup_s": 12.0,
    "stage_s": {s: 1.0 + i for i, s in enumerate(STAGES)},
    "dp_positions": 24 * 16 * 2 * MIB,
    "trace": {"window_s": 15.0, "busy_s": 12.0,
              "device_ops": [["dp_spec_kernel", 0.5], ["dp_check_kernel", 0.01],
                             ["dp_fixup_kernel", 0.02], ["walk_sweep_kernel", 0.4]]},
    "peak_reserved_bytes": 29957816320,
    "device_kind": "NVIDIA H100 80GB HBM3",
    "peaks": {"hbm_bytes_per_s": 3.35e12},
}
COUNTERS = {"match.positions": 24 * 16 * 4 * MIB, "match.input": 24 * 32 * MIB,
            "plan.positions": 24 * 16 * 2 * MIB, "plan.input": 24 * 32 * MIB - 24 * 4096,
            "program.replay": 24 * 4, "program.capture": 0, "program.eager": 0,
            "dp.long_lanes": 24 * 16, "dp.long_positions": 24 * 32 * MIB - 24 * 8192}
SPANS = {"zultra.wait": {"count": 24 * 8, "total_s": 0.3}}


@pytest.mark.parametrize("name", [m["name"] for m in spec.load()["per_layer"]])
def test_every_per_layer_metric_reads_the_cell(monkeypatch, name):
    """Every per-layer metric lists the cell, and its reader gives a number
    on a made-up traced run of it."""
    assert CELL in next(m for m in spec.load()["per_layer"] if m["name"] == name)["workloads"]
    _report(monkeypatch, COUNTERS, SPANS)
    value = spec.reader(name)(TRACED)
    assert isinstance(value, float) and value > 0, value
