"""BENCHMARK.json against the benchmark's contract, and every part of a
cell found by its name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import gen, spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert c["source"].startswith("https://")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                       "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(BENCH, w["name"], True)


def test_every_part_is_found_by_name():
    for w in BENCH["workloads"]:
        c = spec.cell(BENCH, w["name"])
        assert c["traffic_file"].is_file()
        assert c["config_data"]["name"] == w["config"]
        gen.load(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_new_mix_is_found_by_its_file(tmp_path):
    # A later cell: a new traffic file and a new entry, no file edited.
    (tmp_path / "portbench" / "traffic").mkdir(parents=True)
    shutil.copytree(ROOT / "portbench" / "configs", tmp_path / "portbench" / "configs")
    (tmp_path / "portbench" / "traffic" / "files4k.json").write_text(json.dumps(
        {"content": "text", "inputs": 4, "size": 4096}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "web_assets_gzip.files4k", "config": "web_assets_gzip",
                               "traffic": "files4k", "chips": 1, "why": "small files"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell(spec.load(tmp_path), "web_assets_gzip.files4k", tmp_path)
    inputs, order = gen.make(json.loads(c["traffic_file"].read_text()), 7)
    assert sorted(order) == [0, 1, 2, 3]
    assert [len(x) for x in inputs] == [gen.load("files4k", c["traffic_file"].parent)["size"]] * 4
    # Metrics without a ``workloads`` key would count in the new cell too.
    assert [m["name"] for m in spec.metrics(bench, "web_assets_gzip.files4k", False)] == [
        "MBps", "setup_s"]
    with pytest.raises(KeyError):
        spec.cell(bench, "no.such_cell", tmp_path)
