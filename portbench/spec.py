"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix and its metrics;
each lies in a file of its own under this package (``configs/``,
``traffic/``, ``metrics/<name>.py``), so a new cell, mix or metric is a
new file and a new entry, and no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The workload's entry with its configuration's file read in
    (``config_data``) and the path of its traffic mix (``traffic_file``)."""
    [w] = [w for w in bench["workloads"] if w["name"] == workload] or [None]
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    [c] = [c for c in bench["configs"] if c["name"] == w["config"]]
    return dict(w, config_data=json.loads((root / c["file"]).read_text()),
                traffic_file=root / HERE.name / "traffic" / f"{w['traffic']}.json")


def metrics(bench: dict, workload: str, traced: bool) -> list:
    """The cell's metric entries: its end-to-end ones, or with ``traced``
    its per-layer ones; a metric with ``workloads`` counts only there."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str, metrics_dir: Path = HERE / "metrics"):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
