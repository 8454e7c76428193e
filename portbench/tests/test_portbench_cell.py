"""A tiny cell run end to end through the port's CPU forms and the plain
reference (the harness's look for a card skipped): sound runs read
correct, and each fault planted under the timed path, and the control
in the program's place, read not correct."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench import run
from portbench.reference import blocks, encode

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**33 + 17


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("cell")
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench" / "configs" / "web_assets_gzip.json").read_text())
    cfg.update(name="tiny", max_block_size=32768, check={"ref_windows": 2})
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (root / "portbench" / "traffic" / "pool.json").write_text(json.dumps(
        {"content": "text", "inputs": 3, "size": 3000}))
    (root / "portbench" / "traffic" / "buf.json").write_text(json.dumps(
        {"content": "mixed", "size": 34000, "content_seed": 0, "piece": 8192, "group": 2}))
    bench["configs"] = [{"name": "tiny", "source": "https://example.org", "file":
                         "portbench/configs/tiny.json", "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": f"tiny.{t}", "config": "tiny", "traffic": t, "chips": 1,
                           "why": "tests"} for t in ("pool", "buf")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.pool", "tiny.buf"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root, workload, traced=False):
    return run.run_cell(workload, SEED, 0.01, traced, device="cpu", root=root, workers=2)


@pytest.mark.parametrize("workload,traced", [("tiny.pool", True), ("tiny.buf", False)])
def test_sound_run_is_correct_and_prints_the_schema(tiny, workload, traced):
    result, info = run_tiny(tiny, workload, traced)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert all(v["value"] == 0 and v["limit"] == 0 for v in result["compared"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert "match_ms_per_MiB" in result["metrics"] and "MBps_traced" in info
        assert "MBps" not in result["metrics"]
    else:
        assert {"MBps", "setup_s"} <= set(result["metrics"])
    json.dumps(result)
    assert info["completed"] == result["attempted"]


def _flip_emitted_bit(monkeypatch, dp):
    emit = dp.emit_window_from_plan

    def broken(handle, is_last, out, bits_data, bits_count):
        n, bd, bc = emit(handle, is_last, out, bits_data, bits_count)
        out[n // 2] ^= 0x08
        return n, bd, bc

    monkeypatch.setattr(dp, "emit_window_from_plan", broken)


def _drop_half_the_batch(monkeypatch, dp):
    emit = dp.emit_window_from_plan
    seen = [0]

    def broken(handle, is_last, out, bits_data, bits_count):
        seen[0] += 1
        if seen[0] % 2 == 1 and not is_last:  # the first of each pair of windows
            return 0, bits_data, bits_count
        return emit(handle, is_last, out, bits_data, bits_count)

    monkeypatch.setattr(dp, "emit_window_from_plan", broken)


def _state_unchanged(monkeypatch, dp):
    import zultra_tpu_torch

    compress = zultra_tpu_torch.compress
    first = []

    def broken(data, *args, **kwargs):
        if not first:
            first.append(compress(data, *args, **kwargs))
        return first[0]

    monkeypatch.setattr(zultra_tpu_torch, "compress", broken)


def _alter_a_token(monkeypatch, dp):
    plan = dp.plan_blocks_device_multi

    def broken(*args, **kwargs):
        plans = plan(*args, **kwargs)
        p = max(plans, key=lambda q: q["total_bits"])
        words = np.array(p["words"], copy=True)
        words.reshape(-1)[p["total_bits"] // 64] ^= 1 << 7
        p["words"] = words
        return plans

    monkeypatch.setattr(dp, "plan_blocks_device_multi", broken)


@pytest.mark.parametrize("fault,workload", [
    (_flip_emitted_bit, "tiny.pool"), (_drop_half_the_batch, "tiny.buf"),
    (_state_unchanged, "tiny.pool"), (_alter_a_token, "tiny.pool")])
def test_a_fault_under_the_timed_path_is_not_correct(tiny, monkeypatch, fault, workload):
    import zultra_tpu_torch.device_pipeline as dp

    fault(monkeypatch, dp)
    result, _ = run_tiny(tiny, workload)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["compared"].values()) or result["failed"]


def test_control_in_the_programs_place_is_not_correct(tiny, monkeypatch):
    """The reference with one parse pass fewer in the program's place: valid
    gzip, the same input back, other bytes."""
    import zultra_tpu_torch

    def control(data, flags, mbs, device=None):
        saved = blocks.CONVERGENCE_PASSES
        blocks.CONVERGENCE_PASSES = saved - 1
        try:
            return encode.compress_gzip(data, mbs)
        finally:
            blocks.CONVERGENCE_PASSES = saved

    monkeypatch.setattr(zultra_tpu_torch, "compress", control)
    result, _ = run_tiny(tiny, "tiny.pool")
    c = result["compared"]
    assert c["roundtrip_bad"]["value"] == 0 and c["unequal_calls"]["value"] == 0
    assert c["ref_mismatch"]["value"] >= 1 and result["correct"] is False


@pytest.mark.cuda
def test_cuda_cell_runs_on_the_card(tiny):
    """On a card: one short run of the tiny pool cell through the kernels."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result, _ = run.run_cell("tiny.pool", SEED, 0.5, True, device="cuda", root=tiny, workers=2)
    assert result["correct"] is True and result["device"]["busy_s"] > 0


@pytest.mark.parametrize("workload", ["tiny.pool", "tiny.buf"])
def test_control_script_reads_a_mismatch(tiny, workload):
    from portbench import control

    r = control.control_reading(workload, SEED, 2, tiny)
    assert r["windows"] == 2 and r["ref_mismatch"] >= 1 > r["limit"]
