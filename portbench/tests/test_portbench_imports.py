"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and nothing reads the JAX package's benchmark files."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "zultra_tpu"}


def test_no_forbidden_import_in_the_sources():
    """Every file of the benchmark, its tests too, by AST; the harness's
    own files also name none of the JAX package's benchmark files."""
    for path in PKG.rglob("*.py"):
        harness = "tests" not in path.relative_to(PKG).parts
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
            if harness and isinstance(node, ast.Constant) and isinstance(node.value, str):
                for word in ("bench.py", "BENCH_", "MULTICHIP_", "scripts/"):
                    assert word not in node.value, (path, word)


def test_the_harness_loads_no_forbidden_module():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import run, check, gen, spec, devtrace, spans\n"
        "from portbench.reference import encode\n"
        "import zultra_tpu_torch, zultra_tpu_torch.device_pipeline\n"
        "b = spec.load()\n"
        "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "data = gen.text(__import__('numpy').random.default_rng(1), 3000)\n"
        "out = zultra_tpu_torch.compress(data, 2, 32768, device='cpu')\n"
        "assert check.roundtrip_ok(out, data) and encode.compress_gzip(data, 32768) == out\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import run

    for name in ("zultra_tpu_torch_x", "jaxfoo", "flaxen.core"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(run.forbidden_modules()) & {"zultra_tpu", "jax", "flax"} - {
        m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, str(PKG / "run.py"), "--workload", "lzbench_gzip_1m.mixed100m",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr
