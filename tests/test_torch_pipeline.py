"""The port's one-shot path end to end on the CPU (plain forms of the
kernels): byte-identical to the JAX package's ``compress_device`` on one
gzip case at 32 KiB blocks (tolerance: exact bytes). And the port's
independence: run on its own it loads no jax and no zultra_tpu module,
no source file of it (nor chip_smoke.py) imports zultra_tpu, and its
copy of the format constants equals zultra_tpu's."""

import ast
import importlib
import inspect
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import zultra_tpu.constants as jax_constants
import zultra_tpu_torch.constants as port_constants
from zultra_tpu.device_pipeline import compress_device as compress_device_jax
from zultra_tpu_torch import compress_device
from zultra_tpu_torch.corpus import mixed_corpus

# One intra-op thread in each pytest worker: the tier-1 run puts six workers
# on the machine's cores, and torch's default of a thread per core in each
# of them oversubscribes the cores several times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_compress_device_equals_jax():
    data = mixed_corpus(40000, seed=41)
    want = compress_device_jax(data, 2, 32768)
    got = compress_device(data, 2, 32768, device="cpu")
    assert got == want
    assert zlib.decompress(got, 31) == data


def test_port_imports_no_jax():
    """Importing the port and compressing on the CPU (one shot and
    sharded) loads no module named jax* and no zultra_tpu or zultra_tpu.*
    module."""
    code = (
        "import sys, zlib\n"
        "import zultra_tpu_torch as ztt\n"
        "import zultra_tpu_torch.parallel.multihost, zultra_tpu_torch.profiling\n"
        "import zultra_tpu_torch.ops.emit_torch, zultra_tpu_torch.matchfinder\n"
        "import zultra_tpu_torch.ops.staircase_torch, zultra_tpu_torch.ops.nsv_torch\n"
        "import zultra_tpu_torch.ops.parse_torch, zultra_tpu_torch.parallel\n"
        "data = bytes(range(256)) * 40\n"
        "out = ztt.compress(data, 1, device='cpu')\n"
        "assert zlib.decompress(out) == data\n"
        "assert zultra_tpu_torch.parallel.compress_sharded(data, ['cpu'], 1) == out\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "bad += sorted(m for m in sys.modules if m == 'zultra_tpu' or m.startswith('zultra_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def _imported_modules(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_sources_import_no_zultra_tpu():
    """Every module of the port and chip_smoke.py, read as source: no
    ``import zultra_tpu...`` or ``from zultra_tpu... import`` other than
    the port itself, and no jax."""
    files = sorted((REPO / "zultra_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for name in _imported_modules(path):
            root = name.split(".")[0]
            if root in ("zultra_tpu", "jax", "jaxlib"):
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert len(files) > 10
    names = {p.relative_to(REPO).as_posix() for p in files}
    assert {"zultra_tpu_torch/stream.py", "zultra_tpu_torch/compat.py",
            "zultra_tpu_torch/cli.py", "zultra_tpu_torch/parallel/__init__.py",
            "zultra_tpu_torch/parallel/multihost.py", "zultra_tpu_torch/profiling.py",
            "zultra_tpu_torch/ops/checksum.py", "zultra_tpu_torch/ops/emit_torch.py",
            "zultra_tpu_torch/matchfinder.py", "zultra_tpu_torch/suffix.py",
            "zultra_tpu_torch/ops/plan_cuda.py", "zultra_tpu_torch/ops/staircase_torch.py",
            "zultra_tpu_torch/ops/nsv_torch.py", "zultra_tpu_torch/ops/parse_torch.py"} <= names
    assert not bad, bad


def _public(module) -> dict:
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not callable(v) and not isinstance(v, type(np))}


def test_port_constants_equal_jax_package():
    want = _public(jax_constants)
    got = _public(port_constants)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[name].dtype == value.dtype, name
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        else:
            assert got[name] == value, name
    for fn in ("static_literal_code_lengths", "static_offset_code_lengths"):
        np.testing.assert_array_equal(getattr(port_constants, fn)(), getattr(jax_constants, fn)())
    for off in (1, 2, 256, 257, 384, 385, 32768):
        assert port_constants.offset_table_index(off) == jax_constants.offset_table_index(off)


@pytest.mark.parametrize("name", ["put_packed_bits", "write_block_from_plan",
                                  "emit_window_from_plan"])
def test_host_half_is_a_copy(name):
    """The host half of the port's device_pipeline is the JAX package's
    code, line for line (docstrings aside)."""
    import zultra_tpu.device_pipeline as jax_dp
    import zultra_tpu_torch.device_pipeline as port_dp

    def body(fn):
        tree = ast.parse(__import__("inspect").getsource(fn))
        f = tree.body[0]
        if isinstance(f.body[0], ast.Expr) and isinstance(f.body[0].value, ast.Constant):
            f.body = f.body[1:]
        return ast.dump(f)

    assert body(getattr(port_dp, name)) == body(getattr(jax_dp, name))


def _fn_ast(fn, strip_device: bool = False) -> str:
    """The function's AST without its docstring and its name; with
    ``strip_device``, also without a ``device`` parameter and without
    every ``device=`` keyword it passes on."""
    f = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    if isinstance(f.body[0], ast.Expr) and isinstance(f.body[0].value, ast.Constant):
        f.body = f.body[1:]
    f.name = "_"
    if strip_device:
        a = f.args
        if a.args and a.args[-1].arg == "device":
            a.args.pop()
            a.defaults.pop()
        if a.kwonlyargs and a.kwonlyargs[-1].arg == "device":
            a.kwonlyargs.pop()
            a.kw_defaults.pop()
        for node in ast.walk(f):
            if isinstance(node, ast.Call):
                node.keywords = [k for k in node.keywords if k.arg != "device"]
    return ast.dump(f)


def _resolve(path: str):
    module, _, attr = path.partition(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


# (port function, its original in zultra_tpu, differs only by ``device``)
COPIES = [
    ("stream:Stream._slide_history", "stream:Stream._slide_history", False),
    ("stream:Stream._drain_pending", "stream:Stream._drain_pending", False),
    ("stream:Stream.compress", "stream:Stream.compress", False),
    ("stream:Stream.set_dictionary", "stream:Stream.set_dictionary", False),
    ("stream:memory_bound", "stream:memory_bound", False),
    ("stream:clamp_block_size", "stream:clamp_block_size", False),
    ("compat:ZultraStream.__init__", "compat:ZultraStream.__init__", True),
    ("compat:ZultraStream.compress", "compat:ZultraStream.compress", False),
    ("compat:memory_compress", "compat:memory_compress", True),
    ("cli:_load_dictionary", "cli:_load_dictionary", False),
    ("cli:_decompress", "cli:_decompress", False),
    ("cli:generate_compressible_data", "cli:generate_compressible_data", False),
    ("cli:compress_guarded", "cli:compress_guarded", True),
    ("cli:do_benchmark", "cli:do_benchmark", True),
    ("device_pipeline:_QueuedWindow.done", "device_pipeline:_QueuedWindow.done", False),
    ("device_pipeline:_QueuedWindow.result", "device_pipeline:_QueuedWindow.result", False),
    ("device_pipeline:DeviceWindowEngine.queue_window",
     "device_pipeline:DeviceWindowEngine._queue_window", False),
]

# Ported functions that had to change, and why.
CHANGED = {
    "stream:Stream.__init__": "the engine is the port's DeviceWindowEngine(device); "
                              "no engine registry, no thread pool",
    "stream:Stream._compress_window": "only the queued branch: the port has one engine",
    "stream:compress": "calls compress_device(device=...); no engine registry",
    "cli:do_compress": "only the one-shot branch, which zultra_tpu takes for every "
                       "engine with compress_corpus",
    "cli:main": "the program's name in the usage messages",
    "cli:do_self_test": "the tiny-input probes catch only the empty input's StreamError "
                        "and must round-trip, where zultra_tpu swallows every error",
    "device_pipeline:DeviceWindowEngine._flush_queue": "plans on the engine's device "
                                                       "through the port's begin_windows_batched",
}


@pytest.mark.parametrize("port,orig,strip_device", COPIES, ids=[c[0] for c in COPIES])
def test_streaming_code_is_a_copy(port, orig, strip_device):
    """The port's stream, compat and CLI code is zultra_tpu's, line for
    line (docstrings aside; where marked, up to the ``device`` parameter
    that it passes on)."""
    got = _fn_ast(_resolve(f"zultra_tpu_torch.{port}"), strip_device)
    want = _fn_ast(_resolve(f"zultra_tpu.{orig}"))
    assert got == want


@pytest.mark.parametrize("name", sorted(CHANGED))
def test_changed_functions_do_differ(name):
    """Each function listed as changed does differ from its original even
    up to ``device`` (else it belongs in COPIES)."""
    got = _fn_ast(_resolve(f"zultra_tpu_torch.{name}"), True)
    want = _fn_ast(_resolve(f"zultra_tpu.{name}"))
    assert got != want, CHANGED[name]
