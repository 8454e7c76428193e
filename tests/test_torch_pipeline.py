"""The port's one-shot path end to end on the CPU (plain forms of the
kernels): byte-identical to the JAX package's ``compress_device`` on one
gzip case at 32 KiB blocks (tolerance: exact bytes). And the port's
independence: run on its own it loads no jax and no zultra_tpu module,
no source file of it (nor chip_smoke.py) imports zultra_tpu, and its
copy of the format constants equals zultra_tpu's."""

import ast
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import zultra_tpu.constants as jax_constants
import zultra_tpu_torch.constants as port_constants
from zultra_tpu.device_pipeline import compress_device as compress_device_jax
from zultra_tpu_torch import compress_device
from zultra_tpu_torch.corpus import mixed_corpus

REPO = Path(__file__).resolve().parent.parent


def test_compress_device_equals_jax():
    data = mixed_corpus(40000, seed=41)
    want = compress_device_jax(data, 2, 32768)
    got = compress_device(data, 2, 32768, device="cpu")
    assert got == want
    assert zlib.decompress(got, 31) == data


def test_port_imports_no_jax():
    """Importing the port and compressing on the CPU loads no module
    named jax* and no zultra_tpu or zultra_tpu.* module."""
    code = (
        "import sys, zlib\n"
        "import zultra_tpu_torch as ztt\n"
        "data = bytes(range(256)) * 40\n"
        "out = ztt.compress(data, 1, device='cpu')\n"
        "assert zlib.decompress(out) == data\n"
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
