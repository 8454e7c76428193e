"""The port's one-shot path end to end on the CPU (plain forms of the
walk, DP and chain kernels): byte-identical to the JAX package's
``compress_device`` on one gzip case at 32 KiB blocks, and free of jax
when imported and run on its own. Tolerance: exact bytes."""

import subprocess
import sys
import zlib
from pathlib import Path

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
    named jax* (the port imports only zultra_tpu's host modules)."""
    code = (
        "import sys, zlib\n"
        "import zultra_tpu_torch as ztt\n"
        "data = bytes(range(256)) * 40\n"
        "out = ztt.compress(data, 1, device='cpu')\n"
        "assert zlib.decompress(out) == data\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "bad += sorted(m for m in sys.modules if m.startswith('zultra_tpu.ops'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
