"""Build and load the CUDA kernels of ``csrc/``.

The kernels have a plain C interface: one ``nvcc`` per ``csrc/*.cu``
compiles it for ``sm_90a`` (Hopper), all started together, and one more
links the objects into a shared library that ctypes loads. The build
lands in ``build/zultra_tpu_torch/`` under the repository root, named by
a hash of the sources so that an edited kernel is never served from a
stale build. Nothing is compiled at import time: the first CUDA launch
builds, later ones reuse the loaded library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "zultra_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lib = None
_lib_lock = threading.Lock()  # threads planning on several devices build once
build_seconds = 0.0  # wall time of the build this process ran (0 if cached)
build_log = {}  # source stem -> nvcc's output (ptxas registers, shared memory, spills)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signature of every kernel entry point; each returns cudaGetLastError()
# unless noted.
_SIGNATURES = {
    "zt_walk": [_VP] * 4 + [_I] * 5 + [_VP],
    "zt_dp": [_VP] * 9 + [_I] * 4 + [_VP],
    "zt_chain": [_VP] * 6 + [_I] * 4 + [_VP],
    "zt_mk12": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "zt_kraft": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "zt_matchlen": [_VP, _LL, _VP, _VP, _VP, _LL, _VP],
    "zt_hist": [_VP, _LL, _LL, _LL, _VP, _I, _VP, _I, _VP],
    "zt_hist_blocks_per_sm": [],  # returns the blocks an SM holds, or -(CUDA error)
    "zt_rle_sweep": [_VP, _VP, _I, _I, _VP, _VP, _I, _I, _VP],
    "zt_rle_stats": [_VP] * 7 + [_I] * 5 + [_VP] + [_I] * 2 + [_VP],  # masks: a host int array
    "zt_prefix_tables": [_VP] * 7 + [_I] * 2 + [_VP],
    "zt_prep_lanes": [_VP] * 10 + [_I] * 2 + [_VP],
    "zt_token_hist": [_VP] * 6 + [_I] * 2 + [_LL] * 4 + [_VP],
    "zt_emit_tokens": [_VP] * 10 + [_I] * 2 + [_LL, _VP],
    "zt_lex_order": [_VP, _VP, _I, _I, _VP],
    "zt_suffix_round": [_VP] * 7 + [_I] * 4 + [_VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzt_kernels-{digest.hexdigest()[:12]}.so"


def _run_all(cmds: list) -> list:
    """Run the commands side by side; raise with the output of the first
    that fails, else return their outputs."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log}")
    return logs


def build() -> Path:
    """Compile csrc/*.cu unless the hashed library already exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(src)]
                         for src, o in zip(sources, objects)])
        build_log.update({src.stem: log for src, log in zip(sources, logs)})
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, out)
    finally:
        for o in objects:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call one kernel entry point on PyTorch's current CUDA stream and
    raise if the launch was refused."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_cuda(name: str, t, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    rank ``ndim`` — what every kernel takes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
