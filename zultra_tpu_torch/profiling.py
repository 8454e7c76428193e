"""Tracing, profiling and metrics.

Port of zultra_tpu/profiling.py:

* stage timing: ``stage_timer`` contexts aggregating per-stage wall time
  (copies);
* device tracing: ``trace`` wraps ``torch.profiler`` with CUDA activity
  (the JAX package wraps jax.profiler); it raises if the profiler does
  not start, where the JAX form went on silently;
* stream metrics: Stream.total_in/total_out plus ``stream_stats`` (a
  copy).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

_STAGE_TOTALS: dict[str, float] = defaultdict(float)
_STAGE_COUNTS: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall time under a stage name."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        _STAGE_TOTALS[name] += elapsed
        _STAGE_COUNTS[name] += 1


def stage_report(reset: bool = False):
    """{stage: {total_s, calls, mean_ms}} for everything timed so far."""
    report = {
        name: {
            "total_s": total,
            "calls": _STAGE_COUNTS[name],
            "mean_ms": total * 1000.0 / max(_STAGE_COUNTS[name], 1),
        }
        for name, total in sorted(_STAGE_TOTALS.items())
    }
    if reset:
        _STAGE_TOTALS.clear()
        _STAGE_COUNTS.clear()
    return report


@contextlib.contextmanager
def trace(log_dir: str | None = None, device="cuda"):
    """``torch.profiler`` around the block: CPU activity (the host's side
    of each launch), and CUDA activity for a CUDA ``device``. Yields the
    profiler; with ``log_dir`` the trace is written there as a Chrome
    trace (``trace.json``) when the block ends. Raises if the profiler
    cannot trace what is asked."""
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    missing = set(activities) - set(supported_activities())
    if missing:
        raise RuntimeError(f"torch.profiler cannot trace {sorted(a.name for a in missing)} "
                           "in this build")
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def stream_stats(stream) -> dict:
    """Counters for a zultra_tpu_torch.Stream."""
    return {
        "total_in": stream.total_in,
        "total_out": stream.total_out,
        "ratio_pct": 100.0 * stream.total_out / max(stream.total_in, 1),
        "engine": stream.engine.name,
        "pending_windows": len(stream._pending),
        "max_block_size": stream.max_block_size,
    }
