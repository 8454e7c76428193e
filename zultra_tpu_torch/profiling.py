"""Tracing, profiling and metrics.

Port of zultra_tpu/profiling.py:

* stage timing: ``stage_timer`` contexts aggregating per-stage wall time
  (copies);
* device tracing: ``trace`` wraps ``torch.profiler`` with CUDA activity
  (the JAX package wraps jax.profiler); it raises if the profiler does
  not start, where the JAX form went on silently;
* stream metrics: Stream.total_in/total_out plus ``stream_stats`` (a
  copy).

And the port's own tracer, on after ``enable()`` and while a
``torch.profiler`` runs (so a profile of any caller shows the spans and
reads the counters without a call to ``enable``):

* ``span(name)``: a context that adds its host seconds and a call to the
  stage totals and, under a running ``torch.profiler``, opens a range of
  that name, so the device's work and idle time can be put on the span
  that issued it (the ``zultra.*`` spans of the pipeline);
* ``count(name, n)``: a named counter (program replays, padded lane
  positions, copied bytes);
* ``keep(name, tensor)``: a device tensor whose sum goes to the counter
  ``name`` when the report is made (the doubling rounds the segments
  ran), so that counting waits for the device at report time alone;
* ``report()`` / ``reset()``: both, with the kernel launch counts.

Off, ``span`` hands back one shared no-op context and ``count`` returns
at once: no clock is read, no range made, no lock taken; the one cost is
asking torch whether its profiler runs. Totals and counters sit under
one lock, as the launch counts do, since ``compress_device(devices=[...])``
plans from several host threads.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

_STAGE_TOTALS: dict[str, float] = defaultdict(float)
_STAGE_COUNTS: dict[str, int] = defaultdict(int)
_COUNTERS: dict[str, float] = defaultdict(int)
_KEPT: list = []  # (counter name, device tensor) of ``keep``
_LOCK = threading.Lock()
_NOOP = contextlib.nullcontext()
_on = False
_profiler_on = torch._C._autograd._profiler_enabled
# Torch's fast record function is an op-scope range: the profiler puts
# the device work launched inside it on it by correlation, and, unlike
# ``torch.profiler.record_function`` (a user annotation), it gets no copy
# on the device's timeline that a reader of device activity would count
# as device time.
_range = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall time under a stage name."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        with _LOCK:
            _STAGE_TOTALS[name] += elapsed
            _STAGE_COUNTS[name] += 1


def stage_report(reset: bool = False):
    """{stage: {total_s, calls, mean_ms}} for everything timed so far."""
    with _LOCK:
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


def enable(on: bool = True) -> None:
    """Turn the tracer's spans and counters on or off; while a
    ``torch.profiler`` runs they are on either way."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on or _profiler_on()


class _Span:
    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = _range(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        with _LOCK:
            _STAGE_TOTALS[self.name] += elapsed
            _STAGE_COUNTS[self.name] += 1
        return False


def span(name: str):
    """A context timing ``name`` on the host clock and marking it for the
    profiler while tracing is on; the shared no-op context while off."""
    return _Span(name) if _on or _profiler_on() else _NOOP


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not (_on or _profiler_on()):
        return
    with _LOCK:
        _COUNTERS[name] += n


def keep(name: str, t: torch.Tensor) -> None:
    """Keep ``t`` while tracing is on: ``report`` adds its sum to the
    counter ``name``. Nothing waits for the device here."""
    if not (_on or _profiler_on()):
        return
    with _LOCK:
        _KEPT.append((name, t))


def report(reset: bool = False) -> dict:
    """{"spans": {name: {total_s, calls}}, "counters": {name: n},
    "launches": ops.launch_counts()} since the last reset; the stage
    timers' totals are among the spans, the kept tensors' sums among the
    counters (the one wait for the device here)."""
    from .ops import launch_counts

    with _LOCK:
        out = {"spans": {name: {"total_s": total, "calls": _STAGE_COUNTS[name]}
                         for name, total in sorted(_STAGE_TOTALS.items())}}
        counters = dict(_COUNTERS)
        kept = list(_KEPT)
    for name, t in kept:
        counters[name] = counters.get(name, 0) + int(t.sum())
    out["counters"] = dict(sorted(counters.items()))
    out["launches"] = launch_counts()
    if reset:
        _clear()
    return out


def reset() -> None:
    """Clear the spans, the counters and the kernel launch counts."""
    _clear()


def _clear() -> None:
    from .ops import reset_launch_counts

    with _LOCK:
        _STAGE_TOTALS.clear()
        _STAGE_COUNTS.clear()
        _COUNTERS.clear()
        _KEPT.clear()
    reset_launch_counts()


@contextlib.contextmanager
def trace(log_dir: str | None = None, device="cuda"):
    """``torch.profiler`` around the block: CPU activity (the host's side
    of each launch), and CUDA activity for a CUDA ``device``. Yields the
    profiler; with ``log_dir`` the trace is written there as a Chrome
    trace (``trace.json``) when the block ends. Raises if the profiler
    cannot trace what is asked."""
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
