"""Reading the ``torch.profiler`` trace of the traced window.

``read(prof)`` takes the device's activity (every kernel, copy and fill
the CUDA trace holds) and the host's ``portbench.*`` ranges, all on the
profiler's one clock, and reduces them to:

- ``busy_s``: the union of the device's activity intervals inside the
  window (``portbench.window``), so that overlapping work counts once;
- ``window_s``: the window's length;
- ``device_ops``: device seconds by operation name, the longest first;
- ``idle_gaps``: the window's idle device time by what the host was in
  then: the innermost stage span, else ``entry`` inside a call, else
  ``harness``.
"""

from __future__ import annotations

import re

WINDOW = "portbench.window"
CALL = "portbench.call"


def op_name(name: str) -> str:
    """A kernel's short name: no return type, anonymous namespace, template
    or arguments."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[(<]", name, maxsplit=1)[0].strip() or name


def raw_events(prof):
    """(device ops [(name, start_us, end_us)], host ranges [(name, start_us,
    end_us)]) from the profiler's results."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_device = ev.device_type() == DeviceType.CUDA
        if name.startswith("portbench."):
            if not on_device:  # not the range's copy on the device's timeline
                host.append((name, ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3))
        elif on_device:
            dev.append((name, ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3))
    return dev, host


def union(intervals) -> list:
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """Total overlap of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(dev: list, host: list) -> dict | None:
    """The module's quantities (seconds), or None where the trace holds no
    window or no device activity in it."""
    win = [(s, e) for n, s, e in host if n == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    inside = [(max(s, w0), min(e, w1)) for _, s, e in dev if e > w0 and s < w1]
    if not inside:
        return None
    busy = union(inside)
    ops = {}
    for n, s, e in dev:
        if e > w0 and s < w1:
            key = op_name(n)
            ops[key] = ops.get(key, 0.0) + (min(e, w1) - max(s, w0)) / 1e6
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    calls = union((s, e) for n, s, e in host if n == CALL)
    stages = {}
    for n, s, e in host:
        if n not in (WINDOW, CALL):
            stages.setdefault(n[len("portbench."):], []).append((s, e))
    idle = {stage: overlap(gaps, union(spans)) for stage, spans in stages.items()}
    in_calls = overlap(gaps, calls)
    idle["entry"] = max(0.0, in_calls - sum(idle.values()))
    idle["harness"] = max(0.0, sum(e - s for s, e in gaps) - in_calls)
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(((k, v / 1e6) for k, v in idle.items() if v > 0), key=lambda kv: -kv[1]),
    }


def read(prof) -> dict | None:
    return reduce(*raw_events(prof))
