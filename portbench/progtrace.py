"""The traced window by the program's own spans and counters.

The program's tracer (``zultra_tpu_torch.profiling``) is on while a
``torch.profiler`` runs, so in a traced run it counts and times the
window alone, and ``program_report()`` is its report at the window's
end: the readers of the program's spans and counters read it. The
program counts from its import on, so a process makes one run, as
``run.py``'s ``main`` does.

The tracer also opens a profiler range named ``zultra.<span>`` around
each step of the host orchestration. ``read(prof)`` puts the window's
device work and idle time on those ranges, all on the profiler's one
clock (``run.py`` does not hand its profiler to the readers yet, so no
metric reads this):

- a device kernel, copy or fill goes on the innermost ``zultra.*`` range
  around the host op that launched it: the profiler links the device op
  to that op (its ``linked_correlation_id``), or to the CUDA runtime call
  (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...;
  the same ``correlation_id``) and the call to its op in turn; a graph's
  kernels carry the correlation of its ``cudaGraphLaunch``. The range is
  sought on the op's thread. A device op found on no range is
  unattributed;
- an idle gap of the device (``devtrace``'s gaps: the window less the
  union of the device's activity) goes on the innermost ``zultra.*``
  range the host was in, else on ``entry`` inside a ``portbench.call``,
  else on ``harness``.

Quantities (seconds): ``device_s``, the device ops' time in the window
(overlaps counted in each op, as ``devtrace``'s ``device_ops``);
``device_by_span``, on the innermost span; ``device_in_span``, on a span
and the spans inside it; ``device_ops_by_span``, each innermost span's
ops by name, the longest first; ``unattributed_device_s``; ``idle_s``
and ``idle_by_span``.
"""

from __future__ import annotations

from bisect import bisect_right

from portbench import devtrace

PREFIX = "zultra."
TOP_OPS = 8


def program_report() -> dict | None:
    """The program tracer's ``report()`` (``{"spans", "counters",
    "launches"}``), or None where the program has no tracer."""
    try:
        from zultra_tpu_torch import profiling
    except ImportError:
        return None
    return profiling.report() if hasattr(profiling, "report") else None


def raw_events(prof):
    """(device ops [(name, start_us, end_us, correlation, linked)], host ops
    [(name, start_us, end_us, correlation, thread)], runtime calls
    [(correlation, linked, start_us, thread)]) from the profiler's
    results. A host event linked to an op, or named ``cu*``, is a CUDA
    runtime call; the device ops are those ``devtrace`` reads."""
    from torch.autograd import DeviceType

    dev, ops, runtime = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns() / 1e3
        e = (ev.start_ns() + ev.duration_ns()) / 1e3  # as devtrace: the same gaps to the bit
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith("portbench."):
                dev.append((name, s, e, ev.correlation_id(), ev.linked_correlation_id()))
        elif ev.linked_correlation_id() or name.startswith("cu"):
            runtime.append((ev.correlation_id(), ev.linked_correlation_id(), s,
                            ev.start_thread_id()))
        else:
            ops.append((name, s, e, ev.correlation_id(), ev.start_thread_id()))
    return dev, ops, runtime


def segments(ranges) -> list:
    """The time the ranges [(name, start, end)] cover, cut where the set of
    open ranges changes: sorted, disjoint [start, end, path], the path the
    open ranges' names from the outermost (earliest start) in."""
    bounds = sorted({t for _, s, e in ranges for t in (s, e)})
    order = sorted((r for r in ranges if r[2] > r[1]), key=lambda r: (r[1], -r[2]))
    out, active, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(order) and order[i][1] <= a:
            active.append(order[i])
            i += 1
        active = [r for r in active if r[2] > a]
        if not active:
            continue
        path = tuple(r[0] for r in active)
        if out and out[-1][2] == path and out[-1][1] == a:
            out[-1][1] = b
        else:
            out.append([a, b, path])
    return out


def paths(ranges) -> dict:
    """{correlation: path} of one thread's ranges [(name, start, end,
    correlation)]: the names of the ranges around each, from the
    outermost in, ending with its own (a range that starts with its
    parent is inside it)."""
    out, stack = {}, []
    for name, s, e, corr in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= s:
            stack.pop()
        path = (stack[-1][1] if stack else ()) + (name,)
        out[corr] = path
        stack.append((e, path))
    return out


def subtract(a: list, b: list) -> list:
    """The sorted disjoint intervals ``a`` less the sorted disjoint ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def _at(segs: list, starts: list, t: float):
    """The path of the segment holding time ``t``, or None."""
    i = bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else None


def _desc(d: dict) -> dict:
    return dict(sorted(((k, v / 1e6) for k, v in d.items()), key=lambda kv: -kv[1]))


def reduce(dev: list, ops: list, runtime: list) -> dict | None:
    """The module's quantities, or None where the trace holds no window or
    no device activity in it."""
    win = [(s, e) for n, s, e, _, _ in ops if n == devtrace.WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    inside = [(n, max(s, w0), min(e, w1), c, ln) for n, s, e, c, ln in dev if e > w0 and s < w1]
    if not inside:
        return None
    by_thread = {}
    for n, s, e, c, tid in ops:
        if n.startswith(PREFIX):
            by_thread.setdefault(tid, []).append((n, s, e, c))
    span_path = {c: p for r in by_thread.values() for c, p in paths(r).items()}
    segs = {tid: segments([r[:3] for r in rs]) for tid, rs in by_thread.items()}
    segs_all = segments([r[:3] for rs in by_thread.values() for r in rs])
    starts = {tid: [x[0] for x in sg] for tid, sg in segs.items()}
    starts_all = [x[0] for x in segs_all]
    host = {c: (s, tid) for n, s, e, c, tid in ops}
    calls = {c: (ln, s, tid) for c, ln, s, tid in runtime}

    def launched_in(corr, linked):
        """The span path of the host op that launched a device op (the
        runtime call's op where the device op links none): the op's own
        where it is a span, else that of the spans around the op, or
        around the runtime call where the op is not in the trace."""
        call = calls.get(corr)
        if not linked and call is not None:
            linked = call[0]
        if linked and linked in span_path:
            return span_path[linked]
        if linked and linked in host:
            t, tid = host[linked]
        elif call is not None:
            _, t, tid = call
        else:
            return None
        return _at(segs[tid], starts[tid], t) if tid in segs else _at(segs_all, starts_all, t)

    dev_path, by_op, unattributed, total = {}, {}, 0.0, 0.0
    for n, s, e, c, ln in inside:
        d = e - s
        total += d
        path = launched_in(c, ln)
        if path is None:
            unattributed += d
            continue
        dev_path[path] = dev_path.get(path, 0.0) + d
        ops_of = by_op.setdefault(path[-1], {})
        key = devtrace.op_name(n)
        ops_of[key] = ops_of.get(key, 0.0) + d

    by_span, in_span = {}, {}
    for path, d in dev_path.items():
        by_span[path[-1]] = by_span.get(path[-1], 0.0) + d
        for name in set(path):
            in_span[name] = in_span.get(name, 0.0) + d

    busy = devtrace.union((s, e) for _, s, e, _, _ in inside)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append([t, s])
        t = max(t, e)
    if t < w1:
        gaps.append([t, w1])
    idle = {}
    i = j = 0
    while i < len(gaps) and j < len(segs_all):
        lo, hi = max(gaps[i][0], segs_all[j][0]), min(gaps[i][1], segs_all[j][1])
        if hi > lo:
            name = segs_all[j][2][-1]
            idle[name] = idle.get(name, 0.0) + hi - lo
        if gaps[i][1] < segs_all[j][1]:
            i += 1
        else:
            j += 1
    rest = subtract(gaps, devtrace.union((s, e) for s, e, _ in segs_all))
    in_calls = devtrace.overlap(rest, devtrace.union((s, e) for n, s, e, _, _ in ops
                                                     if n == devtrace.CALL))
    idle["entry"] = in_calls
    idle["harness"] = sum(e - s for s, e in rest) - in_calls
    return {
        "window_s": (w1 - w0) / 1e6,
        "device_s": total / 1e6,
        "device_by_span": _desc(by_span),
        "device_in_span": _desc(in_span),
        "device_ops_by_span": {span: [[k, v] for k, v in list(_desc(o).items())[:TOP_OPS]]
                               for span, o in by_op.items()},
        "unattributed_device_s": unattributed / 1e6,
        "idle_s": sum(e - s for s, e in gaps) / 1e6,
        "idle_by_span": {k: v for k, v in _desc(idle).items() if v > 0},
    }


def read(prof) -> dict | None:
    return reduce(*raw_events(prof))
