"""One reader a metric, ``<name>.py`` with ``read(ctx)``: the metric's
value from the run's context, or None where the run holds nothing to
read (the harness then leaves the metric out). ``ctx`` holds:

- ``calls``: (start_s, end_s, input_bytes, ok) of every timed call;
- ``window_s``: first call's start to last call's end, host clock;
- ``setup_s``: process start to the first timed call;
- ``stage_s``: seconds of each stage span (traced runs);
- ``dp_positions``: block positions the planner was given (traced runs);
- ``trace``: ``devtrace.read``'s quantities (traced runs) or None;
- ``peak_reserved_bytes``: the allocator's peak over the window (traced);
- ``device_kind`` and ``peaks``: the card's name and its row of
  ``peaks.json`` (None if absent).
"""

MiB = 1 << 20


def window_MiB(ctx) -> float:
    return sum(n for _, _, n, ok in ctx["calls"] if ok) / MiB


def stage_ms_per_MiB(ctx, stage: str):
    s = ctx.get("stage_s", {}).get(stage)
    mib = window_MiB(ctx)
    return None if s is None or not mib else 1e3 * s / mib
