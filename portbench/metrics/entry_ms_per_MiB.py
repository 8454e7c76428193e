"""Milliseconds a MiB of input in the calls outside the four stage spans:
framing, checksum and batching in stream.compress and
device_pipeline.compress_device. Nothing where a stage span is missing."""

from portbench.metrics import window_MiB
from portbench.spans import STAGES


def read(ctx):
    stages = ctx.get("stage_s", {})
    mib = window_MiB(ctx)
    if not mib or any(s not in stages for s in STAGES):
        return None
    wall = sum(e - s for s, e, _, ok in ctx["calls"] if ok)
    return 1e3 * (wall - sum(stages.values())) / mib
