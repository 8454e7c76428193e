"""Milliseconds a MiB of input in the span of device_pipeline's
``split_batch`` (synchronized on both sides), over the traced window."""

from portbench.metrics import stage_ms_per_MiB


def read(ctx):
    return stage_ms_per_MiB(ctx, "split_batch")
