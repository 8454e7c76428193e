"""Milliseconds a MiB of input in the span of device_pipeline's
``emit_window_from_plan`` (synchronized on both sides), over the traced window."""

from portbench.metrics import stage_ms_per_MiB


def read(ctx):
    return stage_ms_per_MiB(ctx, "emit_window_from_plan")
