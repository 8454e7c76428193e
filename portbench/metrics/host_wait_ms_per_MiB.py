"""Milliseconds a MiB of input the host spent in the program's
``zultra.wait`` span (``to_host``: its copies and its one stream
synchronize), host clock, over the traced window."""

from portbench.metrics import window_MiB
from portbench.progtrace import program_report


def read(ctx):
    span = (program_report() or {}).get("spans", {}).get("zultra.wait")
    mib = window_MiB(ctx)
    return 1e3 * span["total_s"] / mib if span and mib else None
