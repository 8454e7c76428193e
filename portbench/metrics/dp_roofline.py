"""The DP kernels' share of their roofline: the least time of the DP's
work (roofline/dp.py: bytes over the card's memory bandwidth) over the
device time of the dp_spec, dp_check and dp_fixup kernels in the trace.
The positions are those of the lanes given to the block plans."""

from portbench.roofline import dp

KERNELS = ("dp_spec", "dp_check", "dp_fixup")


def read(ctx):
    trace, peaks = ctx.get("trace"), ctx.get("peaks")
    if not trace or not peaks or not ctx.get("dp_positions"):
        return None
    t = sum(s for name, s in trace["device_ops"] if name.startswith(KERNELS))
    if t <= 0:
        return None
    return 100.0 * dp.bytes_moved(ctx["dp_positions"]) / peaks["hbm_bytes_per_s"] / t
