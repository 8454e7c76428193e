"""Share of the traced window in which no operation ran on the device:
1 - (the union of the device's activity intervals) / the window."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
