"""95th percentile (numpy's linear interpolation) of every timed call's
time, host clock from the call to its returned bytes."""

import numpy as np


def read(ctx):
    t = [e - s for s, e, _, ok in ctx["calls"] if ok]
    return float(np.percentile(t, 95)) * 1e3 if t else None
