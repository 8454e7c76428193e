"""Input megabytes (1e6 B) of the calls completed in the window over the
whole window: first call's start to last call's end."""


def read(ctx):
    done = sum(n for _, _, n, ok in ctx["calls"] if ok)
    return done / 1e6 / ctx["window_s"] if ctx["window_s"] > 0 and done else None
