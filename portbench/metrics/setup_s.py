"""Process start to the first timed call: imports, the CUDA context, the
kernels' load (their build on a checkout's first run), the inputs made
from the seed and the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
