"""torch.cuda.max_memory_reserved() over the window (reset at its start),
in 1e9 bytes: the memory the batch holds."""


def read(ctx):
    b = ctx.get("peak_reserved_bytes")
    return b / 1e9 if b else None
