"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GB (1e9 bytes)."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9
