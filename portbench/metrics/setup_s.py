"""Seconds from the start of the process to the window: imports, the device,
the inputs, the trainer, the kernel library and the first rounds."""


def read(ctx):
    return ctx["setup_s"]
