"""Seconds from the process's start to the window's: imports, weights,
inputs, the first call (kernel builds, cuDNN's choices, graph captures)."""

def read(ctx):
    return ctx.setup_s
