"""torch.cuda.max_memory_allocated over set-up and the window, in GiB."""

def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
