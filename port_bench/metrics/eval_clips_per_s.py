"""Evaluated clips a second: clips whose predictions from every model are
back on the host, over the window (start to the end of its last sweep)."""

def read(ctx):
    return ctx.counts["clips"] / ctx.window_s if ctx.window_s > 0 and ctx.counts.get("clips") \
        else None
