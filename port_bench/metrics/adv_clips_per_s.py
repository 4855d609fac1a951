"""Adversarial clips a second: Adam steps completed in the window, times the
batch, over the attack's steps a clip, over the window (start to the end of
its last call)."""

def read(ctx):
    return ctx.counts.get("clip_steps", 0) / ctx.config["steps"] / ctx.window_s \
        if ctx.window_s > 0 and ctx.counts.get("clip_steps") else None
