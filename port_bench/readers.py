"""Arithmetic that several metrics' readers share (``metrics/<name>.py``).
Each returns None where its run has nothing to read."""

from __future__ import annotations

from . import flops, trace


def idle_percent(ctx):
    if ctx.trace is None or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)


def mfu_percent(ctx):
    """The work's FLOPs over the window, as a share of the card's float32
    peak (TF32 off: the configurations' numerics)."""
    peak = flops.peak(ctx.card, "float32")
    if peak is None or ctx.window_s <= 0 or not ctx.work.get("flops"):
        return None
    return 100.0 * ctx.work["flops"] / ctx.window_s / peak


def conv_ms(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(lambda n: trace.kernel_class(n) in trace.CONV_CLASSES)
    return us / 1e3 if us > 0 else None


def per(value, count):
    return None if value is None or not count else value / count
