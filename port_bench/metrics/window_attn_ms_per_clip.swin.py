"""Device ms of the window-attention kernel (``window_attn_fwd_kernel``) an
evaluated clip (traced run)."""

from port_bench.readers import per
from port_bench.window_attn import KERNEL


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(lambda n: KERNEL in n)
    return per(us / 1e3 if us > 0 else None, ctx.counts.get("clips"))
