"""Device ms of the pooling-attention kernel (``pool_attn_fwd_kernel``) an
evaluated clip (traced run)."""

from port_bench.pool_attn import KERNEL
from port_bench.readers import per


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(lambda n: KERNEL in n)
    return per(us / 1e3 if us > 0 else None, ctx.counts.get("clips"))
