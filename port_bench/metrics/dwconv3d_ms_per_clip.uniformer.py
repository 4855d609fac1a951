"""Device ms of the depthwise 3-D conv kernel (``dwconv3d_kernel``) an
evaluated clip (traced run); None where the kernel never ran."""

from port_bench.dwconv3d import KERNEL
from port_bench.readers import per


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(lambda n: KERNEL in n)
    return per(us / 1e3 if us > 0 else None, ctx.counts.get("clips"))
