"""The depthwise 3-D conv kernel (``csrc/dwconv3d.cu``) against its
roofline, in %: for each launch of the window's completed sweeps, the larger
of its FLOPs over the card's float32 peak and its bytes over 3.35 TB/s
(:mod:`port_bench.dwconv3d`), summed, over the kernel's summed device time
in the trace; None where the kernel never ran."""

from port_bench import flops
from port_bench.dwconv3d import KERNEL


def read(ctx):
    peak, bw = flops.peak(ctx.card, "float32"), flops.peak(ctx.card, "hbm_bytes_per_s")
    plan = ctx.work.get("dwconv3d")
    if ctx.trace is None or peak is None or bw is None or not plan:
        return None
    us = ctx.trace.kernel_us(lambda n: KERNEL in n)
    if us <= 0:
        return None
    bound_s = sum(max(f / peak, b / bw) * count for f, b, count in plan)
    return 100.0 * bound_s / (us / 1e6)
