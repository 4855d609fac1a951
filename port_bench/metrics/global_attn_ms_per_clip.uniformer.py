"""Device ms of the global attention an evaluated clip (traced run): the
port's ``global_attn_fwd_kernel`` or SDPA's ``fmha_cutlass`` kernels, which
an earlier port called (:mod:`port_bench.global_attn`); None where neither
ran."""

from port_bench.global_attn import is_kernel
from port_bench.readers import per


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(is_kernel)
    return per(us / 1e3 if us > 0 else None, ctx.counts.get("clips"))
