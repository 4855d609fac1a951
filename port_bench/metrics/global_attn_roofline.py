"""The global attention against its roofline, in %: for each attention
block of the window's evaluated clips, the larger of its FLOPs over the
card's TF32 peak / 3 (float32-accurate products through three TF32 products)
and its q, k, v and output moved once over 3.35 TB/s, summed
(:mod:`port_bench.global_attn`), over the summed device time of the kernels
that ran it (the port's ``global_attn_fwd_kernel`` or SDPA's
``fmha_cutlass``); None where neither ran."""

from port_bench import flops, global_attn


def read(ctx):
    peak, bw = flops.peak(ctx.card, "tf32"), flops.peak(ctx.card, "hbm_bytes_per_s")
    clips = ctx.counts.get("clips")
    if ctx.trace is None or peak is None or bw is None or not clips:
        return None
    us = ctx.trace.kernel_us(global_attn.is_kernel)
    if us <= 0:
        return None
    return 100.0 * global_attn.bound_s(ctx.config, clips, peak, bw) / (us / 1e6)
