"""K1 and K2 (csrc/rebuild_adv.cu) against their memory bound, in %: the
bytes the window's launches must move (K1 reads 2 tensors and writes 1, K2
moves 4, each once) over 3.35 TB/s, summed, over the launches' summed
device time in the trace."""

from port_bench import flops


def read(ctx):
    bw = flops.peak(ctx.card, "hbm_bytes_per_s")
    plan = ctx.work.get("rebuild_bytes")
    if ctx.trace is None or bw is None or not plan:
        return None
    us = ctx.trace.kernel_us(lambda n: any(k in n for k in plan))
    if us <= 0:
        return None
    return 100.0 * sum(plan.values()) / bw / (us / 1e6)
