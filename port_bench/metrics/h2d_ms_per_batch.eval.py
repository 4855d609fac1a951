"""Device ms of host-to-device copies a batch uploaded."""

from port_bench.readers import per


def read(ctx):
    if ctx.trace is None:
        return None
    us = sum(d for n, _, d in ctx.trace.copies if "HtoD" in n)
    return per(us / 1e3 if us > 0 else None, ctx.counts.get("batches"))
