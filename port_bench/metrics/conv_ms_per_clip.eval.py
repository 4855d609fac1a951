"""Device ms of convolution kernels an evaluated clip (all six models)."""

from port_bench.readers import conv_ms, per


def read(ctx):
    return per(conv_ms(ctx), ctx.counts.get("clips"))
