"""Device ms of convolution kernels (the classes conv, conv dgrad, conv fft)
a completed Adam step; each call's clean-tap forward is in it."""

from port_bench.readers import conv_ms, per


def read(ctx):
    return per(conv_ms(ctx), ctx.counts.get("steps"))
