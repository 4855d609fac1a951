"""Seconds of set-up that no one-off span of the program holds: ``setup_s``
less the host seconds of the outermost spans ``setup.kernels``,
``setup.warm`` and ``setup.capture``. What is left is the imports, the CUDA
context, the benchmark's own weights and inputs, the first call's replayed
steps and hand-back, and whatever still has no span. With
``kernel_load_s.setup``, ``warm_s.setup`` and ``graph_capture_s.setup`` it
sums to ``setup_s``."""


def read(ctx):
    from i2v_tpu_torch.utils import profiling

    outermost = [r for r in profiling.spans()
                 if getattr(r, "once", False) and r.outer is None]
    return ctx.setup_s - sum(r.host_s for r in outermost) if outermost else None
