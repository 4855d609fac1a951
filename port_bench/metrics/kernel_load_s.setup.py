"""Host seconds the process spent building and loading the hand-written
kernels' libraries (the program's one-off span ``setup.kernels``, around
``ops/kernels.build_all``: nvcc for each library not built yet, then the
loads), all of it in set-up."""


def read(ctx):
    from i2v_tpu_torch.utils import profiling

    builds = [r for r in profiling.spans() if r.name == "setup.kernels"]
    return sum(r.host_s for r in builds) if builds else None
