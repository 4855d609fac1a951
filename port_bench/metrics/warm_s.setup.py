"""Host seconds of the eager first run of each shape (the program's one-off
span ``setup.warm``: a step graph's eager step 0, a runner's or the Adam
engine's first clean-tap forward of a frame shape, each ended by a device
synchronize), less the one-off spans opened inside them (the kernels' build
when the first run launches the first kernel), all of it in set-up."""


def read(ctx):
    from i2v_tpu_torch.utils import profiling

    records = profiling.spans()
    warm = [r for r in records if r.name == "setup.warm"]
    if not warm:
        return None
    inner = [r for r in records if getattr(r, "once", False) and r.outer == "setup.warm"]
    return sum(r.host_s for r in warm) - sum(r.host_s for r in inner)
