"""Host seconds the process spent capturing CUDA graphs (the program's
counter ``utils/graphs.captures``), all of them in set-up: each step and
forward shape is captured on its first calls."""


def read(ctx):
    from i2v_tpu_torch.utils import graphs

    captures = getattr(graphs, "captures", None)
    return captures["seconds"] if captures and captures.get("graphs") else None
