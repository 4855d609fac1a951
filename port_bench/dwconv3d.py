"""The yardstick of the UniFormer cell's depthwise 3-D conv kernel
(``dwconv3d_kernel``, the port's ``csrc/dwconv3d.cu``): its launches,
operations and bytes for the clips a window completed, counted from the
configuration's published geometry (the stage grids of
:mod:`.reference.uniformer`), not read from the program.

Two launches a conv block (its DPE, 3³, and its local affinity, 5³) and one
an attention block (its DPE), over every clip of a batch: 2·k³·C·N FLOPs a
clip (a multiply-add two, each of the N tokens' C channels), and the input
and output moved once each, 2·C·N values a clip; the weights, k³·C values a
launch, are left out."""

from __future__ import annotations

KERNEL = "dwconv3d_kernel"


def stage_grids(config: dict) -> list:
    """The (T, H, W) token grid of each stage."""
    sizes = (config["frames"], config["hw"], config["hw"])
    grid = [(s + 2 * p - k) // st + 1 for s, k, st, p in zip(
        sizes, config["patch_kernel"], config["patch_stride"], config["patch_padding"])]
    out = [tuple(grid)]
    for _ in config["embed_dim"][1:]:
        grid = [g // k for g, k in zip(grid, config["merge_kernel"])]
        out.append(tuple(grid))
    return out


def launches(config: dict) -> list:
    """(k, C, N) of each launch of one clip's forward, in order."""
    out = []
    for s, (grid, dim) in enumerate(zip(stage_grids(config), config["embed_dim"])):
        n = grid[0] * grid[1] * grid[2]
        conv = s < config["conv_stages"]
        for _ in range(config["depth"][s]):
            out.append((config["dpe_kernel"], dim, n))
            if conv:
                out.append((config["local_kernel"], dim, n))
    return out


def launch_work(config: dict, batch: int, itemsize: int = 4) -> list:
    """[(FLOPs, bytes)] of each launch of a ``batch``-clip forward."""
    return [(2 * k ** 3 * c * n * batch, 2 * c * n * batch * itemsize)
            for k, c, n in launches(config)]
