"""The yardstick of the Swin cell's window-attention kernel
(``window_attn_fwd_kernel``, the port's ``csrc/window_attn.cu``): its
launches, operations and bytes for the clips a window completed, counted
from the configuration's published geometry (``get_window_size`` of
:mod:`.reference.swin3d`), not read from the program.

One launch a block, over every (window, head) of a batch: 4·N²·hd FLOPs a
(window, head) (q·kᵀ and p·v, a multiply-add two), and q, k, v read and
the output written once each, N·hd values of each, plus the bias table's
rows of every head read once a launch."""

from __future__ import annotations

import math

from .reference.swin3d import get_window_size

KERNEL = "window_attn_fwd_kernel"


def blocks(config: dict) -> list:
    """(windows·heads a clip, N, head dim, table rows·heads) of each block of
    one clip's forward, in order."""
    patch, window = config["patch_size"], tuple(config["window_size"])
    grid = [-(-s // p) for s, p in zip((config["frames"], config["hw"], config["hw"]), patch)]
    rows = math.prod(2 * w - 1 for w in window)
    out = []
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        if i:
            grid = [grid[0], -(-grid[1] // 2), -(-grid[2] // 2)]
        used, _ = get_window_size(tuple(grid), window, tuple(w // 2 for w in window))
        windows = math.prod(-(-g // w) for g, w in zip(grid, used))
        hd = config["embed_dim"] * 2**i // heads
        out += [(windows * heads, math.prod(used), hd, rows * heads)] * depth
    return out


def launch_work(config: dict, batch: int, itemsize: int) -> list:
    """[(FLOPs, bytes)] of each launch of a ``batch``-clip forward."""
    return [(4 * batch * wh * n * n * hd, 4 * batch * wh * n * hd * itemsize + 4 * table)
            for wh, n, hd, table in blocks(config)]
