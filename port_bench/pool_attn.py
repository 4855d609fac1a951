"""The yardstick of the MViT cell's pooling-attention kernel
(``pool_attn_fwd_kernel``, the port's ``csrc/pool_attn.cu``): its launches,
operations and bytes for the clips a window completed, counted from the
configuration's published geometry (``prepare_mvit_configs`` and the
pooled grids of :mod:`.reference.mvit`), not read from the program.

One launch a block, over every (clip, head) of a batch: 4·(1 + Nq)·(1 + Nk)·hd
FLOPs a (clip, head) (q·kᵀ and p·v, a multiply-add two, the class token
included), and q, k, v and the output moved once each, (1 + N)·hd values of
each, plus the three per-query relative terms read once, Nq·(kt + kh + kw)
values."""

from __future__ import annotations

import math

from .reference.mvit import prepare_mvit_configs, round_width

KERNEL = "pool_attn_fwd_kernel"


def _pooled(size, kernel, stride) -> list:
    return [(s + 2 * (k // 2) - k) // st + 1 for s, k, st in zip(size, kernel, stride)]


def blocks(config: dict) -> list:
    """(heads, 1 + Nq, 1 + Nk, head dim, kt + kh + kw) of each block of one
    clip's forward, in order."""
    _, _, _, _, stride_q, stride_kv = prepare_mvit_configs(config)
    dim_mul, head_mul = dict(map(tuple, config["dim_mul"])), dict(map(tuple, config["head_mul"]))
    sizes = (config["frames"], config["hw"], config["hw"])
    grid = [(s + 2 * p - k) // st + 1 for s, k, st, p in zip(
        sizes, config["patch_kernel"], config["patch_stride"], config["patch_padding"])]
    kernel, dim, heads, out = config["pool_kvq_kernel"], config["embed_dim"], \
        config["num_heads"], []
    for i in range(config["depth"]):
        heads = round_width(heads, head_mul.get(i, 1.0))
        dim = round_width(dim, dim_mul.get(i, 1.0))
        q_grid = _pooled(grid, kernel, stride_q[i] or (1, 1, 1))
        k_grid = _pooled(grid, kernel, stride_kv[i])
        out.append((heads, 1 + math.prod(q_grid), 1 + math.prod(k_grid), dim // heads,
                    sum(k_grid)))
        grid = q_grid
    return out


def launch_work(config: dict, batch: int, itemsize: int = 4) -> list:
    """[(FLOPs, bytes)] of each launch of a ``batch``-clip forward."""
    return [(4 * batch * heads * nq1 * nk1 * hd,
             batch * heads * ((2 * nq1 + 2 * nk1) * hd + (nq1 - 1) * terms) * itemsize)
            for heads, nq1, nk1, hd, terms in blocks(config)]
