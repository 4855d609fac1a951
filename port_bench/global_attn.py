"""The yardstick of the UniFormer cell's global attention, whatever runs it:
the port's kernel (``global_attn_fwd_kernel``, ``csrc/global_attn.cu``) or
SDPA's memory-efficient kernels (``fmha_cutlass…``), which an earlier port
called. Its work for the clips a window completed is counted from the
configuration's published geometry (the stage grids of
:mod:`.dwconv3d`), not read from the program.

One launch an attention block (the stages past ``conv_stages``), over every
(clip, head) of a batch: 4·N²·hd FLOPs a (clip, head) (q·kᵀ and p·v, a
multiply-add two), and q, k, v and the output moved once each, 4·N·hd values.
Float32-accurate products on the tensor cores take three TF32 products each
(3xTF32), so their bound is the card's TF32 peak over 3: no float32-accurate
implementation on the card (the CUDA cores' FFMA at 67 TFLOP/s included) can
beat it."""

from __future__ import annotations

from .dwconv3d import stage_grids

KERNELS = ("global_attn_fwd_kernel", "fmha_cutlass")
# TF32 products a float32-accurate product takes
PRODUCTS = 3


def is_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def blocks(config: dict) -> list:
    """(heads, N, head dim) of each attention block of one clip's forward,
    in order."""
    hd, out = config["head_dim"], []
    for s, (grid, dim) in enumerate(zip(stage_grids(config), config["embed_dim"])):
        if s >= config["conv_stages"]:
            n = grid[0] * grid[1] * grid[2]
            out += [(dim // hd, n, hd)] * config["depth"][s]
    return out


def clip_work(config: dict, itemsize: int = 4) -> list:
    """[(FLOPs, bytes)] of each attention block of one clip's forward."""
    return [(4 * heads * n * n * hd, 4 * heads * n * hd * itemsize)
            for heads, n, hd in blocks(config)]


def bound_s(config: dict, clips: int, tf32_peak: float, bytes_per_s: float,
            itemsize: int = 4) -> float:
    """The least time the card could take for ``clips`` clips' global
    attention: each block's larger of its FLOPs at ``tf32_peak`` / 3 and its
    bytes at ``bytes_per_s``, summed."""
    return clips * sum(max(PRODUCTS * f / tf32_peak, b / bytes_per_s)
                       for f, b in clip_work(config, itemsize))
