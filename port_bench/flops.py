"""The yardstick's arithmetic: data-sheet peaks, the FLOPs of a cell's work
counted on the frozen reference, and the bytes of the rebuild kernels.

``analytic_conv_flops`` and ``PEAKS`` are copied from
``tools/torch_perf_probe.py``; the FLOPs of a step are counted with
``torch.utils.flop_counter`` on the meta device over the reference, which
computes no weight gradient (the weights are frozen)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# Dense data-sheet peaks by the name torch gives the card: NVIDIA H100 SXM5
# 80GB, at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989.4e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak(card: str, key: str):
    """A data-sheet peak of ``card``, or None for a card not in the table."""
    return PEAKS.get(card, {}).get(key)


def rebuild_fwd_bytes(numel: int, itemsize: int = 4) -> int:
    """K1 reads the clean frames and the modifier and writes the frames."""
    return 3 * numel * itemsize


def rebuild_bwd_bytes(numel: int, itemsize: int = 4) -> int:
    """K2 reads the clean frames, the modifier and the incoming gradient and
    writes the modifier's gradient."""
    return 4 * numel * itemsize


def counted(fn) -> int:
    """FLOPs of the aten ops ``fn()`` dispatches."""
    with FlopCounterMode(display=False) as c:
        fn()
    return int(c.get_total_flops())


def gen_flops(models, n_frames: int, hw: int) -> tuple[int, int]:
    """(FLOPs of one Adam step, FLOPs of the clean-tap forward) of ENS-I2V
    over ``n_frames`` frames of ``hw``², on meta copies of ``models``."""

    def forward():
        x = torch.empty(n_frames, 3, hw, hw, device="meta")
        with torch.no_grad():
            for m in models:
                m(x)

    def step():
        x = torch.empty(n_frames, 3, hw, hw, device="meta", requires_grad=True)
        sum(m(x).sum() for m in models).backward()

    return counted(step), counted(forward)


def forward_flops(model, shape) -> int:
    """FLOPs of one forward of ``model`` (meta) over an input of ``shape``."""
    with torch.no_grad():
        return counted(lambda: model(torch.empty(shape, device="meta")))


def analytic_conv_flops(models, n_frames: int, hw: int) -> int:
    """The convolutions' FLOPs of one step over ``n_frames`` frames, from the
    layers: each conv's forward, 2·N·C_out·H_out·W_out·(C_in/groups)·k_h·k_w,
    plus its input gradient, the same count again, where the taps depend on
    its output (read off the autograd graph of the meta models)."""
    total = 0
    for m in models:
        convs = []

        def hook(mod, inp, out, convs=convs):
            entry = [mod, tuple(out.shape), False]
            convs.append(entry)
            if out.requires_grad:
                out.register_hook(lambda g, entry=entry: entry.__setitem__(2, True))

        handles = [mod.register_forward_hook(hook) for mod in m.modules()
                   if isinstance(mod, torch.nn.Conv2d)]
        try:
            x = torch.empty(n_frames, 3, hw, hw, device="meta", requires_grad=True)
            torch.autograd.grad(m(x).sum(), x)
        finally:
            for h in handles:
                h.remove()
        for mod, out_shape, reached in convs:
            k_h, k_w = mod.kernel_size
            fwd = 2 * out_shape[0] * out_shape[1] * out_shape[2] * out_shape[3] \
                * (mod.in_channels // mod.groups) * k_h * k_w
            total += fwd * (2 if reached else 1)
    return total
