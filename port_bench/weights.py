"""Seeded weights, made on the device in a few large calls.

Every floating parameter of a module is drawn from one normal stream
(``torch.Generator`` on the module's device, seeded from the run's seed and
the model's index) in the order of its name: a weight at a standard
deviation of 1/√fan_in (the port's initializer, without its truncation), a
bias at 0.01. The benchmark fills the program's module and the reference's
with the same draws, by name."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

BIAS_STD = 0.01


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of run ``seed`` (any seed
    below 2**62)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)


def draw(shapes: dict, seed: int, stream: int, device) -> dict:
    """{name: float32 tensor} for ``{name: shape}``: one normal draw for all
    of them, scaled per tensor."""
    names = sorted(shapes)
    numels = [math.prod(shapes[n]) for n in names]
    stds = [BIAS_STD if len(shapes[n]) == 1 else 1.0 / math.sqrt(math.prod(shapes[n][1:]))
            for n in names]
    flat = torch.randn(sum(numels), generator=generator(seed, stream, device), device=device)
    flat *= torch.repeat_interleave(torch.tensor(stds, device=device),
                                    torch.tensor(numels, device=device))
    return {n: t.view(shapes[n]) for n, t in zip(names, torch.split(flat, numels))}


def fill_(module: nn.Module, seed: int, stream: int) -> nn.Module:
    """Fill every parameter of ``module`` (on its device, or built on the
    meta device and moved with ``to_empty``) from :func:`draw`."""
    params = dict(module.named_parameters())
    if any(True for _ in module.buffers()):
        raise ValueError(f"{type(module).__name__} holds buffers: the draws fill parameters only")
    device = next(iter(params.values())).device
    values = draw({n: tuple(p.shape) for n, p in params.items()}, seed, stream, device)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(values[n])
    return module
