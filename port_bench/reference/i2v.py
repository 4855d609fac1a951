"""ENS-I2V's Adam steps in plain PyTorch (reference: image_attacks.py:236-496).

The clean clips are flattened to frames, the modifier starts at 0.01/255,
and each step rebuilds ``clamp(clean + clamp(modifier, ±ε), 0, 1)``, runs
the surrogates up to their taps, sums the per-frame cosine between the
adversarial and the clean taps over frames and taps, and steps
``torch.optim.Adam`` on the gradient of that sum. The frames are taken in
blocks, whose gradients are written side by side: every frame's cosine
depends on its own frame alone, so the blocks give the whole batch's cost
and gradient while only one block's activations are alive."""

from __future__ import annotations

import torch

MODIFIER_INIT = 0.01 / 255
COS_EPS = 1e-8


def flatten(clips: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) → (B·T, C, H, W), clip-major."""
    b, c, t, h, w = clips.shape
    return clips.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)


def rebuild(clean01: torch.Tensor, modifier: torch.Tensor, epsilon: float) -> torch.Tensor:
    return torch.clamp(clean01 + torch.clamp(modifier, -epsilon, epsilon), 0.0, 1.0)


def frame_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine of each row of ``a`` with the row of ``b``, norms clamped at 1e-8."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    na = torch.clamp(torch.linalg.vector_norm(a, dim=1), min=COS_EPS)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=1), min=COS_EPS)
    return torch.sum(a * b, dim=1) / (na * nb)


def adam_attack(models, clean_frames: torch.Tensor, *, steps: int, lr: float, epsilon: float,
                block: int, init=None):
    """→ (per-step costs (steps,), final modifier, Adam's first moment) of
    ``steps`` Adam steps over ``clean_frames`` ((N, 3, H, W) in [0,1]),
    ``block`` frames at a time: from the 0.01/255 fill, or resumed from
    ``init = (modifier, (step, exp_avg, exp_avg_sq))``, a modifier and Adam's
    state after ``step`` steps, in the frames' layout."""
    n = clean_frames.shape[0]
    bounds = [(i, min(i + block, n)) for i in range(0, n, block)]
    with torch.no_grad():
        clean_taps = [[m(clean_frames[i:j]) for m in models] for i, j in bounds]
    if init is None:
        modifier = torch.full_like(clean_frames, MODIFIER_INIT)
    else:
        modifier = init[0].detach().to(clean_frames.device, torch.float32, copy=True)
    modifier.requires_grad_(True)
    opt = torch.optim.Adam([modifier], lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    if init is not None:
        step, first, second = init[1]
        opt.state[modifier] = {
            "step": torch.tensor(float(torch.as_tensor(step)), dtype=torch.float32),
            "exp_avg": first.detach().to(modifier, copy=True),
            "exp_avg_sq": second.detach().to(modifier, copy=True)}
    costs = torch.zeros(steps, dtype=torch.float64)
    for s in range(steps):
        grad = torch.empty_like(modifier)
        total = 0.0
        for (i, j), taps in zip(bounds, clean_taps):
            m = modifier.detach()[i:j].requires_grad_(True)
            with torch.enable_grad():
                adv = rebuild(clean_frames[i:j], m, epsilon)
                cost = sum(torch.sum(frame_cosines(mod(adv), c)) for mod, c in zip(models, taps))
                (g,) = torch.autograd.grad(cost, m)
            grad[i:j] = g
            total = total + cost.detach()
        costs[s] = float(total)
        modifier.grad = grad
        opt.step()
    return costs, modifier.detach(), opt.state[modifier]["exp_avg"]
