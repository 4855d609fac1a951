"""The reference's own ENS-I2V and AENS-I2V-MF steps beside the port's, on one
CUDA card, with the same weights.

PyTorch counterpart of ``tools/baseline_anchor.py``. The reference's step is
restated as that tool restates it (``time_torch_ens`` and
``time_torch_aens``): ``tools/torch_surrogates.py``'s full networks with
forward hooks on the reference's tap modules (image_attacks.py:260-271,
TPAMI_attack.py:176-200), ``F.cosine_similarity`` summed over frames, and
``torch.optim.Adam`` on the modifier (image_attacks.py:405-480,
TPAMI_attack.py:225-313). The port's side, in place of the JAX step, is its
production runner (``parallel/sharded.make_sharded_i2v_runner``,
``frame_chunk="auto"``) over the same weights: the surrogates' state_dicts
go through ``models.convert.convert_torchvision`` into the port's
registries. On the card this is the one "vs reference" figure the port can
measure: the same card, framework and weights.

A gate on equality comes first: both sides start from the same clip and
modifier, and their step-0 costs must agree within ``COST_RTOL`` (relative)
in float32 with TF32 off before their steps/s are compared; the tool exits
non-zero otherwise. In torch's default mode (TF32 convolutions) the step-0
difference is printed, not gated.

    python tools/torch_baseline_anchor.py [--batches 1,16] [--modes float32,default]
        [--methods ens,aens] [--steps 3] [--out BASELINE_ANCHOR_TORCH.json]

Each (method, batch, mode) prints one line. The reference's steps/s is the
mean of ``--steps`` warm steps after one cold one; the port's is
``--steps`` over the time a (steps+1)-step call takes beyond a 1-step call,
both warm, so that neither side pays its one-off clean-tap forward in the
rate. Each side's FLOPs a step are counted on the meta device
(``tools/torch_perf_probe.OpCounter``): the reference's full forwards count
past the taps the port's truncated ones leave out. Peak GiB is
``torch.cuda.max_memory_allocated`` of each side. The reference keeps every
activation past its taps, so a batch that does not fit is recorded as such,
not shrunk. The file gets the card's name and power limit. It runs on
``--device cuda`` and exits without a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import torch_perf_probe as probe  # noqa: E402

ARTIFACT = os.path.join(ROOT, "BASELINE_ANCHOR_TORCH.json")
EPS = 16 / 255
STEP_SIZE = 0.005
MODIFIER_INIT = 0.01 / 255  # image_attacks.py:197,304,436
ENS_NAMES = ["resnet", "vgg", "squeezenet", "alexnet"]
ENS_DEPTHS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
AENS_DEPTHS = {n: [2, 3] for n in ENS_NAMES}
COST_RTOL = 1e-5
SEED = 0
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def torch_models(device="cpu", seed: int = SEED) -> dict:
    """The reference's four surrogates (``tools/torch_surrogates.py``), seeded,
    frozen, in eval mode, on ``device``."""
    from tools import torch_surrogates as tvm

    torch.manual_seed(seed)
    mdls = {"resnet": tvm.resnet101(), "vgg": tvm.vgg16(),
            "squeezenet": tvm.squeezenet1_1(), "alexnet": tvm.alexnet()}
    for m in mdls.values():
        m.eval().requires_grad_(False)
    return {k: m.to(device) for k, m in mdls.items()}


def ens_taps(mdls: dict) -> list:
    """The reference's ENS tap modules (image_attacks.py:260-271)."""
    return [mdls["resnet"].layer2[-1], mdls["vgg"].features[20],
            mdls["squeezenet"].features[6].expand3x3_activation, mdls["alexnet"].features[7]]


def aens_taps(mdls: dict) -> list:
    """The TPAMI 8-tap list branch (TPAMI_attack.py:176-200): the squeezenet
    list hooks the whole Fire module."""
    return [mdls["resnet"].layer2[-1], mdls["resnet"].layer3[-1],
            mdls["vgg"].features[11], mdls["vgg"].features[20],
            mdls["squeezenet"].features[6], mdls["squeezenet"].features[9],
            mdls["alexnet"].features[4], mdls["alexnet"].features[7]]


def reference_attack(mdls: dict, frames01: torch.Tensor, adaptive: bool, modifier0=None):
    """The reference's step over ``frames01`` (B·T, 3, H, W) in [0, 1]:
    returns ``(step, modifier, remove)``. ``step()`` runs one Adam step and
    returns its cost, taken before the update; ``modifier.grad`` then holds
    that cost's gradient. The modifier starts at ``modifier0`` or the
    reference's 0.01/255 fill; ``remove()`` takes the hooks off."""
    acts: list = []
    handles = [m.register_forward_hook(lambda mod, i, o: acts.append(o))
               for m in (aens_taps(mdls) if adaptive else ens_taps(mdls))]
    frames = frames01.shape[0]
    mean = torch.tensor(MEAN, device=frames01.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=frames01.device).view(1, 3, 1, 1)
    x = (frames01 - mean) / std
    unnorm = (x * std + mean).detach()
    modifier = torch.nn.Parameter(torch.full_like(x, MODIFIER_INIT) if modifier0 is None
                                  else modifier0.detach().clone())
    opt = torch.optim.Adam([modifier], lr=STEP_SIZE)

    acts.clear()
    with torch.no_grad():
        for name in ENS_NAMES:
            mdls[name](x)
    init_feats = [a.detach().reshape(frames, -1) for a in acts]
    n_taps = len(init_feats)
    state = {"prev_loss": torch.ones(n_taps, device=x.device)}

    def step() -> torch.Tensor:
        acts.clear()
        true_image = torch.clamp(unnorm + torch.clamp(modifier, -EPS, EPS), 0, 1)
        xn = (true_image - mean) / std
        for name in ENS_NAMES:
            mdls[name](xn)
        if adaptive:
            # the adaptive coefficients (TPAMI_attack.py:264), momentum 0,
            # coef_CE=False: the unweighted per-tap frame sums drive them
            coeffs = torch.softmax(torch.softmax(state["prev_loss"], dim=0), dim=0)
            cos = torch.stack([F.cosine_similarity(a.reshape(frames, -1), init)
                               for a, init in zip(acts, init_feats)])
            cost = torch.mean(torch.sum(coeffs.unsqueeze(1) * cos, dim=1))
            state["prev_loss"] = torch.sum(cos.detach(), dim=1)
        else:
            cost = sum(torch.sum(F.cosine_similarity(a.reshape(frames, -1), init))
                       for a, init in zip(acts, init_feats))
        opt.zero_grad()
        cost.backward()
        opt.step()
        return cost.detach()

    def remove() -> None:
        for h in handles:
            h.remove()

    return step, modifier, remove


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_torch_ens(mdls: dict, frames01: torch.Tensor, steps: int, adaptive: bool = False,
                   warmup: int = 1) -> dict:
    """The reference's ENS (or, ``adaptive``, AENS) step timed on
    ``frames01``'s device: the step-0 cost of the first (cold) step, then the
    mean time of ``steps`` warm steps."""
    step, _, remove = reference_attack(mdls, frames01, adaptive)
    try:
        costs = [float(step()) for _ in range(warmup)]
        _sync(frames01.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        _sync(frames01.device)
        step_s = (time.perf_counter() - t0) / steps
    finally:
        remove()
    return {"cost0": costs[0], "step_s": step_s, "steps_per_s": 1.0 / step_s}


def time_torch_aens(mdls: dict, frames01: torch.Tensor, steps: int, warmup: int = 1) -> dict:
    """The reference's AENS-I2V-MF step (TPAMI_attack.py:225-313) timed."""
    return time_torch_ens(mdls, frames01, steps, adaptive=True, warmup=warmup)


def convert_weights(mdls: dict, ckpt_dir: str) -> None:
    """Each reference model's state_dict through ``convert_torchvision``
    into ``ckpt_dir``, where the port's registry reads it."""
    from i2v_tpu_torch.models import convert

    for name in ENS_NAMES:
        convert.convert_torchvision(name, mdls[name].state_dict(), ckpt_dir)


def port_models(depths: dict, device, ckpt_dir: str, hw: int = 224) -> list:
    """The port's surrogates read from ``ckpt_dir`` (:func:`convert_weights`)."""
    from i2v_tpu_torch.models import get_image_models

    saved = os.environ.get("I2V_TPU_CKPTS")
    os.environ["I2V_TPU_CKPTS"] = ckpt_dir
    try:
        return get_image_models(ENS_NAMES, depths, device=device, input_hw=hw)
    finally:
        if saved is None:
            os.environ.pop("I2V_TPU_CKPTS", None)
        else:
            os.environ["I2V_TPU_CKPTS"] = saved


def port_runner(models: list, steps: int, adaptive: bool):
    from i2v_tpu_torch.parallel.sharded import make_sharded_i2v_runner

    return make_sharded_i2v_runner(models, steps=steps, step_size=STEP_SIZE, epsilon=EPS,
                                   adaptive=adaptive, frame_chunk="auto")


def time_port(models: list, clip01: torch.Tensor, steps: int, adaptive: bool) -> dict:
    """The port's step-0 cost at the 0.01/255 fill, and its steps/s: ``steps``
    over the time a (steps+1)-step call takes beyond a 1-step call, both
    warm: each runner is called twice before the timed pair, since on a card
    a runner captures its step graph at its second step, which for the
    1-step runner is in its second call."""
    from i2v_tpu_torch.ops import pixel

    one, more = port_runner(models, 1, adaptive), port_runner(models, steps + 1, adaptive)
    modifier = torch.full_like(pixel.flatten_clip_to_frames(clip01), MODIFIER_INIT)
    cost0, _ = one.value_and_grad(clip01, modifier)
    walls = {}
    for label, runner in (("one", one), ("more", more)) * 3:
        _sync(clip01.device)
        t0 = time.perf_counter()
        runner(clip01)
        _sync(clip01.device)
        walls[label] = time.perf_counter() - t0
    step_s = (walls["more"] - walls["one"]) / steps
    return {"cost0": float(cost0), "step_s": step_s, "steps_per_s": 1.0 / step_s}


def counted_flops(batch: int, hw: int, adaptive: bool) -> dict:
    """FLOPs of one step of each side, counted on the meta device."""
    frames = batch * 32
    with torch.device("meta"):
        mdls = torch_models("meta")
    step, _, remove = reference_attack(mdls, torch.empty(frames, 3, hw, hw, device="meta"),
                                       adaptive)
    try:
        with probe.OpCounter() as c:
            step()
    finally:
        remove()
    port = probe.count_step(probe.meta_models(ENS_NAMES, AENS_DEPTHS if adaptive
                                              else ENS_DEPTHS), batch, hw,
                            adaptive=adaptive)
    return {"reference": c.flops, "port": port["flops_per_step"]}


def _measure(fn, device) -> dict:
    """``fn()``'s result with its peak GiB, or ``{"fits": False, ...}``."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    try:
        out = dict(fn(), fits=True)
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    except torch.cuda.OutOfMemoryError as e:
        out = {"fits": False, "error": str(e)[:160]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def anchor_case(method: str, batch: int, mode: str, steps: int, mdls: dict,
                models: list, device) -> dict:
    from i2v_tpu_torch.cli import common
    from i2v_tpu_torch.ops import kernels, pixel

    adaptive = method == "aens"
    precision = common.apply_matmul_precision(argparse.Namespace(matmul_precision=(
        "float32" if mode == "float32" else "default")))
    gen = torch.Generator(device=device).manual_seed(SEED)
    clip01 = 0.1 + 0.8 * torch.rand(batch, 3, 32, 224, 224, generator=gen, device=device)
    frames01 = pixel.flatten_clip_to_frames(clip01)
    timer = time_torch_aens if adaptive else time_torch_ens
    ref = _measure(lambda: timer(mdls, frames01, steps), device)
    del frames01
    kernels.reset_launches()
    port = _measure(lambda: time_port(models, clip01, steps, adaptive), device)
    port["launches"] = dict(kernels.launches)
    flops = counted_flops(batch, 224, adaptive)
    ref["flops_per_step"], port["flops_per_step"] = flops["reference"], flops["port"]
    row = {"method": method, "batch": batch, "frames": batch * 32, "mode": precision,
           "steps": steps, "reference": ref, "port": port,
           "reference_over_port_flops": flops["reference"] / flops["port"]}
    if ref["fits"] and port["fits"]:
        rel = abs(port["cost0"] - ref["cost0"]) / abs(ref["cost0"])
        row["cost0_rel_diff"] = rel
        if mode == "float32" and rel > COST_RTOL:
            raise RuntimeError(f"[anchor:{method} B={batch}] step-0 costs part: reference "
                               f"{ref['cost0']!r}, port {port['cost0']!r}, relative {rel:.3g} "
                               f"(limit {COST_RTOL})")
        row["gate"] = (f"step-0 costs within {COST_RTOL} relative" if mode == "float32"
                       else "printed, not gated (TF32 convolutions)")
        row["port_over_reference_steps_per_s"] = port["steps_per_s"] / ref["steps_per_s"]
    else:
        row["gate"] = "not run: a side does not fit"

    def side(s):
        if not s["fits"]:
            return "does not fit"
        return f"{s['steps_per_s']:.4f} steps/s, {s['peak_gib']:.2f} GiB, " \
               f"{s['flops_per_step'] / 1e12:.3f} TFLOP a step"

    print(f"[anchor:{method} B={batch} {mode}] reference {side(ref)}; port {side(port)}; "
          f"step-0 relative {row.get('cost0_rel_diff', float('nan')):.3g} ({row['gate']}); "
          f"port/reference {row.get('port_over_reference_steps_per_s', float('nan')):.4f}; "
          f"launches {port['launches']}", flush=True)
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", default="1,16")
    p.add_argument("--modes", default="float32,default")
    p.add_argument("--methods", default="ens,aens")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=ARTIFACT)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: the anchor measures a CUDA card, and none "
                         "is available")
    card = probe.card_info()
    print(card["nvidia_smi"], flush=True)
    from i2v_tpu_torch.ops import kernels

    cpu_models = torch_models("cpu")
    with tempfile.TemporaryDirectory() as ckpts:
        convert_weights(cpu_models, ckpts)
        ports = {m: port_models(AENS_DEPTHS if m == "aens" else ENS_DEPTHS, device, ckpts)
                 for m in args.methods.split(",")}
    mdls = {k: m.to(device) for k, m in cpu_models.items()}
    total = dict.fromkeys(kernels.launches, 0)
    cases = {}
    for method in args.methods.split(","):
        for batch in (int(b) for b in args.batches.split(",")):
            for mode in args.modes.split(","):
                row = anchor_case(method, batch, mode, args.steps, mdls, ports[method], device)
                cases[f"{method}_b{batch}_{mode}"] = row
                for k, v in row["port"]["launches"].items():
                    total[k] += v
    out = {"card": card, "torch": torch.__version__,
           "config": {"frames_a_clip": 32, "hw": 224, "steps": args.steps,
                      "surrogates": ENS_DEPTHS, "aens_taps": AENS_DEPTHS,
                      "weights": f"tools/torch_surrogates.py, torch.manual_seed({SEED}), "
                                 "through convert_torchvision"},
           "cases": cases}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[anchor] wrote {args.out}", flush=True)
    print(f"[anchor] launches {json.dumps(total)}", flush=True)


if __name__ == "__main__":
    main()
