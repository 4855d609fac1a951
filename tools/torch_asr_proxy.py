"""ASR-proxy gate of the port's approximation levers, on a CUDA card.

    python tools/torch_asr_proxy.py [--clips 192] [--steps 60] [--eps255 48]
                                    [--retain 0.5] [--device cuda]

The PyTorch counterpart of ``tools/asr_proxy.py``, with the same protocol
and statistics, written against ``i2v_tpu_torch`` alone (torch and numpy; no
JAX). The reference's product metric is attack success rate on held-out
video models (reference.py:105-129), so each lever is gated on the fooling
rate it keeps, end to end at tiny scale:

    f32             float32 compute, unchunked (the baseline)
    f32_chunk       float32, frame-chunked gradient accumulation (exact by
                    construction: it must flip the same pairs as f32 up to
                    last-ulp prediction changes)
    f32_ulp         float32 with the modifier's start nudged by 2**-20
                    relative: the pipeline's own numerics noise, the
                    yardstick for reading the levers' flip overlap
    bf16            bfloat16 compute and bfloat16 weight storage
    multigrid       bf16 + coarse-to-fine (half the steps at half size)
    multigrid_cs12  bf16 + coarse-to-fine with steps/5 coarse steps
    f16_egress      the f32 adversarial clips rounded through float16 in
                    the normalized artifact domain (``--artifact_dtype
                    float16``); no re-optimization
    noise           ±ε sign noise, the floor an attack must clearly beat

Setup, as in the JAX tool: one 10-class synthetic task (class-conditioned
low-frequency patterns mixed into smooth clips); six tiny video victims
(I3D, SlowFast, TPN × seeds 0 and 1) and the four tiny ENS surrogates
(ResNet depth 2, VGG 3, SqueezeNet 2, AlexNet 3) trained on it with
``torch.optim.Adam`` (lr 3e-3, 300 steps, 240 clips, strength 0.5; the
surrogates frame-wise through a temporary linear probe on their deepest
tap); then 192 held-out clips of 8 frames at 32² attacked for 60 steps at
ε = 48/255. The fooling rate is the share of (clip, victim) pairs whose
prediction moves off the clean clip's. A lever passes when it keeps at
least ``--retain`` of f32's fooling-over-noise efficacy (the margin form,
with a 2000-resample clip bootstrap); a self-test shows that the gate fails
for noise taken as a lever and for an attack that does nothing.

The tiny AlexNet's depth-3 tap is empty at the multigrid levers' coarse
16² size: the JAX package computes a 0×0 tap there, whose cosine is the
constant 0 and whose gradient is nothing, while torch refuses the pool. So
a surrogate whose taps do not exist at the coarse size sits out the coarse
phase, which is what its constant term amounts to in JAX; the output names
it. Training is not cached (the JAX tool's CPU run cached an hour of it; on
a card it takes seconds). The output, ``ASR_PROXY_TORCH.json`` at the repo
root, names the device it ran on and its power limit.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from i2v_tpu_torch.models import ImageModel, get_image_models, get_video_model  # noqa: E402
from i2v_tpu_torch.models.common import set_compute_dtype  # noqa: E402
from i2v_tpu_torch.ops import pixel  # noqa: E402
from i2v_tpu_torch.parallel import multigrid as mg  # noqa: E402
from i2v_tpu_torch.parallel import sharded  # noqa: E402

ENS_NAMES = ["resnet", "vgg", "squeezenet", "alexnet"]
ENS_DEPTHS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
VICTIM_FAMILIES = ["i3d_resnet50", "slowfast_resnet50", "tpn_resnet50"]
N_CLASSES = 10          # the tiny video models' head width
STEP_SIZE = 0.005
ARTIFACT = os.path.join(REPO, "ASR_PROXY_TORCH.json")


# -- the synthetic task (numpy, from seeds) ------------------------------------------

def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "cubic")``
    along one axis: Keys' cubic (a = −0.5) at half-pixel centres, each column
    normalized by its sum, columns whose sample falls outside the input
    zeroed (``jax._src.image.scale.compute_weight_mat``; upsampling needs no
    antialias scaling)."""
    f32 = np.float32
    inv_scale = f32(1) / (f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1)
    w = np.where(x >= 1, ((f32(-0.5) * x + f32(2.5)) * x - f32(4)) * x + f32(2), w)
    w = np.where(x >= 2, f32(0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _resize_hw(base: np.ndarray, hw: int) -> np.ndarray:
    """Cubic resize of the last two axes of ``base`` to ``hw``×``hw``."""
    wh = _cubic_weights(base.shape[-2], hw)
    ww = _cubic_weights(base.shape[-1], hw)
    return np.einsum("...ij,ia,jb->...ab", base, wh, ww).astype(np.float32)


def smooth_clips(n: int, t: int = 8, hw: int = 32, seed: int = 0) -> np.ndarray:
    """[0,1] clips (n, 3, t, hw, hw) with low-frequency spatial structure
    plus a little white noise (the JAX tool's ``smooth_clips``)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n, 3, t, 4, 4).astype(np.float32)
    clips = _resize_hw(base, hw)
    clips = clips + 0.08 * rng.rand(n, 3, t, hw, hw).astype(np.float32)
    return np.clip(clips, 0.0, 1.0)


def class_patterns(k: int = N_CLASSES, t: int = 8, hw: int = 32, seed: int = 3) -> np.ndarray:
    """K fixed low-frequency class templates, one per synthetic class."""
    rng = np.random.RandomState(seed)
    return _resize_hw(rng.rand(k, 3, t, 4, 4).astype(np.float32), hw)


def labeled_clips(n: int, t: int = 8, hw: int = 32, *, seed: int = 0, patterns=None,
                  strength: float = 0.5):
    """Balanced labelled clips: (1 − s)·smooth noise + s·pattern[label],
    clipped to [0,1]. → (clips, labels), numpy."""
    if patterns is None:
        patterns = class_patterns(t=t, hw=hw)
    k = patterns.shape[0]
    labels = np.arange(n) % k
    rng = np.random.RandomState(seed)
    rng.shuffle(labels)
    noise = smooth_clips(n, t, hw, seed=seed + 1)
    clips = (1.0 - strength) * noise + strength * patterns[labels]
    return np.clip(clips, 0.0, 1.0).astype(np.float32), labels


# -- training ----------------------------------------------------------------------------

def _train(logits_fn, params, xs: torch.Tensor, ys: torch.Tensor, *, steps: int, batch: int,
           lr: float = 3e-3, seed: int = 0) -> float:
    """A plain cross-entropy loop with ``torch.optim.Adam`` over ``params``;
    the batches are the JAX tool's draws. Returns the last loss."""
    opt = torch.optim.Adam(params, lr=lr)
    n = int(xs.shape[0])
    batch = min(batch, n)
    rng = np.random.RandomState(seed)
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        idx = torch.from_numpy(rng.choice(n, batch, replace=False)).to(xs.device)
        loss = F.cross_entropy(logits_fn(xs[idx]), ys[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return float(loss.detach())


def train_victims(victims: dict, clips01: torch.Tensor, labels: torch.Tensor, *, steps: int,
                  batch: int = 24) -> None:
    """Train each tiny video victim in place on [0,1] clips, through its own
    normalization (the path ``victim_preds`` scores)."""
    for i, (name, bundle) in enumerate(sorted(victims.items())):
        module = bundle.module.requires_grad_(True)
        loss = _train(lambda x, m=module: m(x)[0], list(module.parameters()), clips01, labels,
                      steps=steps, batch=batch, seed=100 + i)
        module.requires_grad_(False)
        print(f"  [train:{name}] final CE {loss:.3f}", flush=True)


def train_surrogates(surrogates: list, clips01: torch.Tensor, labels: torch.Tensor, *,
                     steps: int, batch: int = 96) -> None:
    """Train the tiny surrogates in place, frame-wise (each frame takes its
    clip's label), through a temporary linear probe on the spatial mean of
    the deepest tap; the probe is dropped afterwards."""
    frames = pixel.flatten_clip_to_frames(clips01)
    frame_labels = labels.repeat_interleave(clips01.shape[2])
    for i, bundle in enumerate(surrogates):
        module = bundle.module.requires_grad_(True)
        key = bundle.tap_keys[-1]
        with torch.no_grad():
            ch = module(frames[:1])[1][key].shape[1]
        gen = torch.Generator().manual_seed(500 + i)
        w = (0.05 * torch.randn(ch, N_CLASSES, generator=gen)).to(frames.device)
        b = torch.zeros(N_CLASSES, device=frames.device)
        w.requires_grad_(True)
        b.requires_grad_(True)

        def logits(x, m=module, k=key, w=w, b=b):
            return torch.mean(m(x)[1][k], dim=(2, 3)) @ w + b

        loss = _train(logits, list(module.parameters()) + [w, b], frames, frame_labels,
                      steps=steps, batch=batch, seed=200 + i)
        module.requires_grad_(False)
        print(f"  [train:{bundle.name}] final CE {loss:.3f}", flush=True)


# -- victims and levers ------------------------------------------------------------------

def build_victims(device) -> dict:
    return {f"{fam}_tiny_s{seed}": get_video_model(fam, device=device, tiny=True, seed=seed)
            for fam in VICTIM_FAMILIES for seed in (0, 1)}


def victim_preds(victims: dict, clips01: torch.Tensor) -> dict:
    """Argmax predictions of each victim on [0,1] clips, normalized on the
    way in as the evaluation path takes them; numpy."""
    clips_n = pixel.normalize(clips01, channel_axis=1)
    with torch.no_grad():
        return {name: torch.argmax(b.apply_norm(clips_n), dim=-1).cpu().numpy()
                for name, b in victims.items()}


def clean_accuracy(victims: dict, clips01: torch.Tensor, labels: np.ndarray) -> dict:
    preds = victim_preds(victims, clips01)
    acc = {name: round(float(np.mean(preds[name] == labels)), 4) for name in victims}
    acc["mean"] = round(float(np.mean(list(acc.values()))), 4)
    return acc


def with_dtype(surrogates: list, dtype: torch.dtype) -> list:
    """Copies of the trained surrogates that compute in ``dtype``."""
    return [dataclasses.replace(b, module=set_compute_dtype(copy.deepcopy(b.module), dtype))
            for b in surrogates]


def _runs_at(bundle: ImageModel, hw: int) -> bool:
    """Whether every tap of ``bundle`` exists at ``hw``×``hw``: a pool with
    no output window raises a shape error in torch."""
    x = torch.zeros(1, 3, hw, hw, device=bundle.device)
    try:
        with torch.no_grad():
            bundle.apply01_taps(x)
    except RuntimeError:
        return False
    return True


def multigrid_runner(surrogates: list, *, steps: int, coarse_steps: int, hw: int, eps: float,
                     param_dtype):
    """The coarse-to-fine schedule of ``parallel.multigrid`` at scale 2,
    with the surrogates that have no taps at the coarse size left out of the
    coarse phase (their JAX term is a constant there). → (runner, names of
    the surrogates that sat out)."""
    if param_dtype is not None:
        surrogates = sharded.cast_param_storage(surrogates, param_dtype)
    runs = [_runs_at(b, hw // 2) for b in surrogates]
    coarse_models = [b for b, r in zip(surrogates, runs) if r]
    sat_out = [b.name for b, r in zip(surrogates, runs) if not r]
    coarse = sharded.make_sharded_i2v_runner(coarse_models, steps=coarse_steps,
                                             step_size=STEP_SIZE, epsilon=eps,
                                             return_modifier=True)
    fine = sharded.make_sharded_i2v_runner(surrogates, steps=steps - coarse_steps,
                                           step_size=STEP_SIZE, epsilon=eps)

    def runner(clean01):
        _, costs_c, mod_c = coarse(mg.downsample_clips(clean01, 2))
        adv, costs_f = fine(clean01, mod_init=mg.upsample_modifier(mod_c, 2))
        return adv, torch.cat([costs_c, costs_f])

    return runner, sat_out


def run_config(tag: str, surrogates: list, clips01: torch.Tensor, *, steps: int, eps: float,
               frame_chunk=None, param_dtype=None, multigrid: int = 0,
               mod_nudge: float = 0.0) -> tuple[torch.Tensor, float, list]:
    """One lever's attack over all clips → (adv01, final cost, surrogates
    that sat out a coarse phase). Raises if an output leaves the ε-ball or
    [0,1]."""
    t0 = time.time()
    sat_out: list = []
    if multigrid:
        runner, sat_out = multigrid_runner(surrogates, steps=steps, coarse_steps=multigrid,
                                           hw=clips01.shape[-1], eps=eps,
                                           param_dtype=param_dtype)
        adv01, costs = runner(clips01)
    else:
        runner = sharded.make_sharded_i2v_runner(surrogates, steps=steps, step_size=STEP_SIZE,
                                                 epsilon=eps, frame_chunk=frame_chunk,
                                                 param_dtype=param_dtype)
        kw = {}
        if mod_nudge:
            b, _, t, h, w = clips01.shape
            kw["mod_init"] = torch.full((b * t, 3, h, w), sharded.MODIFIER_INIT * (1 + mod_nudge),
                                        device=clips01.device)
        adv01, costs = runner(clips01, **kw)
    if clips01.device.type == "cuda":
        torch.cuda.synchronize()
    costs = costs.cpu().numpy()
    print(f"[{tag}] {time.time() - t0:.1f}s  cost[0]={costs[0]:.3f} cost[-1]={costs[-1]:.3f}"
          + (f"  (coarse phase without {sat_out})" if sat_out else ""), flush=True)
    if not (bool(((adv01 >= -1e-6) & (adv01 <= 1 + 1e-6)).all())
            and float((adv01 - clips01).abs().max()) <= eps + 1e-5):
        raise RuntimeError(f"[{tag}] an adversarial clip left the ε-ball or [0,1]")
    return adv01, float(costs[-1]), sat_out


# -- statistics (numpy; the JAX tool's, term for term) --------------------------------

def fooling_rates(victims, clean_preds: dict, adv_preds: dict) -> dict:
    per_victim = {name: round(float(np.mean(adv_preds[name] != clean_preds[name])), 4)
                  for name in victims}
    per_victim["mean"] = round(float(np.mean(
        [v for k, v in per_victim.items() if k != "mean"])), 4)
    return per_victim


def pred_agreement(a: dict, b: dict) -> float:
    """Share of (clip, victim) pairs where two adversarial sets give the
    same prediction."""
    return round(float(np.mean([np.mean(a[name] == b[name]) for name in a])), 4)


def flip_overlap(clean: dict, ref: dict, lever: dict) -> dict:
    """Overlap of the flip sets of two adversarial sets: the Jaccard index
    of the flipped pairs, the share of the reference's flips the lever
    also makes, and of the pairs both flip, the share sent to the same
    class."""
    inter = union = same = ref_flips = 0
    for name in clean:
        f = np.asarray(ref[name]) != np.asarray(clean[name])
        g = np.asarray(lever[name]) != np.asarray(clean[name])
        inter += int(np.sum(f & g))
        union += int(np.sum(f | g))
        ref_flips += int(np.sum(f))
        same += int(np.sum(f & g & (np.asarray(ref[name]) == np.asarray(lever[name]))))
    return {
        "flip_jaccard": round(inter / union, 4) if union else 1.0,
        "lever_hits_ref_flips": round(inter / ref_flips, 4) if ref_flips else 1.0,
        "same_adv_class_given_both_flip": round(same / inter, 4) if inter else 1.0,
    }


def flip_matrix(clean_preds: dict, adv_preds: dict) -> np.ndarray:
    """(victims, clips) boolean matrix: did the pair flip."""
    names = sorted(clean_preds)
    return np.stack([np.asarray(adv_preds[n]) != np.asarray(clean_preds[n]) for n in names])


def bootstrap_ci(stat_fn, n_clips: int, *, n_boot: int = 2000, seed: int = 13) -> list:
    """95% percentile bootstrap interval, resampling clips (the independent
    unit: every victim scores the same clips)."""
    rng = np.random.RandomState(seed)
    vals = [stat_fn(rng.randint(0, n_clips, n_clips)) for _ in range(n_boot)]
    return [round(float(np.percentile(vals, 2.5)), 4),
            round(float(np.percentile(vals, 97.5)), 4)]


def gate_lever(flips_ref: np.ndarray, flips_lever: np.ndarray, flips_noise: np.ndarray, *,
               retain: float = 0.5, n_boot: int = 2000, seed: int = 13) -> dict:
    """A lever passes iff margin = (lever − noise) − retain·(f32 − noise)
    ≥ 0, on fooling rates; the margin's interval is a clip bootstrap."""
    f_ref, f_lev, f_noi = (float(m.mean()) for m in (flips_ref, flips_lever, flips_noise))
    eff_ref, eff_lev = f_ref - f_noi, f_lev - f_noi
    margin = eff_lev - retain * eff_ref

    def _delta(idx):
        return flips_lever[:, idx].mean() - flips_ref[:, idx].mean()

    def _margin(idx):
        noi = flips_noise[:, idx].mean()
        return (flips_lever[:, idx].mean() - noi) - retain * (flips_ref[:, idx].mean() - noi)

    n = flips_ref.shape[1]
    margin_ci = bootstrap_ci(_margin, n, n_boot=n_boot, seed=seed)
    return {
        "fooling_rate": round(f_lev, 4),
        "delta_vs_f32": round(f_lev - f_ref, 4),
        "delta_ci95": bootstrap_ci(_delta, n, n_boot=n_boot, seed=seed),
        "efficacy_over_noise": round(eff_lev, 4),
        "retention_of_f32_efficacy": round(eff_lev / eff_ref, 4) if eff_ref > 0 else None,
        "retain_threshold": retain,
        "margin": round(margin, 4),
        "margin_ci95": margin_ci,
        "passes": bool(margin >= 0),
        "passes_significant": bool(margin_ci[0] > 0),
        "fails_significant": bool(margin_ci[1] < 0),
    }


def self_test(flips_ref: np.ndarray, flips_noise: np.ndarray, *, retain: float,
              n_boot: int) -> dict:
    """The two levers the gate must fail: ±ε noise taken as a lever, and an
    attack that flips nothing."""
    return {
        "noise_as_lever": gate_lever(flips_ref, flips_noise, flips_noise, retain=retain,
                                     n_boot=n_boot),
        "identity_as_lever": gate_lever(flips_ref, np.zeros_like(flips_ref), flips_noise,
                                        retain=retain, n_boot=n_boot),
    }


# -- the run -------------------------------------------------------------------------------

def _card(device: torch.device) -> dict:
    """The device the numbers were taken on, with the card's power limit."""
    if device.type != "cuda":
        return {"device": "cpu"}
    out = {"device": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        out["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["nvidia_smi"] = f"not read: {e}"
    return out


def arg_parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=192)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--eps255", type=float, default=48.0,
                    help="the proxy's ε numerator (ε = eps255/255), the JAX tool's "
                         "ASR_PROXY.json operating point; the gate compares levers at "
                         "one ε")
    ap.add_argument("--retain", type=float, default=0.5,
                    help="a lever passes iff it keeps at least this share of f32's "
                         "fooling-over-noise efficacy")
    ap.add_argument("--boot", type=int, default=2000,
                    help="bootstrap resamples for the clip-level intervals")
    ap.add_argument("--train_steps", type=int, default=300)
    ap.add_argument("--train_clips", type=int, default=240)
    ap.add_argument("--strength", type=float, default=0.5,
                    help="class-pattern mixing strength of the labelled clips")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); a CUDA device without a "
                         "card stops the run")
    ap.add_argument("--out", default=ARTIFACT)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = arg_parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    # float32 levers in float32 (TF32 off) and bfloat16 GEMMs reduced in
    # float32, as the JAX tool's float32 matmul precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    eps = args.eps255 / 255.0
    t_start = time.time()

    import warnings

    warnings.filterwarnings("ignore", message="no pretrained")  # tiny models: random init

    patterns = class_patterns(t=args.frames, hw=args.hw)
    train_x, train_y = labeled_clips(args.train_clips, args.frames, args.hw, seed=11,
                                     patterns=patterns, strength=args.strength)
    clips_np, attack_labels = labeled_clips(args.clips, args.frames, args.hw, seed=0,
                                            patterns=patterns, strength=args.strength)
    train_x = torch.from_numpy(train_x).to(device)
    train_y_t = torch.from_numpy(train_y).to(device)
    clips01 = torch.from_numpy(clips_np).to(device)

    victims = build_victims(device)
    surrogates = get_image_models(ENS_NAMES, ENS_DEPTHS, device=device, tiny=True,
                                  input_hw=args.hw)
    t0 = time.time()
    print(f"[train] victims and surrogates: {args.train_steps} steps on "
          f"{args.train_clips} clips", flush=True)
    train_victims(victims, train_x, train_y_t, steps=args.train_steps)
    train_surrogates(surrogates, train_x, train_y_t, steps=args.train_steps)
    train_s = time.time() - t0
    train_acc = clean_accuracy(victims, train_x, train_y)
    attack_acc = clean_accuracy(victims, clips01, attack_labels)
    print(f"[train] {train_s:.1f}s; victim clean acc: train {train_acc['mean']}, attack set "
          f"{attack_acc['mean']} (chance {1 / N_CLASSES})", flush=True)
    clean_preds = victim_preds(victims, clips01)

    bf16 = torch.bfloat16
    configs = {
        "f32": dict(),
        "f32_chunk": dict(frame_chunk=max(1, args.frames // 2)),
        "f32_ulp": dict(mod_nudge=2.0 ** -20),
        "bf16": dict(param_dtype=bf16),
        "multigrid": dict(param_dtype=bf16, multigrid=args.steps // 2),
        "multigrid_cs12": dict(param_dtype=bf16, multigrid=max(1, args.steps // 5)),
    }
    by_dtype = {torch.float32: surrogates, bf16: with_dtype(surrogates, bf16)}
    results, adv_preds, sat_out = {}, {}, {}
    adv_f32 = None
    for tag, kw in configs.items():
        dtype = torch.float32 if tag.startswith("f32") else bf16
        adv01, final_cost, out = run_config(tag, by_dtype[dtype], clips01, steps=args.steps,
                                            eps=eps, **kw)
        if out:
            sat_out[tag] = out
        if tag == "f32":
            adv_f32 = adv01
        adv_preds[tag] = victim_preds(victims, adv01)
        results[tag] = {"fooling_rate": fooling_rates(victims, clean_preds, adv_preds[tag]),
                        "final_cost": round(final_cost, 3)}
        print(f"[{tag}] fooling mean={results[tag]['fooling_rate']['mean']}", flush=True)

    # the f32 set rounded through float16 in the normalized artifact domain
    norm16 = pixel.normalize(adv_f32, channel_axis=1).half().float()
    adv16 = pixel.unnormalize(norm16, channel_axis=1)
    adv_preds["f16_egress"] = victim_preds(victims, adv16)
    results["f16_egress"] = {"fooling_rate": fooling_rates(victims, clean_preds,
                                                           adv_preds["f16_egress"])}
    # ±ε sign noise, the JAX tool's draws
    rng = np.random.RandomState(7)
    noise = eps * np.sign(rng.randn(*clips_np.shape)).astype(np.float32)
    noisy = torch.clamp(clips01 + torch.from_numpy(noise).to(device), 0.0, 1.0)
    adv_preds["noise_control"] = victim_preds(victims, noisy)
    results["noise_control"] = {"fooling_rate": fooling_rates(victims, clean_preds,
                                                              adv_preds["noise_control"])}
    for tag in ("f16_egress", "noise_control"):
        print(f"[{tag}] fooling mean={results[tag]['fooling_rate']['mean']}", flush=True)

    flips = {tag: flip_matrix(clean_preds, preds) for tag, preds in adv_preds.items()}
    gates = {}
    for lever in [t for t in configs if t != "f32"] + ["f16_egress"]:
        gates[lever] = gate_lever(flips["f32"], flips[lever], flips["noise_control"],
                                  retain=args.retain, n_boot=args.boot)
        if lever != "f16_egress":
            gates[lever]["pred_agreement_vs_f32"] = pred_agreement(adv_preds[lever],
                                                                   adv_preds["f32"])
        gates[lever]["flip_overlap_vs_f32"] = flip_overlap(clean_preds, adv_preds["f32"],
                                                           adv_preds[lever])
    st = self_test(flips["f32"], flips["noise_control"], retain=args.retain, n_boot=args.boot)
    f32_rate = float(flips["f32"].mean())
    noise_rate = float(flips["noise_control"].mean())

    def _eff_f32(idx):
        return flips["f32"][:, idx].mean() - flips["noise_control"][:, idx].mean()

    eff_ci = bootstrap_ci(_eff_f32, flips["f32"].shape[1], n_boot=args.boot)
    gates["gate_meta"] = {
        "criterion": (f"lever passes iff (lever − noise) ≥ {args.retain} · (f32 − noise); "
                      f"margin CI from {args.boot} clip bootstraps"),
        "n_clips": int(flips["f32"].shape[1]),
        "n_pairs": int(flips["f32"].size),
        "f32_fooling": round(f32_rate, 4),
        "noise_fooling": round(noise_rate, 4),
        "f32_efficacy_over_noise": round(f32_rate - noise_rate, 4),
        "f32_efficacy_ci95": eff_ci,
        "gate_powered": bool(eff_ci[0] > 0),
        "gate_can_fail": bool(not st["noise_as_lever"]["passes"]
                              and not st["identity_as_lever"]["passes"]),
        "self_test": st,
        "noise_pred_agreement_vs_f32": pred_agreement(adv_preds["noise_control"],
                                                      adv_preds["f32"]),
        "noise_flip_overlap_vs_f32": flip_overlap(clean_preds, adv_preds["f32"],
                                                  adv_preds["noise_control"]),
    }
    out = {
        "tool": "tools/torch_asr_proxy.py",
        "device": _card(device),
        "protocol": {
            "clips": args.clips, "steps": args.steps, "frames": args.frames, "hw": args.hw,
            "epsilon": f"{args.eps255:g}/255", "production_epsilon": "16/255",
            "retain_threshold": args.retain, "bootstrap_resamples": args.boot,
            "surrogates": ENS_DEPTHS, "victims": sorted(victims),
            "metric": "fooling rate: share of (clip, victim) pairs whose argmax prediction "
                      "moves off the clean clip's (reference.py:105-129 ASR analogue)",
            "training": {"optimizer": "torch.optim.Adam, lr 3e-3",
                         "train_steps": args.train_steps, "train_clips": args.train_clips,
                         "n_classes": N_CLASSES, "strength": args.strength,
                         "victim_clean_acc_train": train_acc,
                         "victim_clean_acc_attack_set": attack_acc,
                         "chance": 1 / N_CLASSES, "seconds": round(train_s, 2)},
            "coarse_phase_sat_out": sat_out,
        },
        "results": results,
        "gates": gates,
        "seconds": round(time.time() - t_start, 2),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: {"retention": v["retention_of_f32_efficacy"], "passes": v["passes"]}
                      for k, v in gates.items() if k != "gate_meta"}))
    print(f"gate_can_fail={gates['gate_meta']['gate_can_fail']} "
          f"gate_powered={gates['gate_meta']['gate_powered']} → {args.out}")
    return out


if __name__ == "__main__":
    main()
