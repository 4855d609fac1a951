"""Roofline and memory audit of the port's attack steps on one CUDA card.

PyTorch counterpart of ``tools/perf_probe.py``'s ``record``, ``cost`` and
``hbm`` modes. Results are merged into ``PERF_PROBE_TORCH.json`` at the repo
root (``--out`` to write elsewhere), one row a key, each stamped with the
card's name and power limit, the torch version and the precision mode.

    python tools/torch_perf_probe.py cost <case>|all [--out PATH]
    python tools/torch_perf_probe.py hbm <case>|all [--calls N] [--out PATH]

``cost`` covers the shipped B=16 x 32 x 224² programs of the frame-chunked
runner (``parallel/sharded.py``):

    ens16_f32_chunk256       ENS-I2V, float32, 256-frame chunks, TF32 off
    ens16_f32_chunk256_tf32  the same with TF32 convolutions
    ens16_bf16               ENS-I2V, bf16 surrogates and weight storage, whole
    aens16_bf16              AENS-I2V-MF (taps [2, 3]), bf16, whole
    aens16_f32_chunk256      AENS-I2V-MF, float32, 256-frame chunks, TF32 off
    mg16_bf16                multigrid ENS-I2V, bf16, 256-frame chunks: the
                             mean of a 112² step and a 224² step (30 + 30)

For each, the FLOPs and bytes of one Adam step are counted on the meta
device, where the runner runs without data (``count_step``): the FLOPs of
every aten op that ``torch.utils.flop_counter`` knows (the surrogates'
convolutions forward and their input gradients; the weights are frozen, so
there is no weight gradient), and the bytes of every aten op's tensor inputs
and outputs, views and allocations skipped: the eager program's traffic.
cuDNN's workspace is not counted. The runner's one-off clean-tap forward is
left out of the step (a 0-step call counted alone) and reported on its own.
The port's chunk loop is Python, so a count over the whole step needs no
two-chunk fit, unlike the JAX tool's scan body. The FLOPs are also computed
from the surrogates' conv layers (``analytic_conv_flops``), and the two must
agree. Then the same program runs on the card at ``TIMED_STEPS`` steps: a
cold call and a warm one, timed on the host's clock and ended by
``torch.cuda.synchronize``. The row gets ``steps_per_s``, ``mfu`` (counted
FLOPs x steps/s over the mode's data-sheet peak) and ``hbm_share`` (bytes x
steps/s over the card's memory rate).

``hbm`` runs one cold and one warm step (``--calls``) of each of the JAX
audit's configurations on the card and records
``torch.cuda.max_memory_allocated`` against the card's memory:

    aens16_f32            AENS-I2V-MF, float32, --frame_chunk auto
    aens16_bf16           AENS-I2V-MF, bf16, whole
    mi16, mi16_remat      MIFGSM at B=16 on I3D-R101, without and with remat
    ens16_f32             ENS-I2V, float32, whole
    ens16_f32_chunk256    ENS-I2V, float32, 256-frame chunks
    ens24_bf16_chunk256   ENS-I2V at B=24, bf16, 256-frame chunks
    ens32_bf16_chunk256   ENS-I2V at B=32, bf16, 256-frame chunks

A case that does not fit is recorded as ``{"fits": false, "error": ...}``,
not raised and not retried smaller.

The JAX tool's other modes have counterparts among the port's tools and are
not ported twice: ``base`` (the timed 60-step ENS run) and ``exec`` (a case
executed) are ``tools/torch_eval_profile.py --attacks [--dtype bfloat16]``
and ``--frame_chunk``; ``remat`` is ``torch_eval_profile.py --whitebox`` and
the runner's ``remat=True``; the multi-card rows are
``tools/torch_mesh_profile.py``; ``fidelity`` is ``tools/torch_asr_proxy.py``
with ``chip_smoke.py``'s bf16 limits.

It runs on ``--device cuda`` and exits without a card. Each case prints one
line; the process's launches of the hand-written kernels are printed last.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from statistics import fmean

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from i2v_tpu_torch.models.api import ImageModel  # noqa: E402
from i2v_tpu_torch.models.registry import build_image_model  # noqa: E402

ARTIFACT = os.path.join(ROOT, "PERF_PROBE_TORCH.json")
ENS_NAMES = ("resnet", "vgg", "squeezenet", "alexnet")
ENS_DEPTHS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
AENS_DEPTHS = {n: [2, 3] for n in ENS_NAMES}  # the TPAMI 8-tap configuration
FRAMES, HW = 32, 224
STEP_SIZE = 0.005
TIMED_STEPS = 3
MG_TIMED = (4, 2)          # multigrid's timed call: 4 steps, 2 of them coarse

# Data-sheet peaks, dense (no sparsity), by the name torch gives the card.
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 80GB, at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float32": 67e12, "tf32": 494.7e12, "bfloat16": 989.4e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM5 80GB data sheet: dense FP32 67, TF32 494.7, "
                  "BF16 989.4 TFLOP/s; HBM3 3.35 TB/s; at 700 W",
    },
}


def peaks_for(card_name: str) -> dict:
    """The data-sheet peaks of ``card_name``; an unknown card raises."""
    if card_name not in PEAKS:
        raise ValueError(f"no data-sheet peaks for {card_name!r}; known: {sorted(PEAKS)}")
    return PEAKS[card_name]


def card_info() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` gives them, or
    ``{"device": "cpu"}`` on a host without a card."""
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "power_limit": smi.split(",")[-1].strip()}


def precision_mode() -> str:
    """The float32 precision in force: TF32 convs (torch's default) or not."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    return f"cudnn.allow_tf32={conv}, cuda.matmul.allow_tf32={matmul}"


def record(key: str, payload: dict, path: str = ARTIFACT) -> None:
    """Merge ``payload`` as row ``key`` into the JSON file at ``path``,
    stamped with the card, the torch version and the precision mode."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    payload = dict(payload, card=card_info(), torch=torch.__version__)
    payload.setdefault("precision", precision_mode())
    data[key] = payload
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    print(f"[{key}] recorded -> {path}", flush=True)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """FLOPs and bytes of every aten op dispatched under it: the FLOPs of the
    ops ``torch.utils.flop_counter`` knows (convolutions and matmuls), and
    the bytes of each op's distinct tensor inputs plus its outputs. Views
    and uninitialized allocations move no data and count none."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(packet)] = self.flops_by_op.get(str(packet), 0) + n
        if not _is_view(func) and not str(packet).startswith("aten.empty"):
            for group in (tree_flatten((args, kwargs))[0], tree_flatten(out)[0]):
                tensors = {id(t): t for t in group if isinstance(t, torch.Tensor)}
                self.bytes += sum(t.numel() * t.element_size() for t in tensors.values())
        return out


def meta_models(names, depths, dtype=torch.float32, tiny: bool = False) -> list[ImageModel]:
    """The surrogates built on the meta device: shapes only, no weights."""
    out = []
    with torch.device("meta"):
        for name in names:
            d = depths if isinstance(depths, int) else depths[name]
            module, taps = build_image_model(name, d, tiny=tiny, dtype=dtype)
            out.append(ImageModel(name, module.eval().requires_grad_(False), taps))
    return out


def count_step(models, batch: int, hw: int = HW, frames: int = FRAMES, *,
               frame_chunk="auto", adaptive: bool = False, param_dtype=None) -> dict:
    """FLOPs and bytes of one Adam step of the runner over ``models`` (meta
    models: nothing is computed), and of its one-off clean-tap forward:
    a 1-step call counted, less a 0-step call."""
    from i2v_tpu_torch.parallel.sharded import make_sharded_i2v_runner

    counts = []
    for steps in (0, 1):
        runner = make_sharded_i2v_runner(models, steps=steps, step_size=STEP_SIZE,
                                         adaptive=adaptive, frame_chunk=frame_chunk,
                                         param_dtype=param_dtype)
        clip = torch.empty(batch, 3, frames, hw, hw, device="meta")
        with OpCounter() as c:
            runner(clip)
        counts.append(c)
    setup, one = counts
    return {"flops_per_step": one.flops - setup.flops,
            "bytes_per_step": one.bytes - setup.bytes,
            "clean_tap_flops": setup.flops, "clean_tap_bytes": setup.bytes,
            "flops_by_op": {k: v - setup.flops_by_op.get(k, 0)
                            for k, v in one.flops_by_op.items()}}


def analytic_conv_flops(models, n_frames: int, hw: int = HW) -> int:
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

        handles = [mod.register_forward_hook(hook) for mod in m.module.modules()
                   if isinstance(mod, torch.nn.Conv2d)]
        try:
            x = torch.empty(n_frames, 3, hw, hw, device="meta", requires_grad=True)
            _, taps = m.apply01_taps(x)
            torch.autograd.grad(sum(t.sum() for t in taps), x)
        finally:
            for h in handles:
                h.remove()
        for mod, out_shape, reached in convs:
            k_h, k_w = mod.kernel_size
            fwd = 2 * out_shape[0] * out_shape[1] * out_shape[2] * out_shape[3] \
                * (mod.in_channels // mod.groups) * k_h * k_w
            total += fwd * (2 if reached else 1)
    return total


# ---------------------------------------------------------------------------
# the programs on the card
# ---------------------------------------------------------------------------

COST_CASES = {
    # name: (depths, adaptive, compute dtype, frame_chunk, precision, multigrid)
    "ens16_f32_chunk256": (ENS_DEPTHS, False, torch.float32, 256, "float32", False),
    "ens16_f32_chunk256_tf32": (ENS_DEPTHS, False, torch.float32, 256, "tf32", False),
    "ens16_bf16": (ENS_DEPTHS, False, torch.bfloat16, "auto", "bfloat16", False),
    "aens16_bf16": (AENS_DEPTHS, True, torch.bfloat16, "auto", "bfloat16", False),
    "aens16_f32_chunk256": (AENS_DEPTHS, True, torch.float32, 256, "float32", False),
    "mg16_bf16": (ENS_DEPTHS, False, torch.bfloat16, 256, "bfloat16", True),
}
COST_BATCH = 16


def _set_precision(mode: str) -> str:
    """TF32 off for ``float32``; torch's default (TF32 convs) otherwise."""
    from i2v_tpu_torch.cli import common

    prec = "float32" if mode == "float32" else "default"
    return common.apply_matmul_precision(argparse.Namespace(matmul_precision=prec))


def _clip(batch: int, device, hw: int = HW) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.rand(batch, 3, FRAMES, hw, hw, generator=gen, device=device)


def _sync_time(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def count_case(name: str) -> dict:
    """The counted FLOPs and bytes of one step of cost case ``name`` (meta)."""
    depths, adaptive, dtype, chunk, _, multigrid = COST_CASES[name]
    models = meta_models(ENS_NAMES, depths, dtype)
    param_dtype = torch.bfloat16 if dtype == torch.bfloat16 else None
    frames = COST_BATCH * FRAMES
    sizes = (HW // 2, HW) if multigrid else (HW,)
    parts = [count_step(models, COST_BATCH, hw, frame_chunk=chunk, adaptive=adaptive,
                        param_dtype=param_dtype) for hw in sizes]
    analytic = [analytic_conv_flops(models, frames, hw) for hw in sizes]
    # multigrid: equal step counts at each size, so a step is their mean
    out = {key: fmean(p[key] for p in parts) for key in
           ("flops_per_step", "bytes_per_step", "clean_tap_flops", "clean_tap_bytes")}
    return dict(out, analytic_conv_flops_per_step=fmean(analytic),
                flops_by_op=parts[-1]["flops_by_op"], sizes=list(sizes))


def cost_case(name: str, device: torch.device, out: str) -> dict:
    from i2v_tpu_torch.models import get_image_models
    from i2v_tpu_torch.ops import kernels
    from i2v_tpu_torch.parallel.multigrid import make_multigrid_i2v_runner
    from i2v_tpu_torch.parallel.sharded import make_sharded_i2v_runner

    depths, adaptive, dtype, chunk, mode, multigrid = COST_CASES[name]
    counted = count_case(name)
    if counted["flops_per_step"] != counted["analytic_conv_flops_per_step"]:
        raise RuntimeError(f"[cost:{name}] counted {counted['flops_per_step']} FLOPs a step, "
                           f"the conv layers give {counted['analytic_conv_flops_per_step']}")
    peaks = peaks_for(torch.cuda.get_device_name(device))
    precision = _set_precision(mode)
    param_dtype = torch.bfloat16 if dtype == torch.bfloat16 else None
    models = get_image_models(ENS_NAMES, depths, device=device, dtype=dtype)
    if multigrid:
        steps = MG_TIMED[0]
        runner = make_multigrid_i2v_runner(models, steps=steps, coarse_steps=MG_TIMED[1],
                                           step_size=STEP_SIZE, frame_chunk=chunk,
                                           param_dtype=param_dtype)
    else:
        steps = TIMED_STEPS
        runner = make_sharded_i2v_runner(models, steps=steps, step_size=STEP_SIZE,
                                         adaptive=adaptive, frame_chunk=chunk,
                                         param_dtype=param_dtype)
    clip = _clip(COST_BATCH, device)
    kernels.reset_launches()
    cold = _sync_time(lambda: runner(clip))
    torch.cuda.reset_peak_memory_stats(device)
    wall = _sync_time(lambda: runner(clip))
    steps_per_s = steps / wall
    peak = peaks[mode]
    row = dict(counted, case=name, batch=COST_BATCH, frames=COST_BATCH * FRAMES,
               frame_chunk=chunk, dtype=str(dtype), precision=f"{mode}: {precision}",
               bytes_note="eager aten traffic: each op's distinct tensor inputs and its "
                          "outputs, views and allocations skipped; cuDNN's workspace is "
                          "not counted",
               peak_flops_per_s=peak, hbm_bytes_per_s=peaks["hbm_bytes_per_s"],
               peak_source=peaks["source"], timed_steps=steps, cold_s=cold, wall_s=wall,
               steps_per_s=steps_per_s,
               mfu=counted["flops_per_step"] * steps_per_s / peak,
               hbm_share=counted["bytes_per_step"] * steps_per_s / peaks["hbm_bytes_per_s"],
               flop_bound_ms=counted["flops_per_step"] / peak * 1e3,
               byte_bound_ms=counted["bytes_per_step"] / peaks["hbm_bytes_per_s"] * 1e3,
               step_ms=1e3 / steps_per_s,
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               launches=dict(kernels.launches))
    print(f"[cost:{name}] {row['flops_per_step'] / 1e12:.3f} TFLOP and "
          f"{row['bytes_per_step'] / 1e9:.1f} GB a step (clean taps "
          f"{row['clean_tap_flops'] / 1e12:.3f} TFLOP once); {steps_per_s:.4f} steps/s "
          f"({mode}); mfu {row['mfu']:.4f}, hbm_share {row['hbm_share']:.4f}; peak "
          f"{row['peak_gib']:.2f} GiB; launches {row['launches']}", flush=True)
    record(f"cost_{name}", row, out)
    del runner, models, clip
    _free()
    return row


HBM_CASES = {
    # name: (kind, batch, depths, dtype, frame_chunk, remat)
    "aens16_f32": ("aens", 16, AENS_DEPTHS, torch.float32, "auto", False),
    "aens16_bf16": ("aens", 16, AENS_DEPTHS, torch.bfloat16, "auto", False),
    "mi16": ("mifgsm", 16, None, torch.float32, None, False),
    "mi16_remat": ("mifgsm", 16, None, torch.float32, None, True),
    "ens16_f32": ("ens", 16, ENS_DEPTHS, torch.float32, None, False),
    "ens16_f32_chunk256": ("ens", 16, ENS_DEPTHS, torch.float32, 256, False),
    "ens24_bf16_chunk256": ("ens", 24, ENS_DEPTHS, torch.bfloat16, 256, False),
    "ens32_bf16_chunk256": ("ens", 32, ENS_DEPTHS, torch.bfloat16, 256, False),
}


def _hbm_program(name: str, device: torch.device):
    """→ a call that runs one step of hbm case ``name``."""
    kind, batch, depths, dtype, chunk, remat = HBM_CASES[name]
    if kind == "mifgsm":
        from i2v_tpu_torch.attacks.whitebox import MIFGSM
        from i2v_tpu_torch.models import get_video_model
        from i2v_tpu_torch.ops import pixel

        atk = MIFGSM(get_video_model("i3d_resnet101", device=device, remat=remat), steps=1)
        videos = pixel.normalize(_clip(batch, device), channel_axis=1)
        labels = torch.zeros(batch, dtype=torch.long)
        return lambda: atk(videos, labels)
    from i2v_tpu_torch.models import get_image_models
    from i2v_tpu_torch.parallel.sharded import make_sharded_i2v_runner

    runner = make_sharded_i2v_runner(
        get_image_models(ENS_NAMES, depths, device=device, dtype=dtype), steps=1,
        step_size=STEP_SIZE, adaptive=kind == "aens", frame_chunk=chunk,
        param_dtype=torch.bfloat16 if dtype == torch.bfloat16 else None)
    clip = _clip(batch, device)
    return lambda: runner(clip)


def _hbm_measure(name: str, device: torch.device, calls: int) -> dict:
    from i2v_tpu_torch.ops import kernels

    _free()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    step = _hbm_program(name, device)
    walls = [_sync_time(step) for _ in range(calls)]
    return {"fits": True, "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "step_s": walls, "launches": dict(kernels.launches)}


def hbm_case(name: str, device: torch.device, calls: int, out: str) -> dict:
    kind, batch, _, dtype, chunk, remat = HBM_CASES[name]
    try:
        info = _hbm_measure(name, device, calls)
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
        info = {"fits": False, "error": msg[:160]}
    _free()
    total = torch.cuda.get_device_properties(device).total_memory
    info.update(case=name, kind=kind, batch=batch, dtype=str(dtype), frame_chunk=chunk,
                remat=remat, calls=calls, total_gib=total / 2**30)
    if info["fits"]:
        print(f"[hbm:{name}] fits: peak {info['peak_gib']:.2f} of {total / 2**30:.2f} GiB; "
              f"steps {', '.join(f'{s:.3f}' for s in info['step_s'])} s; launches "
              f"{info['launches']}", flush=True)
    else:
        print(f"[hbm:{name}] does not fit: {info['error'][:100]}", flush=True)
    record(f"hbm_{name}", info, out)
    return info


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=("cost", "hbm"))
    p.add_argument("case", nargs="?", default="all")
    p.add_argument("--device", default="cuda")
    p.add_argument("--calls", type=int, default=2,
                   help="hbm: steps run a case, the first cold (default 2)")
    p.add_argument("--out", default=ARTIFACT)
    args = p.parse_args(argv)
    cases = COST_CASES if args.mode == "cost" else HBM_CASES
    names = list(cases) if args.case == "all" else [args.case]
    unknown = [n for n in names if n not in cases]
    if unknown:
        raise SystemExit(f"unknown {args.mode} case {unknown[0]!r}; known: {', '.join(cases)}")
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: the probe measures a CUDA card, and none "
                         "is available")
    print(card_info()["nvidia_smi"], flush=True)
    from i2v_tpu_torch.ops import kernels

    total = dict.fromkeys(kernels.launches, 0)
    for name in names:
        row = (cost_case(name, device, args.out) if args.mode == "cost"
               else hbm_case(name, device, args.calls, args.out))
        for k, v in row.get("launches", {}).items():
            total[k] += v
    print(f"[{args.mode}] launches {json.dumps(total)}", flush=True)


if __name__ == "__main__":
    main()
