"""Shared CLI plumbing for the image-guided and white-box attacks: data,
device and precision, model and attack construction, resume, artifacts.

PyTorch counterpart of :mod:`i2v_tpu.cli.common`. ``--sharded`` runs
I2V / ENS-I2V / AENS-I2V-MF through the frame-chunked single-device runner
(:mod:`i2v_tpu_torch.parallel`), with ``--frame_chunk``, ``--param_dtype``
and ``--multigrid``; only ``--model_parallel`` is refused, naming its ROADMAP
item.
``--data synthetic`` is the only source ported so far; ``--tiny`` swaps in
width-reduced backbones. ``--device`` (default ``cuda``) names the device the
attack runs on; a CUDA run on a machine without a card stops, it never
continues on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import attacks
from ..data import synthetic as synthetic_mod
from ..models import get_image_models
from ..utils import artifacts

IMAGE_GUIDED_METHODS = (
    "ImageGuidedStd_Adam",
    "ImageGuidedFMDirection_Adam",
    "ImageGuidedFML2_Adam_MultiModels",
    "AENS_I2V_MF",
)
# the JAX CLI's surrogates for DR and I2V; densenet and vit are refused
DIRECTION_IMAGE_MODELS = ("resnet", "vgg", "alexnet", "squeezenet")
UNPORTED_IMAGE_MODELS = ("densenet", "vit")
# the JAX image CLI's runner flags, refused with the work item named
UNPORTED_RUNNER_FLAGS = {
    "model_parallel": "item 9 (multi-device)",
}
WHITEBOX_METHODS = (
    "FGSM", "BIM", "MIFGSM", "DIFGSM", "TIFGSM", "TIFGSM3D", "SGM", "SIM",
    "TAP", "TemporalTranslation",
)


def direction_image_model(name: str) -> str:
    """argparse ``type`` of --direction_image_model: names the ROADMAP item of
    a surrogate that is not ported yet."""
    if name in UNPORTED_IMAGE_MODELS:
        raise argparse.ArgumentTypeError(
            f"{name} is not ported yet (ROADMAP Queue 1, item 9: models/densenet.py, "
            "models/vit.py); ported: " + ", ".join(DIRECTION_IMAGE_MODELS))
    return name


def add_unported_runner_args(p: argparse.ArgumentParser) -> None:
    """The JAX image CLI's runner flags; :func:`refuse_unported_runner_args`
    stops a run that passes one."""
    for flag, item in UNPORTED_RUNNER_FLAGS.items():
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help=f"not ported yet (ROADMAP Queue 1, {item})")


def refuse_unported_runner_args(p: argparse.ArgumentParser, args) -> None:
    for flag, item in UNPORTED_RUNNER_FLAGS.items():
        if getattr(args, flag) is not None:
            p.error(f"--{flag} is not ported yet (ROADMAP Queue 1, {item})")


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data", default="synthetic", choices=["synthetic"],
                   help="data source (synthetic = dataset-free smoke path)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--n_synthetic", type=int, default=4)
    p.add_argument("--clip_len", type=int, default=None,
                   help="frames per clip (default 32; 8 for --tiny synthetic)")
    p.add_argument("--crop_size", type=int, default=None,
                   help="spatial size (default 224; 32 for --tiny synthetic)")
    p.add_argument("--tiny", action="store_true",
                   help="width-reduced backbones (checkpoint-free runs)")
    p.add_argument("--matmul_precision", default=None,
                   choices=["default", "high", "float32"],
                   help="float32 convs and matmuls on the card: 'float32' turns "
                        "TF32 off for cuDNN and cuBLAS; 'high' allows TF32 for "
                        "both; unset/'default' keeps torch's defaults (TF32 "
                        "convs, full-float32 matmuls)")
    p.add_argument("--device", default="cuda",
                   help="torch device to attack on (cuda, cuda:N or cpu)")


def data_shape(args) -> tuple[int, int]:
    """Effective (clip_len, crop_size): explicit flags win; --tiny shrinks
    only the derived synthetic defaults."""
    tiny_synth = args.tiny and getattr(args, "data", None) == "synthetic"
    clip_len = args.clip_len if args.clip_len is not None else (8 if tiny_synth else 32)
    crop = args.crop_size if args.crop_size is not None else (32 if tiny_synth else 224)
    return clip_len, crop


def resolve_device(args) -> torch.device:
    """The attack device; ``SystemExit`` for a CUDA device without a card."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def apply_matmul_precision(args) -> str:
    """Set the float32 precision of cuDNN convs and cuBLAS matmuls from
    --matmul_precision and return a description of the mode in force."""
    prec = getattr(args, "matmul_precision", None) or "default"
    conv_tf32, matmul_tf32 = {"float32": (False, False), "high": (True, True),
                              "default": (True, False)}[prec]
    torch.backends.cudnn.allow_tf32 = conv_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    return (f"{prec} (cudnn.allow_tf32={conv_tf32}, "
            f"cuda.matmul.allow_tf32={matmul_tf32})")


def build_dataset(args):
    """→ (dataset, iterate_batches) for the chosen source."""
    clip_len, crop = data_shape(args)
    ds = synthetic_mod.SyntheticAttackDataset(n_samples=args.n_synthetic,
                                              clip_len=clip_len, size=crop)
    return ds, synthetic_mod.iterate_batches


def check_runner_args(args) -> None:
    """The JAX CLI's checks of ``--sharded`` and ``--multigrid``, with its
    conditions and messages (``i2v_tpu/cli/common.py:199-226,246-251``)."""
    method = args.attack_method
    hw = 32 if args.tiny else data_shape(args)[1]
    sharded = getattr(args, "sharded", False)
    multigrid = getattr(args, "multigrid", 0) or 0
    if multigrid and not sharded:
        raise SystemExit("--multigrid runs through the sharded or model-parallel runners; "
                         "add --sharded or --model_parallel N")
    if multigrid and method == "AENS_I2V_MF":
        raise SystemExit("--multigrid does not compose with AENS's adaptive coefficients "
                         "(resolution-coupled signal)")
    if multigrid and method == "ImageGuidedStd_Adam":
        raise SystemExit("--multigrid supports the cosine-objective methods (I2V/ENS), not DR")
    if multigrid and multigrid >= args.step:
        raise SystemExit(f"--multigrid {multigrid} must be smaller than --step {args.step} "
                         "(some steps must remain for the full-resolution phase)")
    mg_scale = getattr(args, "multigrid_scale", 2)
    if multigrid and (mg_scale < 2 or hw % mg_scale):
        raise SystemExit(f"--multigrid_scale {mg_scale} must be >= 2 and divide the spatial "
                         f"size ({hw})")
    if sharded and method == "ImageGuidedStd_Adam":
        raise SystemExit("--sharded supports the cosine-objective methods (I2V/ENS/AENS), "
                         "not DR")


def build_image_guided_attack(args, device: torch.device):
    """Dispatch an image-guided method (reference: image_main.py:66-80), and
    AENS, which the reference defines but never wires to a CLI. ``--sharded``
    routes I2V, ENS-I2V and AENS through the frame-chunked runner instead of
    the attack class."""
    check_runner_args(args)
    method = args.attack_method
    hw = 32 if args.tiny else data_shape(args)[1]

    def build(models, *, step_size, adaptive=False, momentum=0.0, coef_ce=False):
        from ..parallel import ShardedImageGuidedAttack

        return ShardedImageGuidedAttack(
            models, steps=args.step, step_size=step_size, adaptive=adaptive,
            aens_momentum=momentum, coef_ce=coef_ce, name=method,
            frame_chunk=args.frame_chunk,
            param_dtype=torch.bfloat16 if args.param_dtype == "bfloat16" else None,
            multigrid=args.multigrid, multigrid_scale=args.multigrid_scale)

    if method in ("ImageGuidedStd_Adam", "ImageGuidedFMDirection_Adam"):
        models = get_image_models([args.direction_image_model], args.depth,
                                  device=device, tiny=args.tiny, input_hw=hw)
        if args.sharded:
            return build(models, step_size=args.step_size)
        return getattr(attacks, method)(models, step_size=args.step_size, steps=args.step)
    names = ["resnet", "vgg", "squeezenet", "alexnet"]
    if method == "ImageGuidedFML2_Adam_MultiModels":
        depths = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
        models = get_image_models(names, depths, device=device, tiny=args.tiny, input_hw=hw)
        if args.sharded:
            return build(models, step_size=0.005)
        return attacks.ImageGuidedFML2_Adam_MultiModels(models, steps=args.step)
    if method == "AENS_I2V_MF":
        depths = {n: [2, 3] for n in names}
        models = get_image_models(names, depths, device=device, tiny=args.tiny, input_hw=hw)
        if args.sharded:
            return build(models, step_size=args.step_size, adaptive=True,
                         momentum=args.aens_momentum, coef_ce=args.coef_CE)
        return attacks.AENS_I2V_MF(models, step_size=args.step_size,
                                   momentum=args.aens_momentum, coef_CE=args.coef_CE,
                                   steps=args.step)
    raise ValueError(f"unknown image-guided method {method!r}")


def build_whitebox_attack(args, bundle):
    """Dispatch a white-box method name to an attack instance (the
    reference's getattr dispatch, attack.py:76-83)."""
    name = args.attack_method
    if name == "TemporalTranslation":
        params = {"kernlen": args.kernlen, "momentum": bool(args.momentum),
                  "weight": args.augmentation_weight, "move_type": args.move_type,
                  "kernel_mode": args.kernel_mode, "chunk": args.tt_chunk}
        atk = attacks.TemporalTranslation(bundle, params, steps=args.step)
    elif name == "TAP":
        params = {"kernlen": 3, "temporal_kernlen": 3, "eta": 1e3, "conv3d": True}
        atk = attacks.TAP(bundle, params, steps=args.step)
    elif name == "SIM" and getattr(args, "sim_batch_scales", False):
        atk = attacks.SIM(bundle, steps=args.step, batch_scales=True)
    else:
        atk = getattr(attacks, name)(bundle, steps=args.step)
    chunk = getattr(args, "batch_chunk", None)
    if chunk:
        if hasattr(atk, "cfg"):
            atk.cfg = dataclasses.replace(atk.cfg, batch_chunk=chunk)
        else:
            # TAP and TT build their configurations inside; a memory flag
            # dropped without a word would leave the user out of memory
            print(f"[warn] --batch_chunk {chunk} is not supported by {name} and was ignored",
                  flush=True)
    return atk


def shard_bounds(args, n_samples: int) -> tuple[int, int]:
    """[left, right) of this shard under the reference's 1-based
    --batch_nums/--batch_index contract (image_main.py:61-63)."""
    n_shards, index = args.batch_nums, args.batch_index - 1
    if n_shards < 1 or not 0 <= index < n_shards:
        raise SystemExit(f"--batch_index/--batch_nums: shard index {index} out of range "
                         f"for {n_shards} shards (the contract is 1-based)")
    per = n_samples // n_shards
    left = index * per
    right = n_samples if index == n_shards - 1 else left + per
    return left, right


def effective_file_prefix(args) -> str:
    """Run-dir prefix with the synthetic smoke source marked, so a synthetic
    run never shares an artifact dir with a real-data run."""
    prefix = getattr(args, "file_prefix", "") or ""
    if getattr(args, "data", None) == "synthetic" and "synthetic" not in prefix:
        prefix = f"synthetic{'-' + prefix if prefix else ''}"
    return prefix


class _ResumeSubsetView:
    """Dataset view over the not-yet-attacked manifest indices."""

    def __init__(self, inner, idxs):
        self._inner = inner
        self._idxs = list(idxs)
        if not hasattr(inner, "load_batch"):
            self.load_batch = None  # falsy: the batcher falls back to items

    def __len__(self):
        return len(self._idxs)

    def __getitem__(self, i):
        return self._inner[self._idxs[i]]

    def load_batch(self, idxs):
        return self._inner.load_batch([self._idxs[i] for i in idxs])


def resume_subset(dataset, done: set):
    """Drop the manifest entries whose label already has artifacts before
    anything is decoded. Returns None when nothing can be (or needs to be)
    dropped: a dataset without cheap label metadata (``samples[i].label``),
    such as the synthetic one, relies on the in-loop skip instead."""
    samples = getattr(dataset, "samples", None)
    if not done or not samples or not hasattr(samples[0], "label"):
        return None
    keep = [i for i, s in enumerate(samples) if int(s.label) not in done]
    return None if len(keep) == len(samples) else _ResumeSubsetView(dataset, keep)


def save_attack_outputs(run_dir, batch, adv: torch.Tensor, save_ori: bool = False,
                        dtype=np.float32) -> None:
    """``{label}-adv.npy`` for each clip of the batch and, with ``save_ori``,
    the clean clip as ``{label}-ori.npy`` (the white-box protocol)."""
    ori = np.asarray(batch["clips"]) if save_ori else None
    artifacts.save_batch(run_dir, batch["labels"], adv.detach().cpu().numpy(),
                         ori_batch=ori, dtype=dtype)
