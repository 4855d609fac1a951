"""Shared CLI plumbing for the image-guided attacks: data, device and
precision, model and attack construction, artifacts.

PyTorch counterpart of the image-guided half of :mod:`i2v_tpu.cli.common`.
``--data synthetic`` is the only source ported so far; ``--tiny`` swaps in
width-reduced backbones. ``--device`` (default ``cuda``) names the device the
attack runs on; a CUDA run on a machine without a card stops, it never
continues on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import attacks
from ..data import synthetic as synthetic_mod
from ..models import get_image_models
from ..utils import artifacts

# the methods ported so far; the parser's choices reject the others
IMAGE_GUIDED_METHODS = (
    "ImageGuidedFMDirection_Adam",
    "ImageGuidedFML2_Adam_MultiModels",
)


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


def build_image_guided_attack(args, device: torch.device):
    """Dispatch an image-guided method (reference: image_main.py:66-80)."""
    method = args.attack_method
    hw = 32 if args.tiny else data_shape(args)[1]
    if method == "ImageGuidedFMDirection_Adam":
        models = get_image_models([args.direction_image_model], args.depth,
                                  device=device, tiny=args.tiny, input_hw=hw)
        return attacks.ImageGuidedFMDirection_Adam(models, step_size=args.step_size,
                                                   steps=args.step)
    if method == "ImageGuidedFML2_Adam_MultiModels":
        names = ["resnet", "vgg", "squeezenet", "alexnet"]
        depths = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
        models = get_image_models(names, depths, device=device, tiny=args.tiny, input_hw=hw)
        return attacks.ImageGuidedFML2_Adam_MultiModels(models, steps=args.step)
    raise ValueError(f"unknown image-guided method {method!r}")


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


def save_attack_outputs(run_dir, batch, adv: torch.Tensor, dtype=np.float32) -> None:
    artifacts.save_batch(run_dir, batch["labels"], adv.detach().cpu().numpy(), dtype=dtype)
