"""Shared CLI plumbing for the image-guided and white-box attacks: data,
device and precision, model and attack construction, resume, artifacts.

PyTorch counterpart of :mod:`i2v_tpu.cli.common`. ``--sharded`` runs
I2V / ENS-I2V / AENS-I2V-MF through the frame-chunked runner with the frame
batch cut over a mesh of this process's cards (:mod:`i2v_tpu_torch.parallel`),
with ``--frame_chunk``, ``--param_dtype`` and ``--multigrid``;
``--model_parallel N`` splits the ENS / AENS surrogates over an N-wide model
axis. Under a multi-process launch (:mod:`i2v_tpu_torch.parallel.dist`)
each process takes its slice of the samples, its own card and its own
``loss_info`` shard.
``--data`` reads Kinetics-400 clips, UCF-101 frame JPEGs or synthetic clips
(the dataset-free smoke path); ``--u8_ingress`` ships the decoded uint8
frames and normalizes them on the device, and ``--prefetch N`` decodes and
uploads N batches ahead of the attack. ``--tiny`` swaps in width-reduced
backbones. ``--device`` (default ``cuda``) names the device the attack runs
on; a CUDA run on a machine without a card stops, it never continues on the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from .. import attacks
from ..data import kinetics as kinetics_mod
from ..data import synthetic as synthetic_mod
from ..data import transforms as transforms_mod
from ..data import ucf101 as ucf101_mod
from ..models import get_image_models
from ..ops import pixel
from ..utils import artifacts, get_paths

IMAGE_GUIDED_METHODS = (
    "ImageGuidedStd_Adam",
    "ImageGuidedFMDirection_Adam",
    "ImageGuidedFML2_Adam_MultiModels",
    "AENS_I2V_MF",
)
# the JAX CLI's surrogates for DR and I2V (i2v_tpu/cli/image_main.py:48-52)
DIRECTION_IMAGE_MODELS = ("resnet", "vgg", "alexnet", "squeezenet", "densenet", "vit")
WHITEBOX_METHODS = (
    "FGSM", "BIM", "MIFGSM", "DIFGSM", "TIFGSM", "TIFGSM3D", "SGM", "SIM",
    "TAP", "TemporalTranslation",
)


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data", default="synthetic", choices=["kinetics", "ucf101", "synthetic"],
                   help="data source (synthetic = dataset-free smoke path)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--n_synthetic", type=int, default=4)
    p.add_argument("--clip_len", type=int, default=None,
                   help="frames per clip (default 32; 8 for --tiny synthetic)")
    p.add_argument("--crop_size", type=int, default=None,
                   help="spatial size (default 224; 32 for --tiny synthetic)")
    p.add_argument("--tiny", action="store_true",
                   help="width-reduced backbones (checkpoint-free runs)")
    p.add_argument("--u8_ingress", action="store_true",
                   help="ship decoded uint8 frames to the device and normalize there "
                        "(4x less host->device traffic; bit-identical numerics)")
    p.add_argument("--prefetch", type=int, default=0, metavar="DEPTH",
                   help="decode + upload the next DEPTH batches in a background thread "
                        "while the current batch attacks (data/pipeline.py); hides decode "
                        "and host->device ingest behind attack compute. Each prefetched "
                        "batch holds device memory (B=16 f32 is ~308 MB; 77 MB with "
                        "--u8_ingress), so keep DEPTH small")
    p.add_argument("--matmul_precision", default=None,
                   choices=["default", "high", "float32"],
                   help="float32 convs and matmuls on the card: 'float32' turns "
                        "TF32 off for cuDNN and cuBLAS; 'high' allows TF32 for "
                        "both; unset/'default' keeps torch's defaults (TF32 "
                        "convs, full-float32 matmuls). No mode touches bfloat16 "
                        "work, whose GEMMs always reduce in float32")
    p.add_argument("--device", default="cuda",
                   help="torch device to attack on (cuda, cuda:N or cpu); with --sharded or "
                        "--model_parallel, 'cuda' spans every card of the process")


def data_shape(args) -> tuple[int, int]:
    """Effective (clip_len, crop_size): explicit flags win; --tiny shrinks
    only the derived synthetic defaults."""
    tiny_synth = args.tiny and getattr(args, "data", None) == "synthetic"
    clip_len = args.clip_len if args.clip_len is not None else (8 if tiny_synth else 32)
    crop = args.crop_size if args.crop_size is not None else (32 if tiny_synth else 224)
    return clip_len, crop


def resolve_device(args) -> torch.device:
    """The attack device; ``SystemExit`` for a CUDA device without a card.
    Under a multi-process launch, ``--device cuda`` is this process's card
    (:func:`~i2v_tpu_torch.parallel.dist.local_device`)."""
    from ..parallel import dist

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    if device == torch.device("cuda") and dist.maybe_initialize_distributed():
        return dist.local_device()
    return device


def mesh_devices(args) -> list | None:
    """The devices a mesh of this process spans: ``--device`` itself where
    it names one device (``cpu``, ``cuda:N``) or under a multi-process
    launch (each process its own card), else None: every local card."""
    device = resolve_device(args)
    if device.type == "cuda" and device.index is None:
        return None
    return [device]


def apply_matmul_precision(args) -> str:
    """Set the float32 precision of cuDNN convs and cuBLAS matmuls from
    --matmul_precision and return a description of the mode in force.

    The TF32 flags touch float32 work only. bfloat16 GEMMs (the heads, ViT's
    linears) are held to float32 reductions in every mode: torch lets cuBLAS
    reduce them in bfloat16 by default
    (``allow_bf16_reduced_precision_reduction``), while the JAX modules
    accumulate a bfloat16 product in float32. cuDNN's bfloat16 convs
    accumulate in float32 either way."""
    prec = getattr(args, "matmul_precision", None) or "default"
    conv_tf32, matmul_tf32 = {"float32": (False, False), "high": (True, True),
                              "default": (True, False)}[prec]
    torch.backends.cudnn.allow_tf32 = conv_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return (f"{prec} (cudnn.allow_tf32={conv_tf32}, "
            f"cuda.matmul.allow_tf32={matmul_tf32}, "
            "bf16 reduced-precision reduction off)")


def build_dataset(args):
    """→ (dataset, iterate_batches) for the chosen source."""
    paths = get_paths()
    clip_len, crop = data_shape(args)
    u8 = args.u8_ingress
    if args.data == "kinetics":
        ds = kinetics_mod.KineticsAttackDataset(paths.kinetics_anno, paths.kinetics_data,
                                                clip_len=clip_len, crop_size=crop,
                                                raw_uint8=u8)
        return ds, kinetics_mod.iterate_batches
    if args.data == "ucf101":
        used = (ucf101_mod.load_used_idxs(paths.ucf_used_idxs)
                if os.path.exists(paths.ucf_used_idxs) else None)
        ds = ucf101_mod.UCF101AttackDataset(paths.ucf_setting, paths.ucf_image_root,
                                            used_idxs=used, clip_len=clip_len,
                                            crop_size=crop, raw_uint8=u8)
        return ds, ucf101_mod.iterate_batches
    ds = synthetic_mod.SyntheticAttackDataset(n_samples=args.n_synthetic, clip_len=clip_len,
                                              size=crop, raw_uint8=u8)
    return ds, synthetic_mod.iterate_batches


def batch_iterator(args, dataset, iterate, left: int = 0, right=None,
                   keep_host: bool = False, mesh=None):
    """The CLI's batch stream: in the loop's thread by default; with
    ``--prefetch N`` a decode thread and early uploads to ``args.device`` run
    N batches ahead of the attack (``data.pipeline.make_input_pipeline``),
    landing each batch over ``mesh`` (the ``--sharded`` attack's) as its
    per-device pieces. ``keep_host`` keeps the host clips under
    ``clips_host`` for the writers of ``-ori`` artifacts."""
    if args.prefetch <= 0:
        return iterate(dataset, args.batch_size, left, right)
    from ..data.pipeline import make_input_pipeline

    return make_input_pipeline(dataset, args.batch_size, iterate, left=left, right=right,
                               device=resolve_device(args), prefetch_depth=args.prefetch,
                               keep_host=keep_host, mesh=mesh)


def check_runner_args(args) -> None:
    """The JAX CLI's checks of ``--sharded``, ``--model_parallel`` and
    ``--multigrid``, with its conditions and messages
    (``i2v_tpu/cli/common.py:199-226,246-251``)."""
    method = args.attack_method
    hw = 32 if args.tiny else data_shape(args)[1]
    sharded = getattr(args, "sharded", False)
    model_parallel = getattr(args, "model_parallel", None)
    multigrid = getattr(args, "multigrid", 0) or 0
    if model_parallel and method not in ("ImageGuidedFML2_Adam_MultiModels", "AENS_I2V_MF"):
        raise SystemExit("--model_parallel splits the surrogate ensemble; it only applies to "
                         "the ensemble methods (ENS/AENS)")
    if model_parallel and sharded:
        raise SystemExit("--model_parallel and --sharded are alternative parallelizations of "
                         "the ensemble step; pick one")
    if multigrid and not (sharded or model_parallel):
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


def build_image_guided_attack(args, device: torch.device, graphs: bool = True):
    """Dispatch an image-guided method (reference: image_main.py:66-80), and
    AENS, which the reference defines but never wires to a CLI. ``--sharded``
    routes I2V, ENS-I2V and AENS through the frame-chunked runner over
    ``attack_mesh`` of this process's devices, and ``--model_parallel N``
    ENS-I2V and AENS through the model-axis runner over ``ensemble_mesh``,
    instead of the attack class. On a card every path's steps are CUDA
    graphs; ``graphs=False`` (no CLI flag: the profiling tools' comparison)
    runs them eagerly."""
    check_runner_args(args)
    method = args.attack_method
    hw = 32 if args.tiny else data_shape(args)[1]
    model_parallel = getattr(args, "model_parallel", None)

    def build(models, *, step_size, adaptive=False, momentum=0.0, coef_ce=False):
        from ..parallel import (EnsembleParallelAttack, ShardedImageGuidedAttack, attack_mesh,
                                ensemble_mesh)

        kw = dict(steps=args.step, step_size=step_size, adaptive=adaptive,
                  aens_momentum=momentum, coef_ce=coef_ce, name=method,
                  frame_chunk=args.frame_chunk, multigrid=args.multigrid,
                  multigrid_scale=args.multigrid_scale)
        if model_parallel:
            return EnsembleParallelAttack(
                models, ensemble_mesh(mesh_devices(args), model=model_parallel), graphs=graphs,
                **kw)
        return ShardedImageGuidedAttack(
            models, attack_mesh(mesh_devices(args)),
            param_dtype=torch.bfloat16 if args.param_dtype == "bfloat16" else None,
            graphs=graphs, **kw)

    if method in ("ImageGuidedStd_Adam", "ImageGuidedFMDirection_Adam"):
        models = get_image_models([args.direction_image_model], args.depth,
                                  device=device, tiny=args.tiny, input_hw=hw)
        if args.sharded:
            return build(models, step_size=args.step_size)
        return getattr(attacks, method)(models, step_size=args.step_size, steps=args.step,
                                        graphs=graphs)
    names = ["resnet", "vgg", "squeezenet", "alexnet"]
    if method == "ImageGuidedFML2_Adam_MultiModels":
        depths = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
        models = get_image_models(names, depths, device=device, tiny=args.tiny, input_hw=hw)
        if args.sharded or model_parallel:
            return build(models, step_size=0.005)
        return attacks.ImageGuidedFML2_Adam_MultiModels(models, steps=args.step, graphs=graphs)
    if method == "AENS_I2V_MF":
        depths = {n: [2, 3] for n in names}
        models = get_image_models(names, depths, device=device, tiny=args.tiny, input_hw=hw)
        if args.sharded or model_parallel:
            return build(models, step_size=args.step_size, adaptive=True,
                         momentum=args.aens_momentum, coef_ce=args.coef_CE)
        return attacks.AENS_I2V_MF(models, step_size=args.step_size,
                                   momentum=args.aens_momentum, coef_CE=args.coef_CE,
                                   steps=args.step, graphs=graphs)
    raise ValueError(f"unknown image-guided method {method!r}")


def build_whitebox_attack(args, bundle, graphs: bool = True):
    """Dispatch a white-box method name to an attack instance (the
    reference's getattr dispatch, attack.py:76-83). ``graphs=False`` runs
    the method's steps eagerly on a card, where they are CUDA graphs."""
    name = args.attack_method
    if name == "TemporalTranslation":
        params = {"kernlen": args.kernlen, "momentum": bool(args.momentum),
                  "weight": args.augmentation_weight, "move_type": args.move_type,
                  "kernel_mode": args.kernel_mode, "chunk": args.tt_chunk}
        atk = attacks.TemporalTranslation(bundle, params, steps=args.step, graphs=graphs)
    elif name == "TAP":
        params = {"kernlen": 3, "temporal_kernlen": 3, "eta": 1e3, "conv3d": True}
        atk = attacks.TAP(bundle, params, steps=args.step, graphs=graphs)
    elif name == "SIM" and getattr(args, "sim_batch_scales", False):
        atk = attacks.SIM(bundle, steps=args.step, batch_scales=True, graphs=graphs)
    else:
        atk = getattr(attacks, name)(bundle, steps=args.step, graphs=graphs)
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
    --batch_nums/--batch_index contract (image_main.py:61-63). Under a
    multi-process launch, with the flags at their defaults, each process
    takes its rank's slice of the samples instead
    (:func:`~i2v_tpu_torch.parallel.dist.process_shard_bounds`)."""
    from ..parallel import dist

    if (dist.maybe_initialize_distributed() and args.batch_nums == 1
            and dist.process_count() > 1):
        return dist.process_shard_bounds(n_samples)
    try:
        return dist.process_shard_bounds(n_samples, args.batch_nums, args.batch_index - 1)
    except ValueError as e:
        raise SystemExit(f"--batch_index/--batch_nums: {e}")


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


def loss_shard_index(args) -> int:
    """``loss_info_{N}.json``'s shard id: ``--batch_index`` (the reference's
    per-shard loss_info files, image_main.py:94), or the 1-based rank under
    a multi-process launch, so that each process writes its own."""
    from ..parallel import dist

    if getattr(args, "batch_nums", 1) == 1 and dist.process_count() > 1:
        return dist.process_index() + 1
    return args.batch_index


def save_attack_outputs(run_dir, batch, adv: torch.Tensor, save_ori: bool = False,
                        dtype=np.float32) -> None:
    """``{label}-adv.npy`` for each clip of the batch and, with ``save_ori``,
    the clean clip as ``{label}-ori.npy`` (the white-box protocol). The clean
    clips come from the host copy a prefetched batch keeps
    (``clips_host``); uint8 (B,T,H,W,3) clips are normalized on the host
    into the artifacts' float32 (B,3,T,H,W)."""
    ori = None
    if save_ori:
        ori = np.asarray(batch.get("clips_host", batch["clips"]))
        if pixel.is_u8_clips(ori):
            ori = np.stack([transforms_mod.u8_clip_to_normalized(c) for c in ori])
    artifacts.save_batch(run_dir, batch["labels"], adv.detach().cpu().numpy(),
                         ori_batch=ori, dtype=dtype)
