"""Grad-CAM CLI (reference C21: `image_cam.py` + `image_cam_utils.py`).

PyTorch counterpart of :mod:`i2v_tpu.cli.gradcam`. It loads
``{label}-adv.npy`` (or ``-ori``) clips from a run directory, computes the
multi-model average Grad-CAM saliency per frame on ``--device`` (default
``cuda``; a CUDA run on a machine without a card stops), and writes

    <out>/{label}-cam.npy      (T, H, W) float16 masks in [0, 1]
    <out>/{label}-f{k}.png     optional jet-heatmap overlays (--save_png K)

    python -m i2v_tpu_torch.cli.gradcam --used_adv Image-ImageGuidedFMDirection_Adam-60-

The model list defaults to the reference's five CAM models
(image_cam.py:16-28: alexnet, vgg16, resnet101, densenet161, squeezenet1_1)
at depth 4, the deepest tap (the ``find_*_layer`` last-conv defaults,
image_cam_utils.py:26-184), untruncated. The class is the argmax of the
logits, as in the reference's ``class_idx=None`` path (image_cam.py:116-121).
Each model's map is one forward and one backward a batch, captured once a
batch shape as a CUDA graph on a card and replayed (``_cam_fns``), as the
JAX CLI jits one evaluator a bundle.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..eval import gradcam as gradcam_mod
from ..models import get_image_models
from ..ops import pixel
from ..utils import artifacts, get_paths
from . import common

CAM_MODELS = ("alexnet", "vgg", "resnet", "densenet", "squeezenet")


def arg_parse(argv=None):
    p = argparse.ArgumentParser(description="multi-model GradCAM over attack "
                                            "artifacts")
    p.add_argument("--used_adv", required=True,
                   help="run dir containing {label}-adv.npy clips")
    p.add_argument("--kind", default="adv", choices=["adv", "ori"],
                   help="which artifact of each sample to explain")
    p.add_argument("--models", nargs="+", default=list(CAM_MODELS),
                   help="image models to average over (reference list: "
                        f"{' '.join(CAM_MODELS)})")
    p.add_argument("--depth", type=int, default=4,
                   help="tap depth for every model (4 = last conv stage, "
                        "the reference's find_*_layer default)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--out", default=None,
                   help="output dir (default: <used_adv>-cam)")
    p.add_argument("--save_png", type=int, default=0, metavar="K",
                   help="also write heatmap overlays for the first K frames "
                        "of each clip")
    p.add_argument("--tiny", action="store_true",
                   help="width-reduced backbones (checkpoint-free runs)")
    p.add_argument("--matmul_precision", default=None,
                   choices=["default", "high", "float32"],
                   help="float32 convs and matmuls on the card (see image_main "
                        "--matmul_precision)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    opt = get_paths().opt_path
    if not os.path.isabs(args.used_adv) and not os.path.isdir(args.used_adv):
        args.used_adv = os.path.join(opt, args.used_adv)
    args.out = args.out or args.used_adv.rstrip("/") + "-cam"
    return args


def _cam_fns(bundles, graphs: bool = True):
    """One CAM evaluator per bundle (:class:`~i2v_tpu_torch.eval.gradcam.CamEvaluator`,
    a CUDA graph a batch shape on a card; ``graphs=False``: eager): frames01
    NCHW → (N, h', w') raw map at the model's tap resolution. Upsampling and
    the cross-model mean happen after, at a common size."""
    return [gradcam_mod.CamEvaluator(b, graphs) for b in bundles]


def average_cam_for_clips(clips_norm_bcthw: np.ndarray, cam_fns, size: int,
                          device: torch.device | str):
    """(B,3,T,H,W) normalized clips → ((B,T,size,size) averaged masks in
    [0,1], (B,T,size,size,3) [0,1] frames), both numpy; the maps are
    computed on ``device``, where the bundles of ``cam_fns`` live.

    Each model's saliency is min-max scaled PER CLIP (scalar min/max over
    that clip's T×h'×w' tensor — the reference normalizes one clip's stacked
    frames with scalar saliency_map.min()/.max(), image_cam.py:128-129), so
    a clip's mask is independent of which other clips share its batch; the
    cross-model mean is then min-max scaled per clip once more."""
    b, _, t = clips_norm_bcthw.shape[:3]
    clips01 = pixel.unnormalize(torch.from_numpy(np.ascontiguousarray(clips_norm_bcthw))
                                .to(device), channel_axis=1)
    frames = pixel.flatten_clip_to_frames(clips01)  # (B·T, 3, H, W)
    acc = None
    for fn in cam_fns:
        cam = gradcam_mod.minmax_per_clip(fn(frames), t)
        cam = gradcam_mod._upsample(cam, size)
        acc = cam if acc is None else acc + cam
    mean = acc.detach().cpu().numpy().reshape(b, t, size, size) / len(cam_fns)
    lo = mean.min(axis=(1, 2, 3), keepdims=True)
    hi = mean.max(axis=(1, 2, 3), keepdims=True)
    frames_nhwc = frames.permute(0, 2, 3, 1).cpu().numpy()
    return ((mean - lo) / np.maximum(hi - lo, 1e-12),
            frames_nhwc.reshape(b, t, size, size, 3))


def main(argv=None) -> str:
    args = arg_parse(argv)
    device = common.resolve_device(args)
    print(f"[precision] {common.apply_matmul_precision(args)} on {device}")
    if args.save_png:
        from PIL import Image  # fail at startup, not mid-run
    files = artifacts.list_adv_files(args.used_adv, args.kind)
    if not files:
        raise SystemExit(f"no {args.kind} artifacts under {args.used_adv!r}")
    probe, _ = artifacts.load_adv_batch(args.used_adv, files[:1])
    size = probe.shape[-1]
    bundles = get_image_models(args.models, args.depth, device=device, tiny=args.tiny,
                               truncate=False, input_hw=size)
    cam_fns = _cam_fns(bundles)
    os.makedirs(args.out, exist_ok=True)
    for chunk in artifacts.batch_files(files, args.batch_size):
        clips, labels = artifacts.load_adv_batch(args.used_adv, chunk)
        cams, frames01 = average_cam_for_clips(clips, cam_fns, size, device)
        for i, label in enumerate(labels):
            np.save(os.path.join(args.out, f"{label}-cam.npy"),
                    cams[i].astype(np.float16))
            for k in range(min(args.save_png, cams.shape[1])):
                img = gradcam_mod.visualize_cam(cams[i, k],
                                                np.clip(frames01[i, k], 0, 1))
                Image.fromarray(img).save(
                    os.path.join(args.out, f"{label}-f{k}.png"))
        print(f"[gradcam] {len(labels)} clips → {args.out}", flush=True)
    return args.out


if __name__ == "__main__":
    main()
