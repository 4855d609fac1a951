"""Image-guided attack CLI, Kinetics-400 (reference C24: image_main.py).

    python -m i2v_tpu_torch.cli.image_main \
        --attack_method ImageGuidedFML2_Adam_MultiModels --step 60 --device cuda

Writes ``{label}-adv.npy`` + ``loss_info_{shard}.json`` into
``OPT_PATH/Image-{method}-{step}-{prefix}``, the same run directory the JAX
CLI (``i2v_tpu.cli.image_main``) names for the same flags. All four methods
of the JAX CLI: DR, I2V, ENS-I2V and AENS-I2V-MF (which the reference
defines but never wires to a CLI). ``--fused_eval`` evaluates each attacked
batch on the video models in the same process (:mod:`..eval.fused`).
``--sharded`` runs I2V, ENS-I2V and AENS through the frame-chunked runner
(:mod:`..parallel`), which fits AENS at the reference's B=16 on one card and
cuts the frame batch over every card of the process:

    python -m i2v_tpu_torch.cli.image_main --attack_method AENS_I2V_MF \
        --batch_size 16 --sharded --frame_chunk auto --device cuda

``--model_parallel N`` splits the ENS / AENS surrogates over N groups of
cards instead (:mod:`..parallel.ensemble`). Under a multi-process launch
each process attacks its slice of the samples on its own card, into one run
directory:

    torchrun --nproc_per_node 2 -m i2v_tpu_torch.cli.image_main \
        --attack_method ImageGuidedFML2_Adam_MultiModels --step 60
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..utils import artifacts, get_paths
from . import common


def _int_or_auto(s: str):
    """argparse type of --frame_chunk: an int or the literal 'auto'."""
    if s == "auto":
        return s
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected an integer or 'auto', got {s!r}")


def arg_parse(argv=None, kind: str = "Image", default_step: int = 60):
    """``default_step``: 60 for Kinetics (image_main.py:28), 10 for UCF-101
    (image_main_ucf101.py:26), so that default runs land in the reference's
    run directories."""
    p = argparse.ArgumentParser(description="image-guided cross-modal attack")
    p.add_argument("--batch_nums", type=int, default=1)
    p.add_argument("--batch_index", type=int, default=1)
    p.add_argument("--attack_method", default="ImageGuidedFMDirection_Adam",
                   choices=common.IMAGE_GUIDED_METHODS)
    p.add_argument("--step", type=int, default=default_step)
    p.add_argument("--file_prefix", default="")
    p.add_argument("--depth", type=int, default=1, help="tap depth 1-4")
    p.add_argument("--step_size", type=float, default=0.004)
    p.add_argument("--direction_image_model", default="resnet",
                   choices=common.DIRECTION_IMAGE_MODELS)
    p.add_argument("--aens_momentum", type=float, default=0.0)
    p.add_argument("--coef_CE", action="store_true")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace into this directory")
    p.add_argument("--fused_eval", default=None, metavar="MODELS",
                   help="comma-separated video model names (or 'all'): evaluate each "
                        "attacked batch on them in this process, the clips never leaving "
                        "the device, and write the artifacts from a background thread "
                        "(eval/fused.py); replaces the reference's generate-then-evaluate "
                        "round trip (run_image_guided.py:48-52)")
    p.add_argument("--artifact_dtype", default="float32", choices=["float32", "float16"],
                   help="artifact storage dtype; with --fused_eval, float16 is cast on the "
                        "device and halves the device-to-host copy")
    p.add_argument("--no_artifacts", action="store_true",
                   help="with --fused_eval: write the reports only, no artifacts")
    p.add_argument("--sharded", action="store_true",
                   help="run I2V/ENS/AENS through the frame-chunked runner "
                        "(parallel/sharded.py) instead of the attack class")
    p.add_argument("--frame_chunk", type=_int_or_auto, default=None,
                   help="with --sharded or --model_parallel: accumulate the gradient over "
                        "chunks of this many frames (exact: the objective is a sum of per-frame "
                        "terms), so that one chunk's activations are alive at a time; 'auto' "
                        "picks the chunk for the resolution (parallel/sharded.resolve_frame_chunk)")
    p.add_argument("--param_dtype", default=None, choices=["bfloat16"],
                   help="with --sharded: store the surrogates' weights in bf16 (the convs "
                        "stay float32)")
    p.add_argument("--model_parallel", type=int, default=None, metavar="N",
                   help="split the ENS/AENS surrogate ensemble over an N-wide 'model' axis "
                        "of the process's cards (parallel/ensemble.py): each card runs one "
                        "group of the surrogates a step, the gradients (and AENS's per-tap "
                        "signals) summed across the groups")
    p.add_argument("--multigrid", type=int, default=0, metavar="K",
                   help="with --sharded or --model_parallel (I2V/ENS only): run the first K of "
                        "--step Adam steps on downsampled clips and warm-start the "
                        "full-resolution phase from the upsampled modifier "
                        "(parallel/multigrid.py); the trajectory differs from the reference's")
    p.add_argument("--multigrid_scale", type=int, default=2,
                   help="multigrid downsampling factor (must divide the spatial size)")
    common.add_data_args(p)
    args = p.parse_args(argv)
    args.kind = kind
    args.adv_path = os.path.join(
        get_paths().opt_path,
        artifacts.run_dir_name(kind, args.attack_method, args.step,
                               common.effective_file_prefix(args)))
    os.makedirs(args.adv_path, exist_ok=True)
    return args


def run(args, get_bundle=None) -> str:
    """Attack every clip of the shard and write its artifacts (or, under
    ``--fused_eval``, the reports too). The throughput summary is printed and
    kept as ``args.throughput``. ``get_bundle(name)``, where given, supplies
    the fused path's video models."""
    from ..utils.profiling import StepTimer, trace

    print(args)
    device = common.resolve_device(args)
    print(f"[precision] {common.apply_matmul_precision(args)} on {device}")
    dataset, iterate = common.build_dataset(args)
    left, right = common.shard_bounds(args, len(dataset))
    attack = common.build_image_guided_attack(args, device)
    if args.fused_eval:
        return _run_fused(args, device, dataset, iterate, attack, left, right, get_bundle)
    dtype = np.float16 if args.artifact_dtype == "float16" else np.float32
    mesh = getattr(attack, "mesh", None)
    # per-card throughput: the mesh runners span the mesh's positions
    timer = StepTimer(steps_per_call=args.step, clips_per_call=args.batch_size, device=device,
                      n_chips=1 if mesh is None else mesh.size)
    with trace(args.profile):
        for step, batch in enumerate(
                common.batch_iterator(args, dataset, iterate, left, right,
                                      mesh=mesh if args.sharded else None)):
            print(f"Running {args.attack_method}, {step + 1}")
            with timer(clips=len(batch["labels"])):
                out = attack(batch["clips"], batch["labels"], batch["names"])
            adv = out[0] if isinstance(out, tuple) else out  # AENS's triple
            common.save_attack_outputs(args.adv_path, batch, adv, dtype=dtype)
    # one loss_info_{batch_index}.json per shard (reference: image_main.py:94)
    artifacts.save_loss_info(args.adv_path, attack.loss_info, common.loss_shard_index(args))
    args.throughput = timer.summary()
    print(f"[summary] {args.throughput}")
    return args.adv_path


def _run_fused(args, device, dataset, iterate, attack, left, right, get_bundle) -> str:
    """Fused generate→evaluate: each adversarial batch feeds the resident
    video models on the device; artifacts go out from a writer thread."""
    from ..eval.fused import FusedGenerateEvaluate
    from ..models.video_zoo import VIDEO_BUILDERS, get_video_model
    from ..parallel import dist
    from ..utils.paths import VIDEO_MODEL_NAMES
    from ..utils.profiling import trace

    names = (list(VIDEO_MODEL_NAMES) if args.fused_eval == "all"
             else [n.strip() for n in args.fused_eval.split(",") if n.strip()])
    for n in names:
        if n not in VIDEO_BUILDERS:
            raise SystemExit(f"unknown video model {n!r}; have {sorted(VIDEO_BUILDERS)}")
    ucf = args.kind.startswith("UCF101")
    if get_bundle is None:
        def get_bundle(name):
            return get_video_model(name, device=device, tiny=args.tiny, ucf101=ucf)
    bundles = {n: get_bundle(n) for n in names}
    # report rows: one per class (reference: reference.py:106, _ucf101.py:137)
    n_classes = 101 if ucf else 400
    dtype = np.float16 if args.artifact_dtype == "float16" else np.float32
    fused = FusedGenerateEvaluate(attack, bundles,
                                  run_dir=None if args.no_artifacts else args.adv_path,
                                  n_classes=n_classes, artifact_dtype=dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    n_clips = 0
    with trace(args.profile):
        for step, batch in enumerate(
                common.batch_iterator(args, dataset, iterate, left, right,
                                      mesh=attack.mesh if args.sharded else None)):
            print(f"Running fused {args.attack_method}+eval, {step + 1}")
            fused.process_batch(batch)
            n_clips += len(batch["labels"])
        # finalize drains the artifact writer: its files are part of the run;
        # the shards of a multi-process run suffix their reports, which
        # cli.report --merge_shards merges
        multi_shard = args.batch_nums > 1 or dist.process_count() > 1
        acc = fused.finalize(report_dir=args.adv_path,
                             shard=common.loss_shard_index(args) if multi_shard else None)
    dt = time.perf_counter() - t0
    artifacts.save_loss_info(args.adv_path, attack.loss_info, common.loss_shard_index(args))
    args.throughput = {"clips": n_clips, "elapsed_s": dt, "clips_per_sec": n_clips / dt}
    print(f"[summary] fused gen+eval: {n_clips / dt:.3f} clips/s "
          f"({n_clips} clips, {len(names)} eval models, {dt:.1f}s)")
    print(f"[summary] top1: {acc}")
    return args.adv_path


def main(argv=None) -> str:
    return run(arg_parse(argv))


if __name__ == "__main__":
    main()
