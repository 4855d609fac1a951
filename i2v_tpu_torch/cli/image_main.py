"""Image-guided attack CLI, Kinetics-400 (reference C24: image_main.py).

    python -m i2v_tpu_torch.cli.image_main \
        --attack_method ImageGuidedFML2_Adam_MultiModels --step 60 --device cuda

Writes ``{label}-adv.npy`` + ``loss_info_{shard}.json`` into
``OPT_PATH/Image-{method}-{step}-{prefix}``, the same run directory the JAX
CLI (``i2v_tpu.cli.image_main``) names for the same flags.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import artifacts, get_paths
from . import common


def arg_parse(argv=None, kind: str = "Image", default_step: int = 60):
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
                   choices=["resnet", "vgg", "alexnet", "squeezenet"])
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace into this directory")
    p.add_argument("--artifact_dtype", default="float32", choices=["float32", "float16"],
                   help="artifact storage dtype")
    common.add_data_args(p)
    args = p.parse_args(argv)
    args.kind = kind
    args.adv_path = os.path.join(
        get_paths().opt_path,
        artifacts.run_dir_name(kind, args.attack_method, args.step,
                               common.effective_file_prefix(args)))
    os.makedirs(args.adv_path, exist_ok=True)
    return args


def run(args) -> str:
    """Attack every clip of the shard and write its artifacts. The
    throughput summary is printed and kept as ``args.throughput``."""
    from ..utils.profiling import StepTimer, trace

    print(args)
    device = common.resolve_device(args)
    print(f"[precision] {common.apply_matmul_precision(args)} on {device}")
    dataset, iterate = common.build_dataset(args)
    left, right = common.shard_bounds(args, len(dataset))
    attack = common.build_image_guided_attack(args, device)
    dtype = np.float16 if args.artifact_dtype == "float16" else np.float32
    timer = StepTimer(steps_per_call=args.step, clips_per_call=args.batch_size, device=device)
    with trace(args.profile):
        for step, batch in enumerate(iterate(dataset, args.batch_size, left, right)):
            print(f"Running {args.attack_method}, {step + 1}")
            with timer(clips=len(batch["labels"])):
                adv = attack(batch["clips"], batch["labels"], batch["names"])
            common.save_attack_outputs(args.adv_path, batch, adv, dtype=dtype)
    # one loss_info_{batch_index}.json per shard (reference: image_main.py:94)
    artifacts.save_loss_info(args.adv_path, attack.loss_info, args.batch_index)
    args.throughput = timer.summary()
    print(f"[summary] {args.throughput}")
    return args.adv_path


def main(argv=None) -> str:
    return run(arg_parse(argv))


if __name__ == "__main__":
    main()
