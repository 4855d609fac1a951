"""White-box attack CLI, Kinetics-400 (reference C22: attack.py).

    python -m i2v_tpu_torch.cli.attack --model i3d_resnet50 --attack_method BIM \
        --step 10 --data synthetic --device cuda

Writes ``{label}-adv.npy`` and ``{label}-ori.npy`` for each clip into
``OPT_PATH/{model}-{method}-{step}-{prefix}``, the same run directory the JAX
CLI (``i2v_tpu.cli.attack``) names for the same flags, and skips clips whose
pair is already there. :mod:`.attack_ucf101` runs the same flow with the
101-class heads.
"""

from __future__ import annotations

import argparse
import os

from ..models import get_video_model
from ..utils import artifacts, get_paths
from . import common


def arg_parse(argv=None, ucf101: bool = False):
    """The JAX CLI's flags and defaults; ``ucf101`` names the run directory
    ``UCF101_Video_{model}-…``, selects the 101-class heads and reads
    ``--data kinetics`` as ``ucf101``, as ``i2v_tpu.cli.attack_ucf101`` does."""
    p = argparse.ArgumentParser(
        description=f"white-box video attack ({'UCF-101' if ucf101 else 'Kinetics-400'})")
    p.add_argument("--model", default="i3d_resnet50",
                   help="one of the six video models: i3d_resnet50, i3d_resnet101, "
                        "slowfast_resnet50, slowfast_resnet101, tpn_resnet50, "
                        "tpn_resnet101")
    p.add_argument("--attack_type", default="image", choices=["image", "video"],
                   help="reference-CLI compatibility flag (attack.py:76-83); "
                        "dispatch here is by method name")
    p.add_argument("--attack_method", default="BIM", choices=common.WHITEBOX_METHODS)
    p.add_argument("--step", type=int, default=10)
    p.add_argument("--file_prefix", default="")
    # TemporalTranslation's parameters (reference: attack.py:13-61)
    p.add_argument("--kernlen", type=int, default=15)
    p.add_argument("--momentum", type=int, default=0)
    p.add_argument("--augmentation_weight", type=float, default=0.0)
    p.add_argument("--move_type", default="adj", choices=["adj", "large", "random"])
    p.add_argument("--kernel_mode", default="gaussian",
                   choices=["gaussian", "linear", "uniform", "random"])
    p.add_argument("--remat", action="store_true",
                   help="recompute the video model's bottlenecks (and I3D's stem) in "
                        "the backward pass instead of keeping their activations: "
                        "less memory, more compute, the same gradients")
    p.add_argument("--batch_chunk", type=int, default=None,
                   help="gradient-accumulate over clip-batch chunks of this size "
                        "(exact for the mean-CE attacks); holds one chunk's "
                        "activations at a time")
    p.add_argument("--sim_batch_scales", action="store_true",
                   help="SIM: fold the 5 scale copies into one batched forward and "
                        "backward (5x activation memory, one gradient query)")
    p.add_argument("--tt_chunk", type=int, default=5,
                   help="TemporalTranslation: shift variants a gradient query (the "
                        "reference sub-batches by 5, video_attacks.py:203-210); "
                        "more variants a query hold more activations")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace into this directory")
    common.add_data_args(p)
    args = p.parse_args(argv)
    args.ucf101 = ucf101
    if ucf101 and args.data == "kinetics":
        args.data = "ucf101"
    args.adv_path = os.path.join(
        get_paths().opt_path,
        artifacts.run_dir_name(f"UCF101_Video_{args.model}" if ucf101 else args.model,
                               args.attack_method, args.step,
                               common.effective_file_prefix(args)))
    return args


def run(args) -> str:
    """Attack every clip not yet attacked and write its adv and ori
    artifacts. The throughput summary is printed and kept as
    ``args.throughput``, the per-step costs as ``args.loss_info``."""
    from ..utils.profiling import StepTimer, trace

    print(args)
    device = common.resolve_device(args)
    print(f"[precision] {common.apply_matmul_precision(args)} on {device}")
    dataset, iterate = common.build_dataset(args)
    bundle = get_video_model(args.model, device=device, tiny=args.tiny,
                             ucf101=args.ucf101, remat=args.remat)
    attack = common.build_whitebox_attack(args, bundle)
    # a clip is done only when both artifacts exist: a crash between the
    # adv and ori writes must not leave its label without an ori for good
    done = (artifacts.existing_labels(args.adv_path)
            & artifacts.existing_labels(args.adv_path, "ori"))
    view = common.resume_subset(dataset, done)
    if view is not None:
        print(f"resume: {len(dataset) - len(view)} of {len(dataset)} "
              "samples already attacked; skipping their decode")
        dataset = view
    timer = StepTimer(steps_per_call=attack.steps, clips_per_call=args.batch_size,
                      device=device)
    with trace(args.profile):
        for step, batch in enumerate(
                common.batch_iterator(args, dataset, iterate, keep_host=True)):
            if all(int(label) in done for label in batch["labels"]):
                continue
            print(f"Running {args.attack_method}, {step + 1}")
            with timer(clips=len(batch["labels"])):
                adv = attack(batch["clips"], batch["labels"], batch["names"])
            common.save_attack_outputs(args.adv_path, batch, adv, save_ori=True)
    args.throughput = timer.summary()
    args.loss_info = attack.loss_info
    print(f"[summary] {args.throughput}")
    return args.adv_path


def main(argv=None) -> str:
    return run(arg_parse(argv))


if __name__ == "__main__":
    main()
