"""ILAF fine-tuning CLI (reference C26: image_fine_tune_attack.py).

    python -m i2v_tpu_torch.cli.fine_tune --used_adv <run> --model i3d_resnet50

Pairs ``{id}-adv.npy`` from --used_adv with ``{id}-ori.npy`` from --used_ori
(white-box runs write oris, image-guided runs do not: the reference README's
workflow), fine-tunes each clip on the white-box video model's mid-layer
features (:class:`..attacks.ILAF`) and writes the result into
``OPT_PATH/ILAF_{model}-ILAF-{step}-{prefix}``, the run directory the JAX CLI
(``i2v_tpu.cli.fine_tune``) names for the same flags. ``--device`` defaults
to ``cuda`` and stops without a card.
"""

from __future__ import annotations

import argparse
import os

from .. import attacks
from ..models import get_video_model, tap_keys_for
from ..utils import artifacts, get_paths
from . import common


def arg_parse(argv=None):
    p = argparse.ArgumentParser(description="ILAF fine-tuning")
    p.add_argument("--used_adv", required=True,
                   help="run dir containing {id}-adv.npy inputs")
    p.add_argument("--used_ori", default=None,
                   help="run dir containing {id}-ori.npy (defaults to used_adv)")
    p.add_argument("--model", default="i3d_resnet50")
    p.add_argument("--attack_method", default="ILAF", choices=["ILAF"],
                   help="kept for reference-CLI compatibility "
                        "(image_fine_tune_attack.py defines only ILAF)")
    p.add_argument("--step", type=int, default=60)
    p.add_argument("--step_size", type=float, default=0.005)
    p.add_argument("--file_prefix", default="")
    p.add_argument("--ucf101", action="store_true")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--matmul_precision", default=None, choices=["default", "high", "float32"],
                   help="'float32' turns TF32 off for cuDNN and cuBLAS; unset keeps "
                        "torch's defaults (TF32 convs)")
    p.add_argument("--device", default="cuda",
                   help="torch device to fine-tune on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    opt = get_paths().opt_path
    if not os.path.isabs(args.used_adv) and not os.path.isdir(args.used_adv):
        args.used_adv = os.path.join(opt, args.used_adv)
    args.used_ori = args.used_ori or args.used_adv
    if not os.path.isabs(args.used_ori) and not os.path.isdir(args.used_ori):
        args.used_ori = os.path.join(opt, args.used_ori)
    args.adv_path = os.path.join(
        opt, artifacts.run_dir_name(f"ILAF_{args.model}", "ILAF", args.step, args.file_prefix))
    return args


def iter_pairs(adv_dir: str, ori_dir: str, batch_size: int):
    """Paired (adv, ori, labels) batches keyed by sample id
    (reference: image_fine_tune_attack.py:16-37)."""
    advs = artifacts.list_adv_files(adv_dir, "adv")
    for chunk in artifacts.batch_files(advs, batch_size):
        adv, labels = artifacts.load_adv_batch(adv_dir, chunk)
        # the ori name through the protocol's helpers (a string .replace
        # would mangle a name with 'adv' elsewhere in it)
        ori_files = [artifacts.adv_filename(artifacts.label_of(f), "ori") for f in chunk]
        ori, _ = artifacts.load_adv_batch(ori_dir, ori_files)
        yield adv, ori, labels


def run(args) -> str:
    """Fine-tune every pair and write the results and ``loss_info_1.json``.
    The throughput summary is printed and kept as ``args.throughput``."""
    from ..utils.profiling import StepTimer

    print(args)
    advs = artifacts.list_adv_files(args.used_adv, "adv")
    if not advs:
        raise SystemExit(f"no {{id}}-adv.npy under {args.used_adv!r}")
    probe_ori = os.path.join(args.used_ori,
                             artifacts.adv_filename(artifacts.label_of(advs[0]), "ori"))
    if not os.path.exists(probe_ori):
        # fail before any model is built: image-guided runs write adv only
        # (image_main.py:90-92), so their directories have no oris to pair
        raise SystemExit(
            f"no ori artifact {probe_ori!r} — image-guided runs don't save oris; point "
            "--used_ori at a white-box run dir (attack.py saves both, reference README "
            "workflow)")
    device = common.resolve_device(args)
    print(f"[precision] {common.apply_matmul_precision(args)} on {device}")
    # built to the ILAF tap and no further: ILAF reads nothing past it
    bundle = get_video_model(args.model, device=device, tiny=args.tiny, ucf101=args.ucf101,
                             taps=tap_keys_for(args.model, "ilaf"), truncate=True)
    attack = attacks.ILAF(bundle, args.model, step_size=args.step_size, steps=args.step)
    timer = StepTimer(steps_per_call=args.step, clips_per_call=args.batch_size, device=device)
    for adv, ori, labels in iter_pairs(args.used_adv, args.used_ori, args.batch_size):
        with timer(clips=len(labels)):
            out = attack(adv, ori, labels, video_names=[str(label) for label in labels])
        artifacts.save_batch(args.adv_path, labels, out.detach().cpu().numpy())
    artifacts.save_loss_info(args.adv_path, attack.loss_info, 1)
    args.throughput = timer.summary()
    print(f"[summary] {args.throughput}")
    return args.adv_path


def main(argv=None) -> str:
    return run(arg_parse(argv))


if __name__ == "__main__":
    main()
