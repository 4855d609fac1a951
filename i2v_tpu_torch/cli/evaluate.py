"""Transfer-evaluation CLI, Kinetics-400 (reference C27: reference.py).

    python -m i2v_tpu_torch.cli.evaluate --adv_path <run-dir-or-name>

Runs every ``*adv*.npy`` artifact of the run directory through the six video
models (or ``--models``, which may name Video Swin-B, ``swin3d_b``,
MViTv2-B, ``mvit_v2_b``, and UniFormer-B, ``uniformer_b``) and
writes ``results_all_models_prediction.csv`` and
``top1_acc_all_models.json`` into it, with the JAX CLI's schemas. Attack
success rate = 100 − top-1. ``--bf16`` builds the models to compute in
bfloat16. ``--data_parallel`` cuts each batch over every card of the process
(with ``--device cpu``: over the CPU alone). ``--device`` defaults to
``cuda`` and stops without a card; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..eval import evaluate_run
from ..utils import get_paths
from . import common


def arg_parse(argv=None, n_classes: int = 400):
    p = argparse.ArgumentParser(description="transfer evaluation")
    p.add_argument("--adv_path", required=True,
                   help="run directory, or a run name under I2V_TPU_OPT_PATH")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--models", nargs="*", default=None,
                   help="video models to evaluate (default: the reference's six; "
                        "swin3d_b, Video Swin-B, mvit_v2_b, MViTv2-B, and uniformer_b, "
                        "UniFormer-B, only where named)")
    p.add_argument("--ucf101", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="width-reduced video models (checkpoint-free runs)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 model compute (halves the eval's memory traffic; top-1 "
                        "can differ on borderline clips — default stays float32 for report "
                        "parity)")
    p.add_argument("--data_parallel", action="store_true",
                   help="cut each batch over every local card (data-parallel evaluation); a "
                        "batch that does not divide over them runs on one card")
    p.add_argument("--single_pass", action="store_true",
                   help="keep all models resident and run each uploaded batch through "
                        "every model: one artifact read and upload in all instead of "
                        "one per model (reference.py:108-125); identical reports")
    p.add_argument("--n_classes", type=int, default=None,
                   help=f"report rows (default: {n_classes}, or 101 with --ucf101, "
                        "the reference_ucf101.py:137 schema)")
    p.add_argument("--matmul_precision", default=None, choices=["default", "high", "float32"],
                   help="'float32' turns TF32 off for cuDNN and cuBLAS (the card-vs-CPU "
                        "parity numerics); unset keeps torch's defaults (TF32 convs)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    if args.n_classes is None:
        args.n_classes = 101 if args.ucf101 else n_classes
    if not os.path.isdir(args.adv_path):
        args.adv_path = os.path.join(get_paths().opt_path, args.adv_path)
    return args


def run(args, get_bundle=None) -> dict:
    """Evaluate and write the reports. Returns ``{model: top1}``; the
    clips/s of each model (or of the single pass) are printed and kept as
    ``args.throughput``. ``get_bundle(name)``, where given, supplies the
    models (a caller that evaluates twice builds each model once)."""
    print(args)
    device = common.resolve_device(args)
    print(f"[precision] {common.apply_matmul_precision(args)} on {device}")
    args.throughput = {}
    acc = evaluate_run(args.adv_path, model_names=args.models, batch_size=args.batch_size,
                       n_classes=args.n_classes, ucf101=args.ucf101, tiny=args.tiny,
                       dtype=torch.bfloat16 if args.bf16 else torch.float32,
                       get_bundle=get_bundle, device=device,
                       data_parallel=args.data_parallel, single_pass=args.single_pass,
                       throughput=args.throughput)
    print("[summary] " + "; ".join(
        f"{k}: {v['clips_per_sec']:.3f} clips/s ({v['clips']} clips in {v['elapsed_s']:.3f} s)"
        for k, v in args.throughput.items()))
    print(acc)
    return acc


def main(argv=None) -> dict:
    return run(arg_parse(argv))


if __name__ == "__main__":
    main()
