"""Experiment grid runner (reference C29: run_image_guided.py).

PyTorch counterpart of :mod:`i2v_tpu.cli.run_grid`: the papers' tables as
in-process config sweeps, each experiment a (generate, evaluate) pair over
the port's CLI mains, replacing the reference's ``os.system`` shell loops
(run_image_guided.py:42-100). Grids:

  steps_ablation   Fig 4: steps × step_size          (run_image_guided.py:45-52)
  layer_ablation   Table 2 / Fig 5: model × depth    (run_image_guided.py:54-60)
  kinetics_perf    Table 3: DR/I2V per model + ENS   (run_image_guided.py:62-80)
  ucf101_perf      Table 4: UCF-101 equivalents      (run_image_guided.py:82-100)

Flags it does not know go to every generate call; ``--tiny``, ``--device``
and ``--matmul_precision`` among them also go to every evaluate call, so
that a ``--device cpu`` grid evaluates on the CPU too.

    python -m i2v_tpu_torch.cli.run_grid layer_ablation --limit 1 --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from . import evaluate, evaluate_ucf101, image_main, image_main_ucf101

# canonical per-model depths (reference: run_image_guided.py:67-70,87-90)
BEST_DEPTH = {"resnet": 2, "squeezenet": 2, "vgg": 3, "alexnet": 3}


@dataclasses.dataclass
class Grid:
    """One grid run's settings. ``fused``: route every config through the
    fused generate+evaluate path (``--fused_eval``) instead of the artifact
    round trip; ``single_pass``: offline evaluations read and upload each
    artifact batch once for all six models; ``left``: configs still allowed
    under ``--limit`` (None: no limit)."""

    passthrough: list
    fused: Optional[str] = None
    single_pass: bool = False
    left: Optional[int] = None

    def eval_extra(self) -> list:
        extra = ["--tiny"] if "--tiny" in self.passthrough else []
        if self.single_pass:
            extra.append("--single_pass")
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("--device")
        p.add_argument("--matmul_precision")
        known, _ = p.parse_known_args(self.passthrough)
        for flag in ("device", "matmul_precision"):
            if getattr(known, flag) is not None:
                extra += [f"--{flag}", getattr(known, flag)]
        return extra

    def gen_and_eval(self, gen_main, eval_main, gen_args, run_name):
        if self.left is not None:
            if self.left <= 0:
                return None
            self.left -= 1
        print(f"[grid] {run_name}", flush=True)
        gen_args = [*gen_args, *self.passthrough]
        if self.fused is not None:
            return gen_main(gen_args + ["--fused_eval", self.fused])
        adv_path = gen_main(gen_args)
        eval_main(["--adv_path", adv_path, *self.eval_extra()])
        return adv_path


def steps_ablation(grid: Grid):
    # Fig-4 grid points as published (run_image_guided.py:46-47)
    for steps in (20, 40, 60, 80, 100):
        for step_size in (0.001, 0.0025, 0.0050, 0.0075, 0.010):
            grid.gen_and_eval(
                image_main.main, evaluate.main,
                ["--attack_method", "ImageGuidedFMDirection_Adam",
                 "--direction_image_model", "resnet", "--depth", "2",
                 "--step", str(steps), "--step_size", str(step_size),
                 "--file_prefix", f"ablation_{steps}_{step_size}"],
                f"steps_{steps}_{step_size}")


def layer_ablation(grid: Grid):
    for model in ("resnet", "vgg", "squeezenet", "alexnet"):
        for depth in (1, 2, 3, 4):
            grid.gen_and_eval(
                image_main.main, evaluate.main,
                ["--attack_method", "ImageGuidedFMDirection_Adam",
                 "--direction_image_model", model, "--depth", str(depth),
                 "--step", "60", "--step_size", "0.005",
                 "--file_prefix", f"layers_{model}_{depth}"],
                f"layer_{model}_{depth}")


def _perf(grid: Grid, gen_main, eval_main, table: str):
    for model, depth in BEST_DEPTH.items():
        for method in ("ImageGuidedStd_Adam", "ImageGuidedFMDirection_Adam"):
            grid.gen_and_eval(
                gen_main, eval_main,
                ["--attack_method", method, "--direction_image_model", model,
                 "--depth", str(depth), "--step", "60", "--step_size", "0.005",
                 "--file_prefix", f"{table}_{method}_{model}"],
                f"{table}_{method}_{model}")
    grid.gen_and_eval(
        gen_main, eval_main,
        ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--step", "60",
         "--file_prefix", f"{table}_ens"],
        f"{table}_ens")


def kinetics_perf(grid: Grid):
    _perf(grid, image_main.main, evaluate.main, "table3")


def ucf101_perf(grid: Grid):
    _perf(grid, image_main_ucf101.main, evaluate_ucf101.main, "table4")


GRIDS = {
    "steps_ablation": steps_ablation,
    "layer_ablation": layer_ablation,
    "kinetics_perf": kinetics_perf,
    "ucf101_perf": ucf101_perf,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="paper-reproduction grid runner")
    p.add_argument("grid", choices=sorted(GRIDS))
    p.add_argument("--limit", type=int, default=None,
                   help="run only the first N grid configs (smoke runs)")
    p.add_argument("--fused", nargs="?", const="all", default=None,
                   metavar="MODELS",
                   help="run each grid config through the fused "
                        "generate+evaluate path (--fused_eval) instead of "
                        "the two-stage artifact round trip; optional "
                        "comma-separated eval-model subset (default all)")
    p.add_argument("--eval_single_pass", action="store_true",
                   help="offline evals read + upload each artifact batch "
                        "once for all six models (evaluate --single_pass); "
                        "no effect under --fused (already single-ingress)")
    args, passthrough = p.parse_known_args(argv)
    # a fresh Grid per call: every main() gets its own --limit budget
    GRIDS[args.grid](Grid(passthrough, fused=args.fused,
                          single_pass=args.eval_single_pass, left=args.limit))


if __name__ == "__main__":
    main()
