"""Run the 400-clip fused generate→evaluate end to end on one CUDA card, with
a hard kill partway and a resume.

PyTorch counterpart of ``tools/e2e_400.py``, with its names. It runs the
reference's production unit of work (run_image_guided.py:62-80: attack the
400 Kinetics-400 clips, then evaluate them) through the port's fused
pipeline, artifact protocol and resume:

  phase A:  python tools/torch_e2e_400.py --kill_after_batches 18
            (``os._exit(137)`` after that many batches: a lost worker, with
             no writer drain and no finalize; artifact writes are atomic, so
             the run directory holds only complete artifacts)
  phase B:  python tools/torch_e2e_400.py --resume
            (the labels on disk are re-scored through the resident video
             models, ``FusedGenerateEvaluate.process_artifacts``; only the
             missing labels are attacked; finalize writes complete reports)

The configuration is JAX's: uint8 clips through the runner's u8 ingress
(``ops/pixel.ingest_u8_clips``), the four ENS surrogates in bf16 with bf16
weight storage, 60 Adam steps, ``frame_chunk=256`` (one chunk at B=8), float16
artifacts written off the main thread, the six video models in bf16, B=8.
The runner is ``parallel/sharded.py``'s on ``--device`` alone. ``--clips``,
``--batch`` and ``--steps`` (400, 8, 60, JAX's ``N_CLIPS``, ``BATCH`` and
``STEPS``) cut the run down.

Each batch appends a progress mark to ``<run_dir>/e2e_progress.jsonl``; the
marks survive the kill, so phase A's wall clock is measured. ``--resume``
ends with ``summarize``: ``E2E_400_TORCH.json`` and an ``exec_e2e400`` row
of ``PERF_PROBE_TORCH.json`` (``tools/torch_perf_probe.record``), both in
``--out_dir`` (default: the repo root). ``--summarize_only`` writes them
from an existing run directory. Every phase prints one line, and each
process prints its launches of the hand-written kernels as its last line
(phase A just before the kill). It needs a card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ARTIFACT = "E2E_400_TORCH.json"
ENS_NAMES = ["resnet", "vgg", "squeezenet", "alexnet"]
ENS_DEPTHS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
N_CLIPS = 400  # the reference's Kinetics attack set: one clip per class
BATCH = 8
STEPS = 60


def synth_u8_batch(labels) -> np.ndarray:
    """Deterministic per-label uint8 clips (32,224,224,3), the datasets' raw
    decoded form, the bytes of ``tools/e2e_400.py``'s: each label's own
    ``RandomState(10_000 + label)``, so phase A and phase B see the same
    clips, and 28² noise repeated into 8x8 blocks, so the surrogates' early
    taps are driven as by real frames."""
    out = np.empty((len(labels), 32, 224, 224, 3), dtype=np.uint8)
    for i, lab in enumerate(labels):
        rng = np.random.RandomState(10_000 + int(lab))
        base = rng.randint(0, 256, (32, 28, 28, 3), dtype=np.uint8)
        out[i] = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)
    return out


def mark(run_dir: str, **payload) -> None:
    payload["ts"] = round(time.time(), 2)
    with open(os.path.join(run_dir, "e2e_progress.jsonl"), "a") as f:
        f.write(json.dumps(payload) + "\n")


def read_marks(run_dir: str) -> list:
    path = os.path.join(run_dir, "e2e_progress.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def build_pipeline(run_dir: str, args):
    from i2v_tpu_torch.eval.fused import FusedGenerateEvaluate
    from i2v_tpu_torch.models import get_image_models, get_video_model
    from i2v_tpu_torch.models.video_zoo import VIDEO_BUILDERS
    from i2v_tpu_torch.parallel.sharded import ShardedImageGuidedAttack

    device = args.device
    surrogates = get_image_models(ENS_NAMES, ENS_DEPTHS, device=device, dtype=torch.bfloat16)
    attack = ShardedImageGuidedAttack(surrogates, steps=args.steps, step_size=0.005,
                                      frame_chunk=256, param_dtype=torch.bfloat16)
    names = list(VIDEO_BUILDERS)
    print(f"[e2e400] eval models ({len(names)}): {names}", flush=True)
    bundles = {n: get_video_model(n, device=device, dtype=torch.bfloat16) for n in names}
    return FusedGenerateEvaluate(attack, bundles, run_dir=run_dir, n_classes=args.clips,
                                 artifact_dtype=np.float16)


def _print_launches(phase: str) -> None:
    from i2v_tpu_torch.ops import kernels

    print(f"[e2e400:{phase}] launches {json.dumps(kernels.launches)}", flush=True)


def run(args) -> None:
    from i2v_tpu_torch.utils import artifacts

    os.makedirs(args.run_dir, exist_ok=True)
    phase = "B" if args.resume else "A"
    existing = sorted(artifacts.existing_labels(args.run_dir))
    missing = [lab for lab in range(args.clips) if lab not in set(existing)]
    print(f"[e2e400:{phase}] {len(existing)} labels on disk, "
          f"{len(missing)} to attack", flush=True)
    t_setup = time.time()
    fused = build_pipeline(args.run_dir, args)
    mark(args.run_dir, phase=phase, event="setup",
         setup_s=round(time.time() - t_setup, 2))

    t_phase = time.time()
    if args.resume and existing:
        files = artifacts.list_adv_files(args.run_dir)
        for chunk in artifacts.batch_files(files, args.batch):
            fused.process_artifacts(chunk)
        mark(args.run_dir, phase=phase, event="rescored",
             clips=len(existing), wall_s=round(time.time() - t_phase, 2))
        print(f"[e2e400:B] re-scored {len(existing)} artifacts in "
              f"{time.time() - t_phase:.1f}s", flush=True)

    t_attack = time.time()
    batches = [missing[i:i + args.batch] for i in range(0, len(missing), args.batch)]
    for bi, labels in enumerate(batches):
        fused.process_batch({
            "clips": synth_u8_batch(labels),
            "labels": np.asarray(labels, dtype=np.int64),
            "names": [f"clip{lab}" for lab in labels],
        })
        mark(args.run_dir, phase=phase, event="batch", batch=bi,
             clips_done=(bi + 1) * len(labels),
             wall_s=round(time.time() - t_attack, 2))
        if bi == 0:
            print(f"[e2e400:{phase}] first batch (cuDNN set-up + run) "
                  f"{time.time() - t_attack:.1f}s", flush=True)
        if args.kill_after_batches and bi + 1 >= args.kill_after_batches:
            # a hard worker loss: no writer drain, no finalize, no atexit:
            # exactly what the resume must survive
            print(f"[e2e400:A] hard kill after batch {bi + 1} "
                  f"({time.time() - t_attack:.1f}s)", flush=True)
            _print_launches(phase)
            os._exit(137)
    attack_wall = time.time() - t_attack

    t_fin = time.time()
    acc = fused.finalize(report_dir=args.run_dir)
    fin_wall = time.time() - t_fin
    mark(args.run_dir, phase=phase, event="finalized",
         attack_wall_s=round(attack_wall, 2),
         finalize_wall_s=round(fin_wall, 2))
    print(f"[e2e400:{phase}] attack {attack_wall:.1f}s, finalize "
          f"{fin_wall:.1f}s, top1 {acc}", flush=True)

    if args.resume:
        summarize(args)
    _print_launches(phase)


def _read_reports(run_dir: str):
    """→ (model columns, rows of ints) of the CSV report, and the top-1 JSON."""
    with open(os.path.join(run_dir, "results_all_models_prediction.csv"), newline="") as f:
        rows = list(csv.reader(f))
    with open(os.path.join(run_dir, "top1_acc_all_models.json")) as f:
        acc = json.load(f)
    header, body = rows[0], [[int(c) for c in r] for r in rows[1:]]
    model_cols = [i for i, c in enumerate(header) if c.endswith("-pre")]
    return model_cols, body, acc


def summarize(args) -> dict:
    """Assemble ``E2E_400_TORCH.json`` from the surviving progress marks and
    the reports, with ``tools/e2e_400.py``'s accounting."""
    from i2v_tpu_torch.utils import artifacts

    from tools.torch_perf_probe import card_info, record

    marks = read_marks(args.run_dir)
    a = [m for m in marks if m["phase"] == "A"]
    b = [m for m in marks if m["phase"] == "B"]
    a_batches = [m for m in a if m["event"] == "batch"]
    # phase A wall: setup + the last surviving batch mark (the batch in
    # flight at the kill is not measured)
    a_setup = sum(m["setup_s"] for m in a if m["event"] == "setup")
    a_wall = a_setup + (a_batches[-1]["wall_s"] if a_batches else 0.0)
    b_setup = sum(m["setup_s"] for m in b if m["event"] == "setup")
    b_rescore = next((m for m in b if m["event"] == "rescored"), {})
    b_fin = next((m for m in b if m["event"] == "finalized"), {})
    b_wall = (b_setup + b_rescore.get("wall_s", 0.0)
              + b_fin.get("attack_wall_s", 0.0)
              + b_fin.get("finalize_wall_s", 0.0))

    # the steady attack+eval rate from consecutive batch marks (the first
    # batch of each phase excluded: it pays cuDNN's set-up)
    def _steady(batches):
        if len(batches) < 3:
            return None
        dt = batches[-1]["wall_s"] - batches[0]["wall_s"]
        return round(args.batch * (len(batches) - 1) / dt, 3) if dt > 0 else None

    b_batches = [m for m in b if m["event"] == "batch"]
    steady_a = _steady(a_batches)
    steady = _steady(b_batches) or steady_a

    n_artifacts = len(artifacts.list_adv_files(args.run_dir))
    model_cols, rows, acc = _read_reports(args.run_dir)
    covered = sum(all(r[i] != -1 for i in model_cols) for r in rows)

    total = round(a_wall + b_wall, 1)
    card = card_info()
    out = {
        "executed": True,
        "config": (f"u8 ingress, bf16 ENS {args.steps} steps frame_chunk=256, async f16 "
                   f"artifacts, 6 video models bf16, B={args.batch}: tools/e2e_400.py's "
                   "configuration, on the port's runner on one device"),
        "clips": args.clips,
        "batch": args.batch,
        "steps": args.steps,
        "phase_a": {
            "setup_s": round(a_setup, 1),
            "batches_completed": len(a_batches),
            "clips_attacked": (a_batches[-1]["clips_done"] if a_batches else 0),
            "wall_s": round(a_wall, 1),
            "killed": "hard os._exit after the last recorded batch mark; "
                      "the in-flight batch at the kill is unmeasured",
        },
        "phase_b": {
            "setup_s": round(b_setup, 1),
            "rescored_clips": b_rescore.get("clips", 0),
            "rescore_wall_s": b_rescore.get("wall_s", 0.0),
            "attack_wall_s": b_fin.get("attack_wall_s", 0.0),
            "finalize_wall_s": b_fin.get("finalize_wall_s", 0.0),
            "wall_s": round(b_wall, 1),
        },
        "total_measured_wall_s": total,
        "clips_per_s_end_to_end": round(args.clips / total, 3),
        "steady_state_clips_per_s": steady,
        "steady_state_clips_per_s_phase_a": steady_a,
        "artifact_count": n_artifacts,
        "report_rows": len(rows),
        "labels_fully_covered": covered,
        "top1_acc": acc,
        "card": card,
        "torch": torch.__version__,
        "note": ("the measured total holds two process set-ups (model builds and "
                 "cuDNN's first calls), the kill, and the resume's re-score of the "
                 "artifacts on disk; the steady rates are the attack+evaluate rate "
                 "between batch marks, each phase's first batch excluded"),
    }
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, ARTIFACT)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    record("exec_e2e400", {
        "executed": True,
        "total_measured_wall_s": total,
        "clips_per_s_end_to_end": out["clips_per_s_end_to_end"],
        "steady_state_clips_per_s": steady,
        "steady_state_clips_per_s_phase_a": steady_a,
        "artifact_count": n_artifacts,
        "labels_fully_covered": covered,
        "detail": ARTIFACT,
    }, os.path.join(args.out_dir, "PERF_PROBE_TORCH.json"))
    print(json.dumps(out, indent=1), flush=True)
    return out


def arg_parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", default=os.path.join(ROOT, "outputs", "e2e400"))
    ap.add_argument("--kill_after_batches", type=int, default=0,
                    help="phase A: os._exit after this many attack batches")
    ap.add_argument("--resume", action="store_true",
                    help="phase B: re-score existing artifacts, attack missing labels, "
                         "write full reports + E2E_400_TORCH.json")
    ap.add_argument("--summarize_only", action="store_true")
    ap.add_argument("--clips", type=int, default=N_CLIPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out_dir", default=ROOT,
                    help="where E2E_400_TORCH.json and PERF_PROBE_TORCH.json go")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); exits without a card")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = arg_parse(argv)
    if args.summarize_only:
        summarize(args)
        return
    from i2v_tpu_torch.cli import common

    args.device = common.resolve_device(args)
    run(args)


if __name__ == "__main__":
    main()
