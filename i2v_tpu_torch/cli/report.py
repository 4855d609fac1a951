"""Aggregate per-run eval reports into one attack-success-rate table.

PyTorch-package counterpart of :mod:`i2v_tpu.cli.report`, with the same
output bytes. The reference leaves table assembly to the reader: each
generate→evaluate cycle drops a ``top1_acc_all_models.json`` in its run dir
(reference.py:127-129) and the papers' tables are assembled by hand. This
collects every run under the artifact root (or an explicit list) into one
CSV/markdown table of ASR = 100 − top-1 (the papers' metric). It reads JSON
only and needs no device.

    python -m i2v_tpu_torch.cli.report                 # all runs under OPT_PATH
    python -m i2v_tpu_torch.cli.report --runs dirA dirB --format markdown
    python -m i2v_tpu_torch.cli.report --merge_shards RUN   # fused shards → one report
"""

from __future__ import annotations

import argparse
import json
import os

from ..utils import get_paths


def collect(run_dirs, warn_missing: bool = False) -> tuple[list[str], list[dict]]:
    """Read top1 JSONs → (sorted model names, per-run {run, model: asr}).

    ``warn_missing``: print a note for a run without a report instead of
    dropping it silently (explicit --runs entries are user intent; a typo
    should not just produce a shorter table)."""
    rows = []
    models: set[str] = set()
    for d in run_dirs:
        path = os.path.join(d, "top1_acc_all_models.json")
        if not os.path.exists(path):
            if warn_missing:
                print(f"[report] skipping {d!r}: no top1_acc_all_models.json "
                      "(not evaluated yet, or a typo?)")
            continue
        with open(path) as f:
            top1 = json.load(f)
        row = {"run": os.path.basename(os.path.normpath(d))}
        for name, acc in top1.items():
            row[name] = round(100.0 - float(acc), 2)  # ASR
            models.add(name)
        rows.append(row)
    return sorted(models), rows


def render(models, rows, fmt: str) -> str:
    header = ["run"] + models
    lines = []
    if fmt == "markdown":
        lines.append("| " + " | ".join(header) + " |")
        lines.append("|" + "---|" * len(header))
        for r in rows:
            lines.append("| " + " | ".join(
                str(r.get(k, "")) for k in header) + " |")
    else:  # csv
        lines.append(",".join(header))
        for r in rows:
            lines.append(",".join(str(r.get(k, "")) for k in header))
    return "\n".join(lines)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="ASR table aggregator")
    p.add_argument("--runs", nargs="*", default=None,
                   help="run dirs (default: every dir under OPT_PATH)")
    p.add_argument("--format", choices=["csv", "markdown"], default="csv")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.add_argument("--merge_shards", default=None, metavar="RUN_DIR",
                   help="merge a sharded fused run's suffixed reports "
                        "(results_all_models_prediction_<k>.csv / "
                        "top1_acc_all_models_<k>.json) into the plain "
                        "reference-schema files, then exit")
    args = p.parse_args(argv)
    if args.merge_shards:
        from ..eval.fused import merge_shard_reports

        d = args.merge_shards
        if not os.path.isabs(d) and not os.path.isdir(d):
            d = os.path.join(get_paths().opt_path, d)
        acc = merge_shard_reports(d)
        print(json.dumps(acc))
        return json.dumps(acc)

    runs = args.runs
    explicit = runs is not None
    if runs is None:
        root = get_paths().opt_path
        runs = sorted(
            os.path.join(root, d) for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
    else:
        # bare run NAMES resolve under OPT_PATH, like evaluate's --adv_path
        opt = get_paths().opt_path
        runs = [r if os.path.isabs(r) or os.path.isdir(r)
                else os.path.join(opt, r) for r in runs]
    models, rows = collect(runs, warn_missing=explicit)
    if not rows:
        raise SystemExit("no top1_acc_all_models.json found in the given runs")
    table = render(models, rows, args.format)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
        print(f"wrote {args.out}")
    else:
        print(table)
    return table


if __name__ == "__main__":
    main()
