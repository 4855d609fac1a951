"""Run one benchmark cell once and print its result as the last line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace
of the window. Each number the check compared is printed beside its limit
as the last lines of standard error and under ``checks``, the line's last
key. Without a CUDA card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result; with JAX, Flax, Optax or the JAX package
loaded once the window has closed, with 3.

``--control tf32`` (``bf16``) computes the program's side with TF32 convs
and matmuls (in bfloat16): the lower-precision runs whose check must fail.
The cells' own runs never take it."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, "port_bench", "_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "bf16"), default=None)
    args = p.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    sys.path.insert(0, REPO)
    import torch

    from port_bench import harness

    bench = harness.Bench.at(REPO)
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda:0", t_start=T_START,
                           control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: loaded {bad} in the measuring process", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
