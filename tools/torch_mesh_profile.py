"""Time the port's multi-device paths against one card, in one process.

    python tools/torch_mesh_profile.py [--steps 3] [--out outputs/mesh_profile.json]

At full width (32x224^2 clips, random weights), float32 with TF32 off, and
at the reference's batch of 16 clips, over every card of the machine:

  1. ENS-I2V (the four surrogates at their production depths) through the
     frame-chunked runner on cuda:0 alone (``frame_chunk="auto"``), the
     one-card yardstick;
  2. the same through the mesh runner over ``attack_mesh()`` of every card
     (``image_main --sharded``), ``frame_chunk="auto"``;
  3. the same through the model-axis runner over ``ensemble_mesh()``
     (``image_main --model_parallel N``, N the widest of 4, 2, 1 that
     divides the card count), each position chunking its own slice;
  4. the six video models over four batches of 16 synthetic artifacts in
     one pass (``cli.evaluate --single_pass``), on cuda:0 alone and cut over
     ``attack_mesh()`` (``--data_parallel``), the artifacts read and
     uploaded in each.

Each runner path makes a warm-up call, then a timed one on the host's clock
around work that ends when every card is synchronized: steps/s, clips/s,
each card's peak memory, and when the call gave the host back; the
evaluations likewise (clips/s; the replicas of the models on the other
cards are made at the first pass and kept with the models, as an
evaluation run keeps them). It
prints one line a path and writes every number, with the card's name and
power limit and the card count, into ``--out``. It needs a card and exits
without one.

    python tools/torch_mesh_profile.py --trace DIR

also traces one more call of each runner path with ``torch.profiler``
(``DIR/{path}.json.gz``) and prints, for each card, its kernels' busy time
and the span from its first kernel to its last, the share of the call's
wall during which two or more cards ran kernels at once, and the host time
spent in CUDA runtime calls that wait for the device.

    python tools/torch_mesh_profile.py --bim [--steps 10]

instead times white-box data parallelism: BIM on full-width I3D-R50 at B=4
on cuda:0 alone and over ``attack_mesh(data=4)`` of four cards (or of
cuda:0 four times on a machine with fewer), each with its steps eager
(``graphs=False``) and as replayed CUDA graphs, in turns (eager, graphed,
graphed, eager), a warm-up call and the best of two timed calls each.

    python tools/torch_mesh_profile.py --model_axis [--steps 3]

times the model-axis runner the same way: ENS-I2V at B=16 over
``ensemble_mesh(model=4)`` of four cards (or of cuda:0 four times),
``frame_chunk="auto"``, eager and graphed in turns.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLIPS = 16
EVAL_BATCHES = 4
ENS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _timed(fn) -> tuple[float, float, dict]:
    """(seconds, seconds until ``fn`` returned to the host, peak GiB by card)
    of ``fn()`` after a warm-up call."""
    fn()
    _sync_all()
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    _sync_all()
    seconds = time.perf_counter() - t0
    return seconds, host, {f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 2**30
                           for i in range(torch.cuda.device_count())}


# CUDA runtime calls during which the host waits for the device
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaMalloc", "cudaFree")


def trace_summary(events: list) -> dict:
    """Per-card kernel busy time and span, the share of the kernels' span
    with two or more cards busy, and the host's blocking runtime time (ms),
    from a Chrome trace's events."""
    by_card: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_card.setdefault(e["args"].get("device"), []).append((e["ts"], e["ts"] + e["dur"]))
    cards = {}
    edges = []
    for card, spans in sorted(by_card.items(), key=lambda kv: str(kv[0])):
        spans.sort()
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        cards[str(card)] = {"busy_ms": busy / 1e3, "span_ms": (merged[-1][1] - merged[0][0]) / 1e3,
                            "kernels": len(spans)}
        edges += [(a, 1) for a, _ in merged] + [(b, -1) for _, b in merged]
    edges.sort()
    depth, last, overlap = 0, None, 0.0
    for t, d in edges:
        if depth >= 2:
            overlap += t - last
        depth, last = depth + d, t
    start = min((a for a, _ in edges), default=0)
    end = max((a for a, _ in edges), default=0)
    blocking = sum(e["dur"] for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name", "").startswith(BLOCKING))
    return {"cards": cards, "overlap_share": overlap / max(end - start, 1),
            "host_blocking_ms": blocking / 1e3}


def _traced(fn, path: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync_all()
    raw = path[:-len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as f, gzip.open(path, "wb") as g:
        g.write(f.read())
    with open(raw) as f:
        events = json.load(f)["traceEvents"]
    os.remove(raw)
    return trace_summary(events)


def bim_rows(result: dict, steps: int) -> None:
    """BIM at B=4, one card and over a four-position data mesh, eager and
    graphed in turns."""
    from i2v_tpu_torch import attacks
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.models import get_video_model
    from i2v_tpu_torch.ops import kernels
    from i2v_tpu_torch.parallel import attack_mesh, shard_clips

    n = torch.cuda.device_count()
    ds = synthetic.SyntheticAttackDataset(n_samples=4)
    videos = np.stack([ds[i][0] for i in range(4)])
    labels = np.arange(4)
    bundle = get_video_model("i3d_resnet50", device="cuda:0")
    cards = [torch.device("cuda", i) for i in range(4)] if n >= 4 else [torch.device("cuda", 0)] * 4
    for where, mesh in (("one card", None), (f"attack_mesh(data=4) over {cards}",
                                             attack_mesh(cards, data=4))):
        for graphs in (False, True, True, False):
            atk = attacks.BIM(bundle, steps=steps, graphs=graphs)
            batch = videos if mesh is None else shard_clips(videos, mesh)
            atk(batch, labels)
            walls = []
            for _ in range(2):
                _sync_all()
                kernels.reset_launches()
                t0 = time.perf_counter()
                atk(batch, labels)
                _sync_all()
                walls.append(time.perf_counter() - t0)
            name = f"BIM B=4 {where}, {'graphed' if graphs else 'eager'}"
            row = result["paths"].setdefault(name, {"steps_per_s": []})
            row["steps_per_s"].append(steps / min(walls))
            print(f"[mesh profile] {name}: {steps / min(walls):.4f} steps/s (best of "
                  f"{[round(w, 4) for w in walls]} s), K3 {kernels.launches['sign_step']} a call")


def model_axis_rows(result: dict, steps: int) -> None:
    """ENS-I2V at B=16 through the model-axis runner, eager and graphed in
    turns."""
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.models import get_image_models
    from i2v_tpu_torch.ops import kernels
    from i2v_tpu_torch.parallel import ensemble

    n = torch.cuda.device_count()
    ds = synthetic.SyntheticAttackDataset(n_samples=CLIPS)
    clean01 = torch.from_numpy(np.stack([ds.clip01(i) for i in range(CLIPS)])).cuda()
    surr = get_image_models(list(ENS), ENS, device="cuda:0")
    cards = [torch.device("cuda", i) for i in range(4)] if n >= 4 else [torch.device("cuda", 0)] * 4
    mesh = ensemble.ensemble_mesh(cards, model=4)
    for graphs in (False, True, True, False):
        runner = ensemble.make_ensemble_parallel_runner(surr, mesh, steps=steps,
                                                        frame_chunk="auto", graphs=graphs)
        runner(clean01)
        walls = []
        for _ in range(2):
            _sync_all()
            kernels.reset_launches()
            t0 = time.perf_counter()
            runner(clean01)
            _sync_all()
            walls.append(time.perf_counter() - t0)
        name = f"ENS B={CLIPS} --model_parallel 4 over {cards}, {'graphed' if graphs else 'eager'}"
        row = result["paths"].setdefault(name, {"steps_per_s": []})
        row["steps_per_s"].append(steps / min(walls))
        print(f"[mesh profile] {name}: {steps / min(walls):.4f} steps/s (best of "
              f"{[round(w, 4) for w in walls]} s), K1/K2 {kernels.launches['rebuild_fwd']}/"
              f"{kernels.launches['rebuild_bwd']} a call")
        del runner


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3, help="Adam steps a runner call")
    p.add_argument("--out", default=os.path.join("outputs", "mesh_profile.json"))
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="also trace one call of each runner path into DIR")
    p.add_argument("--bim", action="store_true",
                   help="time BIM at B=4 on one card and over a data mesh, eager and graphed")
    p.add_argument("--model_axis", action="store_true",
                   help="time ENS at B=16 over the model axis, eager and graphed")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_mesh_profile: no CUDA device is available")
    from i2v_tpu_torch.cli import common
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.eval import transfer
    from i2v_tpu_torch.models import get_image_models, get_video_model
    from i2v_tpu_torch.ops import pixel
    from i2v_tpu_torch.parallel import attack_mesh, ensemble, sharded
    from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES, artifacts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    n = torch.cuda.device_count()
    result = {"cards": smi.stdout.strip().splitlines(), "count": n, "clips": CLIPS,
              "steps": args.steps, "precision": common.apply_matmul_precision(
                  argparse.Namespace(matmul_precision="float32")), "paths": {}}
    print(f"[mesh profile] {n} card(s): {result['cards']}")
    if args.bim or args.model_axis:
        (bim_rows if args.bim else model_axis_rows)(result, args.steps)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        return result
    ds = synthetic.SyntheticAttackDataset(n_samples=CLIPS)
    clean01 = torch.from_numpy(np.stack([ds.clip01(i) for i in range(CLIPS)])).cuda()
    surr = get_image_models(list(ENS), ENS, device="cuda:0")
    model_axis = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    runners = {
        "ENS one card": sharded.make_sharded_i2v_runner(surr, steps=args.steps,
                                                        frame_chunk="auto"),
        f"ENS --sharded over {n} card(s)": sharded.make_sharded_i2v_runner(
            surr, attack_mesh(), steps=args.steps, frame_chunk="auto"),
        f"ENS --model_parallel {model_axis} over {n} card(s)":
            ensemble.make_ensemble_parallel_runner(
                surr, ensemble.ensemble_mesh(model=model_axis), steps=args.steps,
                frame_chunk="auto"),
    }
    for name, runner in runners.items():
        seconds, host, peaks = _timed(lambda r=runner: r(clean01))
        result["paths"][name] = {"seconds": seconds, "host_return_s": host,
                                 "steps_per_s": args.steps / seconds,
                                 "clips_per_s": CLIPS / seconds, "peak_gib": peaks}
        print(f"[mesh profile] {name}: {args.steps / seconds:.4f} steps/s, "
              f"{CLIPS / seconds:.4f} clips/s ({seconds:.3f} s, the host back after "
              f"{host:.3f} s), peaks {peaks}")
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
            slug = "".join(c if c.isalnum() else "_" for c in name)
            summary = _traced(lambda r=runner: r(clean01),
                              os.path.join(args.trace, f"{slug}.json.gz"))
            result["paths"][name]["trace"] = summary
            print(f"[mesh profile] {name}, traced: {summary}")
    del runners, surr
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(0)
        for k in range(EVAL_BATCHES):
            noise = rng.rand(CLIPS, 3, 32, 224, 224).astype(np.float32)
            artifacts.save_batch(tmp, list(range(k * CLIPS, (k + 1) * CLIPS)),
                                 pixel.normalize(torch.from_numpy(noise), 1).numpy())
        files = artifacts.batch_files(artifacts.list_adv_files(tmp), CLIPS)
        n_eval = EVAL_BATCHES * CLIPS
        bundles = {m: get_video_model(m, device="cuda:0") for m in VIDEO_MODEL_NAMES}
        for name, mesh in (("eval single pass one card", None),
                           (f"eval single pass --data_parallel over {n} card(s)",
                            attack_mesh())):
            seconds, _, peaks = _timed(lambda m=mesh: transfer.single_pass_eval(
                bundles, files, tmp, mesh=m, log=lambda *_: None))
            result["paths"][name] = {"seconds": seconds, "clips": n_eval,
                                     "clips_per_s": n_eval / seconds, "peak_gib": peaks}
            print(f"[mesh profile] {name}: {n_eval / seconds:.4f} clips/s ({n_eval} clips in "
                  f"{seconds:.3f} s), peaks {peaks}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
