"""The cell runner: finds a cell's files by name, drives its entry through
set-up, the measured window and the check, and builds the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own under the benchmark's root, found by the name that
``BENCHMARK.json`` or the cell's file gives:

  workloads/<cell>.json     the entry it drives and why it exists
  configs/<config>.json     the configuration as it is run
  traffic/<traffic>.json    the traffic mix's parameters (:mod:`.traffic`)
  entries/<entry>.py        the code that drives one program entry point
  metrics/<metric>.py       ``read(ctx) -> float | None``, one a metric

The window runs whole units of work (a runner call, an evaluation sweep),
each ended by a device synchronize; a unit starts only while the window has
time left, and the window ends with the last unit."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Optional

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# compared with each loaded module's top-level name, whole: the port's own
# name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "i2v_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Bench:
    """``BENCHMARK.json`` and the benchmark's files under ``root``."""

    spec: dict
    root: str = ROOT

    @classmethod
    def at(cls, repo: str, root: str = ROOT) -> "Bench":
        return cls(load_json(os.path.join(repo, "BENCHMARK.json")), root)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return dict(w, **load_json(os.path.join(self.root, "workloads", f"{name}.json")))
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(os.path.dirname(self.root), c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.root, "traffic", f"{name}.json"))

    def _for(self, metric: dict, cell: str, reported: set) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves") in reported if "moves" in metric else True

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if self._for(m, cell, set())]

    def per_layer(self, cell: str) -> list:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"] if self._for(m, cell, reported)]

    def module(self, kind: str, name: str):
        """``<root>/<kind>/<name>.py``, loaded by its path (a metric's name
        may hold dots)."""
        path = os.path.join(self.root, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{name}", path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclasses.dataclass
class Context:
    """What a metric's reader may read: the window's counts and seconds,
    set-up, the peak, the card, the entry's work a count (FLOPs, kernel
    plans) and, in a traced run, the trace's :class:`~.trace.Summary`."""

    cell: dict
    config: dict
    setup_s: float
    window_s: float
    counts: dict
    peak_bytes: int
    card: str
    work: dict
    trace: Optional[object] = None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_float32_precision(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def numerics(config: dict, control: Optional[str]) -> tuple:
    """→ (the program's compute dtype, TF32 on) of a run: the configuration's
    ``precision`` and ``tf32``, or, for a control, the precision just below
    them that ``control`` names."""
    dtype, tf32 = DTYPES[config["precision"]], bool(config.get("tf32", False))
    if control == "tf32":
        if dtype != torch.float32 or tf32:
            raise ValueError("the tf32 control is for float32 configurations with TF32 off")
        tf32 = True
    elif control == "bf16":
        if dtype != torch.float32:
            raise ValueError("the bf16 control is for float32 configurations")
        dtype = torch.bfloat16
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    return dtype, tf32


def run_cell(bench: Bench, workload: str, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: Optional[dict] = None,
             control: Optional[str] = None, log=None) -> dict:
    """Run ``workload`` once on ``device`` → the result line's object."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = bench.workload(workload)
    config = dict(bench.config(cell["config"]), **(overrides or {}).get("config", {}))
    traffic = dict(bench.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {}))
    dtype, tf32 = numerics(config, control)
    set_float32_precision(tf32)
    entry = bench.module("entries", cell["entry"]).Entry(
        cell=cell, config=config, traffic=traffic, seed=seed, device=device, dtype=dtype)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        entry.setup()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        counts: dict = {}
        profiler = contextlib.nullcontext()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            profiler = profile(activities=acts)
        with profiler, torch.profiler.record_function("port_bench.window"):
            t0 = time.perf_counter()
            t_end, durations = t0, []
            while time.perf_counter() - t0 < seconds:
                with torch.profiler.record_function("port_bench.unit"):
                    done = entry.unit()
                    _sync(device)
                durations.append(time.perf_counter() - t_end)
                t_end = time.perf_counter()
                for k, v in done.items():
                    counts[k] = counts.get(k, 0) + v
        window_s = t_end - t0
        log(f"[port_bench] set-up {setup_s:.3f} s; units (s): "
            + " ".join(f"{d:.3f}" for d in durations))
        summary = None
        if trace:
            from . import trace as trace_mod

            with tempfile.TemporaryDirectory(prefix="port_bench_trace_") as tmp:
                path = os.path.join(tmp, "trace.json")
                profiler.export_chrome_trace(path)
                summary = trace_mod.load(path)
            del profiler
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        work = entry.work(counts)
        entry.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        set_float32_precision(False)  # the reference: float32, TF32 off
        t_check = time.perf_counter()
        checks = entry.check()
        log(f"[port_bench] check took {time.perf_counter() - t_check:.1f} s")
    finally:
        entry.close()
    ctx = Context(cell, config, setup_s, window_s, counts, peak, card, work, summary)
    specs = bench.per_layer(workload) if trace else bench.end_to_end(workload)
    metrics = {}
    for spec in specs:
        value = bench.module("metrics", spec["name"]).read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card,
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": counts.get("attempted", 0), "failed": counts.get("failed", 0),
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_us / 1e6
        dev["window_s"] = summary.window_us / 1e6
        out["breakdown"] = {
            "device_ops": [[n[:160], us / 1e6] for n, us in summary.top_ops(10)],
            "idle_gaps": [[n[:160], us / 1e6] for n, us in summary.gaps[:10]]}
    # a number that is not finite fails its limit and is shown as text (JSON has none)
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
