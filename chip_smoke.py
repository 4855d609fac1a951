"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, each printing one line of facts; any failure
raises and the script exits non-zero:

  1. device  — a CUDA card is present; its name and power limit
  2. build   — the hand-written kernels compile from i2v_tpu_torch/csrc/
  3. kernels — each kernel is bit-identical to its plain PyTorch version at
               the main path's shape, at ragged sizes and misaligned views,
               with planted ties and NaNs; kernel and plain version timed
               with CUDA events
  4. slice   — 20-step full-width ENS-I2V through the port's CLI over two
               synthetic clips; artifacts checked, and the launch counters
               show that every Adam step went through both kernels
  5. parity  — a tiny ENS-I2V run on the card and on the CPU from the same
               seeds gives the same cost trajectory (rtol 1e-4)

The line before the last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

EPS = 16 / 255
MAIN_SHAPE = (32, 3, 224, 224)  # one clip's B·T frames, NCHW
RAGGED_SIZES = (1, 127, 4097, 1_000_003)
SLICE_STEPS = 20
SLICE_CLIPS = 2
TIMING_ITERS = 50
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's clock: longer than the enqueue


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} visible")
    return name


def phase_build(kernels) -> None:
    t0 = time.time()
    lib = kernels.library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    print(f"[build] {os.path.relpath(lib.path)} in {time.time() - t0:.2f} s "
          f"(nvcc {lib.seconds:.2f} s); ptxas: {' | '.join(regs) or 'no report'}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a − b|, where a NaN must meet a NaN (else the error is inf)."""
    a, b = a.detach(), b.detach()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    d = (a - b).abs()[~nan_a]
    return float(d.max()) if d.numel() else 0.0


def _inputs(n: int, gen: torch.Generator, offset: int = 0):
    """clean in [0,1], modifier in [−2ε, 2ε], upstream gradient ~ N(0,1),
    as flat float32 tensors of n elements; with ``offset`` each is a view
    that starts ``offset`` elements into a larger buffer (misaligned)."""
    def make(fn):
        buf = fn(n + offset)
        return buf[offset:]

    dev = "cuda"
    clean = make(lambda k: torch.rand(k, generator=gen, device=dev))
    mod = make(lambda k: (torch.rand(k, generator=gen, device=dev) * 4 - 2) * EPS)
    g = make(lambda k: torch.randn(k, generator=gen, device=dev))
    return clean, mod, g


def _plant(clean, mod, eps32: float) -> None:
    """Ties at m = ±ε, u = 0 and u = 1, a −0.0 modifier, and NaNs."""
    n = clean.numel()
    plants = [(eps32, None), (-eps32, None),
              (-eps32, eps32),   # u = ε − ε = 0
              (0.0, 1.0),        # u = 1
              (0.0, 0.0),        # u = 0
              (-0.0, 0.5),
              (eps32, 1.0 - eps32),
              (float("nan"), 0.5),
              (0.01, float("nan"))]
    for k, (m_val, c_val) in enumerate(plants):
        i = (k * 7919) % n
        mod[i] = m_val
        if c_val is not None:
            clean[i] = c_val


def _compare(kernels, pixel, clean, mod, g, eps32: float) -> tuple[float, float]:
    out_k = kernels.launch_rebuild_fwd(clean, mod, eps32)
    m = mod.clone().requires_grad_(True)
    out_p = pixel.rebuild_adv(clean, m, eps32)
    (dm_p,) = torch.autograd.grad(out_p, m, g)
    dm_k = kernels.launch_rebuild_bwd(clean, mod, g, eps32)
    # and through the autograd Function, as the attack calls it
    m2 = mod.clone().requires_grad_(True)
    out_f = kernels.rebuild_adv(clean, m2, EPS)
    out_f.backward(g)
    fwd = max(max_abs_err(out_k, out_p), max_abs_err(out_f, out_p))
    bwd = max(max_abs_err(dm_k, dm_p), max_abs_err(m2.grad, dm_p))
    return fwd, bwd


def _time_ms(fn, iters: int) -> float:
    """Device ms per call. A spin kernel holds the stream while the host
    enqueues all ``iters`` calls, so the events time the calls back to back
    on the device and not the host's launch overhead."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_kernels(kernels, pixel) -> dict:
    eps32 = float(np.float32(EPS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"rebuild_fwd": 0.0, "rebuild_bwd": 0.0}
    cases = [("main", int(np.prod(MAIN_SHAPE)), 0)]
    cases += [(f"n={n}", n, 0) for n in RAGGED_SIZES]
    cases += [("offset view", 1_000_003, 1)]
    for label, n, offset in cases:
        clean, mod, g = _inputs(n, gen, offset)
        _plant(clean, mod, eps32)
        if label == "main":
            clean, mod, g = (t.view(MAIN_SHAPE) for t in (clean, mod, g))
        fwd, bwd = _compare(kernels, pixel, clean, mod, g, eps32)
        err["rebuild_fwd"] = max(err["rebuild_fwd"], fwd)
        err["rebuild_bwd"] = max(err["rebuild_bwd"], bwd)
        if fwd != 0.0 or bwd != 0.0:
            raise RuntimeError(f"kernel differs from its plain version ({label}): "
                               f"forward {fwd}, backward {bwd}")
    torch.cuda.synchronize()

    clean, mod, g = (t.view(MAIN_SHAPE) for t in _inputs(int(np.prod(MAIN_SHAPE)), gen))
    m = mod.clone().requires_grad_(True)
    out_p = pixel.rebuild_adv(clean, m, eps32)
    timed = {
        "rebuild_fwd": (lambda: kernels.launch_rebuild_fwd(clean, mod, eps32),
                        lambda: pixel.rebuild_adv(clean, mod, eps32)),
        "rebuild_bwd": (lambda: kernels.launch_rebuild_bwd(clean, mod, g, eps32),
                        lambda: torch.autograd.grad(out_p, m, g, retain_graph=True)),
    }
    times = {}
    for name, (kern, plain) in timed.items():
        p1 = _time_ms(plain, TIMING_ITERS)
        k1 = _time_ms(kern, TIMING_ITERS)
        k2 = _time_ms(kern, TIMING_ITERS)
        p2 = _time_ms(plain, TIMING_ITERS)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    print(f"[kernels] bit-identical to the plain version at {MAIN_SHAPE}, sizes "
          f"{RAGGED_SIZES} and a misaligned view, ties and NaNs planted; "
          + "; ".join(f"{k}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms"
                      for k, t in times.items()))
    return {"err": err, "times": times}


def _costs(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "loss_info_1.json")) as f:
        info = json.load(f)
    return {v: np.asarray([float(c[str(i)]["cost"]) for i in range(len(c))])
            for v, c in info.items()}


def phase_slice(kernels, image_main, synthetic, pixel_mean_std) -> dict:
    argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
            "--n_synthetic", str(SLICE_CLIPS), "--batch_size", "1",
            "--step", str(SLICE_STEPS), "--device", "cuda", "--matmul_precision", "float32"]
    args = image_main.arg_parse(argv)
    kernels.reset_launches()
    image_main.run(args)
    counts = dict(kernels.launches)
    want = {"rebuild_fwd": SLICE_CLIPS * (SLICE_STEPS + 1),
            "rebuild_bwd": SLICE_CLIPS * SLICE_STEPS}
    if counts != want:
        raise RuntimeError(f"launch counts {counts}, expected {want}")

    mean, std = pixel_mean_std
    ds = synthetic.SyntheticAttackDataset(n_samples=SLICE_CLIPS)
    for label in range(SLICE_CLIPS):
        adv = np.load(os.path.join(args.adv_path, f"{label}-adv.npy"))
        if adv.dtype != np.float32 or adv.shape != (3, 32, 224, 224):
            raise RuntimeError(f"{label}-adv.npy: {adv.dtype} {adv.shape}")
        if not np.isfinite(adv).all():
            raise RuntimeError(f"{label}-adv.npy holds non-finite values")
        adv01 = adv * std + mean
        dist = float(np.abs(adv01 - ds.clip01(label)).max())
        if dist > EPS + 1e-5 or adv01.min() < -1e-5 or adv01.max() > 1 + 1e-5:
            raise RuntimeError(f"{label}-adv.npy leaves the ε-ball or [0,1]: "
                               f"|adv−clean|∞={dist}, range [{adv01.min()}, {adv01.max()}]")
    costs = _costs(args.adv_path)
    if len(costs) != SLICE_CLIPS:
        raise RuntimeError(f"loss_info_1.json has {len(costs)} clips")
    for v, c in costs.items():
        if len(c) != SLICE_STEPS or not c[-1] < c[0]:
            raise RuntimeError(f"{v}: cost did not descend: {c}")
    tp = args.throughput
    print(f"[slice] ENS-I2V, {SLICE_CLIPS} clips of 32x224^2 at B=1, {SLICE_STEPS} steps, "
          f"matmul_precision=float32 (TF32 off): "
          f"{tp['attack_steps_per_sec_per_chip']:.3f} attack steps/s and "
          f"{tp['adv_clips_per_sec']:.4f} clips/s over {tp['elapsed_s']:.2f} s with the first "
          f"clip's warm-up; last clip alone {SLICE_STEPS / tp['last_call_s']:.3f} steps/s "
          f"({tp['last_call_s']:.3f} s); launches {counts}; costs "
          + "; ".join(f"{v}: {c[0]:.4f} -> {c[-1]:.4f}" for v, c in costs.items()))
    return counts


def phase_parity(image_main) -> None:
    runs = {}
    for device in ("cuda", "cpu"):
        argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
                "--tiny", "--clip_len", "4", "--n_synthetic", "1", "--step", "3",
                "--matmul_precision", "float32", "--device", device,
                "--file_prefix", f"parity-{device}"]
        runs[device] = _costs(image_main.main(argv))["synthetic_0"]
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)
    diff = float(np.max(np.abs(runs["cuda"] / runs["cpu"] - 1)))
    print(f"[parity] tiny ENS-I2V 4x32^2, 3 steps: card {runs['cuda'].tolist()} vs CPU "
          f"{runs['cpu'].tolist()}; max relative difference {diff:.3g} (limit 1e-4)")


def main() -> None:
    name = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from i2v_tpu_torch.cli import image_main
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.ops import kernels, pixel

    mean = np.asarray(pixel.IMAGENET_MEAN, np.float32)[:, None, None, None]
    std = np.asarray(pixel.IMAGENET_STD, np.float32)[:, None, None, None]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["I2V_TPU_OPT_PATH"] = os.path.join(tmp, "outputs")
        phase_build(kernels)
        measured = phase_kernels(kernels, pixel)
        counts = phase_slice(kernels, image_main, synthetic, (mean, std))
        phase_parity(image_main)

    replaces = {"rebuild_fwd": "i2v_tpu/ops/pallas_kernels.py:142",
                "rebuild_bwd": "i2v_tpu/ops/pallas_kernels.py:149"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": "i2v_tpu_torch/csrc/rebuild_adv.cu",
         "replaces": replaces[k], "launches": counts[k], "max_abs_err": measured["err"][k],
         "ms": measured["times"][k][0], "plain_ms": measured["times"][k][1]}
        for k in ("rebuild_fwd", "rebuild_bwd")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
