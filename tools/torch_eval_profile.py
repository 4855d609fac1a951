"""Profile the port's serial transfer evaluation on one CUDA card.

    python tools/torch_eval_profile.py [--out outputs/eval_profile.json]

For each precision mode (TF32 off: ``--matmul_precision float32``; torch's
default: TF32 convolutions) and each of the six video models at full width
(random weights, 32x224^2 clips, 400 classes), the script evaluates one batch
of 16 synthetic artifacts (the reference's evaluation batch) through
``reference_eval``, the serial evaluation of ``i2v_tpu_torch.eval.transfer``:

  1. a warm-up evaluation (cuDNN's set-up for the model's shapes);
  2. an untraced evaluation, timed on the host's clock around work that ends
     in ``torch.cuda.synchronize``: clips/s and peak device memory;
  3. a ``torch.profiler`` trace of one more evaluation: device time summed
     over its kernels, the idle share of the span from the first kernel to
     the last, and the kernels that take the most time.

Then, in each mode, the six models evaluate the same batch in one pass
(``single_pass_eval``, all six resident, the batch read and uploaded once):
a warm-up and a timed pass, for clips/s and peak memory.

It prints one line a (mode, model) and writes every number, with the card's
name and power limit, into ``--out``. ``--graphs eager|graphed|both`` (default
``graphed``, the port's path) picks whether each step and forward runs as
the CUDA graph the port replays (``i2v_tpu_torch/utils/graphs.py``) or
eagerly (``graphs=False``); ``both`` gives each row twice, eager then
graphed, on every path below. A graphed row's warm-up calls hold the eager
first step and the capture. Floating-point operations a clip come
from the shapes (``torch.utils.flop_counter`` on the meta device). It needs a
card and exits without one.

    python tools/torch_eval_profile.py --attacks [--out outputs/attack_profile.json]

profiles the attack paths instead, in both precision modes, at full width
(32x224^2 clips):
AENS-I2V-MF at B=1 and B=2 (and 2 steps at B=8 and B=16, for their peaks;
a batch that does not fit is recorded as such), DR
(ResNet-101, depth 2) and ENS-I2V at B=1,
ILAF on I3D-R50 at B=1, and one fused ENS-I2V + six-model evaluation batch at
B=1. For each: a warm-up call, a timed call (steps/s or clips/s, peak device
memory) and a traced call (device time by kernel class, idle share).

    python tools/torch_eval_profile.py --attacks --frame_chunk 64,128,256,none \
        [--out outputs/chunk_profile.json]

profiles instead the frame-chunked runner (``image_main --sharded``) at the
reference's B=16 in both precision modes, AENS-I2V-MF and then ENS-I2V, each
at every chunk listed (an int, ``auto``, or ``none`` for no chunking), over
3 steps a call: the chunk sweep behind ``AUTO_CHUNK_BYTES``
(``i2v_tpu_torch/parallel/sharded.py``). A chunk that does not fit is
recorded as such.

    python tools/torch_eval_profile.py --dtype bfloat16 [--out outputs/eval_profile_bf16.json]

profiles the same evaluations with the six models computing in bfloat16
(``cli.evaluate --bf16``), once: the TF32 flags do not touch bfloat16 work.

    python tools/torch_eval_profile.py --attacks --dtype bfloat16 \
        [--out outputs/bf16_runner_profile.json]

profiles the frame-chunked runner (``parallel.sharded.make_sharded_i2v_runner``,
the library call: no CLI flag builds bfloat16 surrogates) at the reference's
B=16 with ``frame_chunk="auto"``, 3 steps a call, in both precision modes:
ENS-I2V with float32 surrogates, ENS-I2V and AENS-I2V-MF with bfloat16
surrogates and bfloat16 weight storage, and AENS-I2V-MF with float32
surrogates and a bfloat16 first moment (``mu_dtype``).

    python tools/torch_eval_profile.py --whitebox [--out outputs/whitebox_profile.json]

profiles the white-box paths on full-width I3D-R50 with TF32 off, the same
three calls each: BIM, DIFGSM, TIFGSM, TIFGSM3D and TAP at B=1 (10 steps),
TemporalTranslation (kernlen 15, chunk 5) at B=1 and at B=16 with and
without ``--remat``, and BIM at B=16 with and without ``--remat``; a batch
that does not fit is recorded as such. Then it times, with CUDA events, each
transform the new attacks add to a step on one full-width clip gradient (DI's
selection forward and backward, TI's 2-D and 3-D smoothing, TAP's 3³
smoothing forward and backward, TT's variant rolls) beside a cuDNN depthwise
conv doing the 3-D smoothing's work.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from i2v_tpu_torch.cli import common  # noqa: E402
from i2v_tpu_torch.data.synthetic import SyntheticAttackDataset  # noqa: E402
from i2v_tpu_torch.eval.transfer import reference_eval, single_pass_eval  # noqa: E402
from i2v_tpu_torch.models import get_image_models, get_video_model, video_zoo  # noqa: E402
from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES  # noqa: E402
from i2v_tpu_torch.utils import artifacts  # noqa: E402

MODES = ("float32", "default")
BATCH = 16
TOP_KERNELS = 6
# kernel-name patterns of each share the script reports, first match wins
CATEGORIES = (
    ("conv", ("fprop", "implicit_gemm", "conv")),
    # cuBLAS/CUTLASS products: the non-local blocks' attention (float32), and
    # with TF32 on the 1x1x1 convs that cuDNN hands to a GEMM
    ("gemm", ("gemm",)),
    ("layout", ("nchwToNhwc", "nhwcToNchw", "Transpose")),
    # the conv bias add: a (C,1,1,1) broadcast, which takes the unvectorized path
    ("broadcast add", ("elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast"
                       "<at::native::CUDAFunctor_add",)),
    ("elementwise", ("elementwise_kernel",)),           # ReLU, residual adds
    ("pool", ("pool",)),
)


# the attack paths' kernel classes, first match wins
ATTACK_CATEGORIES = (
    ("K1+K2", ("rebuild_fwd_kernel", "rebuild_bwd_kernel")),
    ("K3", ("sign_step_kernel",)),
    # cuDNN's FFT convolutions: the transforms and their complex products
    ("conv fft", ("fft", "cf32")),
    ("conv dgrad", ("dgrad",)),
    ("conv fwd", ("fprop", "implicit_gemm", "conv")),
    ("gemm", ("gemm",)),
    ("layout", ("nchwToNhwc", "nhwcToNchw", "Transpose")),
    ("pool", ("pool",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
)
ATTACK_STEPS = 10
AENS_PEAK_BATCH = 16
CHUNK_STEPS = 3
WB_BATCH = 16              # the reference's white-box batch
TT_STEPS, TT_PEAK_STEPS = 5, 2
TRANSFORM_ITERS = 20


def forward_flops_per_clip(name: str) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        module = video_zoo.VIDEO_BUILDERS[name]()
        clip = torch.empty(1, 3, 32, 224, 224)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        module(clip)
    return float(counter.get_total_flops())


def kernel_summary(trace_path: str) -> dict:
    """Device time by kernel name, the busy time (union of the kernels'
    intervals) and the span from the first kernel's start to the last's end."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    by_name: dict = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = intervals[-1][1] - intervals[0][0] if intervals else 0.0
    return {"kernel_us": sum(by_name.values()), "busy_us": busy, "span_us": span,
            "launches": len(events), "by_name": by_name}


def category_shares(by_name: dict, categories=CATEGORIES) -> dict:
    total = sum(by_name.values())
    shares: dict = {}
    for name, us in by_name.items():
        cat = next((c for c, pats in categories if any(p in name for p in pats)), "other")
        shares[cat] = shares.get(cat, 0.0) + us / total
    return shares


def timed(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def timed_eval(bundle, batches, run_dir, graphs: bool = True) -> tuple[float, list]:
    wall, (preds, _, _) = timed(
        lambda: reference_eval(bundle, batches, run_dir, log=lambda *_: None, graphs=graphs))
    return wall, preds


GRAPH_MODES = {"eager": (False,), "graphed": (True,), "both": (False, True)}


def attack_paths(tmp: str, graphs: bool = True):
    """(name, batch, steps, make) of each attack path profiled; ``make()``
    builds the path's models and returns a call that runs the path once on
    its batch of synthetic clips. Each path's models are built for it alone,
    so that its peak memory holds no other path's weights."""
    import numpy as np

    from i2v_tpu_torch import attacks
    from i2v_tpu_torch.cli import image_main
    from i2v_tpu_torch.eval.fused import FusedGenerateEvaluate
    from i2v_tpu_torch.models import tap_keys_for
    from i2v_tpu_torch.ops import pixel

    os.environ["I2V_TPU_OPT_PATH"] = tmp
    ds = SyntheticAttackDataset(n_samples=AENS_PEAK_BATCH)
    clips = np.stack([ds[i][0] for i in range(AENS_PEAK_BATCH)])
    device = torch.device("cuda")

    def image_attack(*flags, steps=ATTACK_STEPS):
        args = image_main.arg_parse(list(flags) + ["--step", str(steps)])
        return common.build_image_guided_attack(args, device, graphs=graphs)

    def aens(b, steps=ATTACK_STEPS):
        atk = image_attack("--attack_method", "AENS_I2V_MF", "--step_size", "0.005",
                           steps=steps)
        return lambda: atk(clips[:b], list(range(b)))

    def dr():
        atk = image_attack("--attack_method", "ImageGuidedStd_Adam", "--depth", "2")
        return lambda: atk(clips[:1], [0])

    def ens():
        atk = image_attack("--attack_method", "ImageGuidedFML2_Adam_MultiModels")
        return lambda: atk(clips[:1], [0])

    def ilaf():
        atk = attacks.ILAF(get_video_model("i3d_resnet50", device=device,
                                           taps=tap_keys_for("i3d_resnet50", "ilaf"),
                                           truncate=True),
                           "i3d", steps=ATTACK_STEPS, graphs=graphs)
        ori01 = ds.clip01(0)[None]
        adv01 = np.clip(ori01 + 0.8 * (16 / 255) * np.sign(
            np.random.RandomState(0).randn(*ori01.shape)), 0, 1).astype(np.float32)
        adv = pixel.normalize(torch.from_numpy(adv01), channel_axis=1).numpy()
        return lambda: atk(adv, clips[:1], [0])

    def fused():
        atk = image_attack("--attack_method", "ImageGuidedFML2_Adam_MultiModels")
        bundles = {n: get_video_model(n, device=device) for n in VIDEO_MODEL_NAMES}

        def batch():
            f = FusedGenerateEvaluate(atk, bundles, run_dir=os.path.join(tmp, "fused"),
                                      graphs=graphs)
            f.process_batch({"clips": clips[:1], "labels": np.arange(1)})
            f.finalize()

        return batch

    return [("AENS-I2V-MF", 1, ATTACK_STEPS, lambda: aens(1)),
            ("AENS-I2V-MF", 2, ATTACK_STEPS, lambda: aens(2)),
            # half and all of the production batch, for their peaks (every
            # step holds the same activations), over 2 steps
            ("AENS-I2V-MF", AENS_PEAK_BATCH // 2, 2, lambda: aens(AENS_PEAK_BATCH // 2, 2)),
            ("AENS-I2V-MF", AENS_PEAK_BATCH, 2, lambda: aens(AENS_PEAK_BATCH, 2)),
            ("DR", 1, ATTACK_STEPS, dr),
            ("ENS-I2V", 1, ATTACK_STEPS, ens),
            ("ILAF I3D-R50", 1, ATTACK_STEPS, ilaf),
            ("fused ENS-I2V + six models", 1, ATTACK_STEPS, fused)]


def chunked_paths(chunks):
    """``paths(tmp)`` of :func:`profile_attacks` for the frame-chunked runner:
    AENS-I2V-MF, then ENS-I2V, at B=16 through the image CLI's dispatch with
    ``--sharded --frame_chunk c`` for each ``c`` of ``chunks``."""
    def paths(tmp: str, graphs: bool = True):
        import numpy as np

        from i2v_tpu_torch.cli import image_main

        os.environ["I2V_TPU_OPT_PATH"] = tmp
        ds = SyntheticAttackDataset(n_samples=AENS_PEAK_BATCH)
        clips = np.stack([ds[i][0] for i in range(AENS_PEAK_BATCH)])

        def make(method, chunk):
            flags = ["--attack_method", method, "--step", str(CHUNK_STEPS), "--step_size",
                     "0.005", "--sharded"] + ([] if chunk == "none" else ["--frame_chunk", chunk])
            atk = common.build_image_guided_attack(image_main.arg_parse(flags),
                                                   torch.device("cuda"), graphs=graphs)
            return lambda: atk(clips, list(range(AENS_PEAK_BATCH)))

        return [(f"{label} --sharded --frame_chunk {c}", AENS_PEAK_BATCH, CHUNK_STEPS,
                 lambda m=method, c=c: make(m, c))
                for method, label in (("AENS_I2V_MF", "AENS-I2V-MF"),
                                      ("ImageGuidedFML2_Adam_MultiModels", "ENS-I2V"))
                for c in chunks]

    return paths


ENS_DEPTHS = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
AENS_DEPTHS = {n: [2, 3] for n in ENS_DEPTHS}


def runner_paths(tmp: str, graphs: bool = True):
    """(name, batch, steps, make) of the runner at B=16 with
    ``frame_chunk="auto"``, as :func:`attack_paths`: float32 and bfloat16
    ENS-I2V, bfloat16 AENS-I2V-MF, and float32 AENS-I2V-MF with a bfloat16
    first moment. Each builds its own surrogates."""
    import numpy as np

    from i2v_tpu_torch.parallel import sharded

    ds = SyntheticAttackDataset(n_samples=AENS_PEAK_BATCH)
    clean01 = torch.from_numpy(np.stack([ds.clip01(i) for i in range(AENS_PEAK_BATCH)]))

    def make(depths, dtype, adaptive=False, mu_dtype=None):
        models = get_image_models(list(depths), depths, device="cuda", dtype=dtype)
        runner = sharded.make_sharded_i2v_runner(
            models, steps=CHUNK_STEPS, step_size=0.005, adaptive=adaptive, aens_momentum=0.5,
            frame_chunk="auto", mu_dtype=mu_dtype, graphs=graphs,
            param_dtype=torch.bfloat16 if dtype == torch.bfloat16 else None)
        clips = clean01.cuda()
        return lambda: runner(clips)

    bf16 = torch.bfloat16
    return [(f"{name}, frame_chunk auto", AENS_PEAK_BATCH, CHUNK_STEPS, fn) for name, fn in (
        ("ENS-I2V float32", lambda: make(ENS_DEPTHS, torch.float32)),
        ("ENS-I2V bfloat16 (compute and storage)", lambda: make(ENS_DEPTHS, bf16)),
        ("AENS-I2V-MF bfloat16 (compute and storage)", lambda: make(AENS_DEPTHS, bf16, True)),
        ("AENS-I2V-MF float32, mu_dtype bfloat16",
         lambda: make(AENS_DEPTHS, torch.float32, True, bf16)))]


def whitebox_paths(tmp: str, graphs: bool = True):
    """(name, batch, steps, make) of each white-box path, as
    :func:`attack_paths`: each through the attack CLI's dispatch on its own
    full-width I3D-R50."""
    import numpy as np

    from i2v_tpu_torch.cli import attack as attack_cli

    os.environ["I2V_TPU_OPT_PATH"] = tmp
    ds = SyntheticAttackDataset(n_samples=WB_BATCH)
    clips = np.stack([ds[i][0] for i in range(WB_BATCH)])

    def path(method, b, steps, *flags):
        args = attack_cli.arg_parse(["--attack_method", method, "--step", str(steps)]
                                    + list(flags))
        bundle = get_video_model("i3d_resnet50", device="cuda", remat=args.remat)
        atk = common.build_whitebox_attack(args, bundle, graphs=graphs)
        return lambda: atk(clips[:b], np.arange(b))

    rows = [(m, 1, ATTACK_STEPS, ()) for m in ("BIM", "DIFGSM", "TIFGSM", "TIFGSM3D", "TAP")]
    rows += [("TemporalTranslation", 1, TT_STEPS, ()),
             ("TemporalTranslation", WB_BATCH, TT_PEAK_STEPS, ()),
             ("TemporalTranslation", WB_BATCH, TT_PEAK_STEPS, ("--remat",)),
             ("BIM", WB_BATCH, 3, ()), ("BIM", WB_BATCH, 3, ("--remat",))]
    return [(m + (" --remat" if flags else ""), b, steps,
             lambda m=m, b=b, steps=steps, flags=flags: path(m, b, steps, *flags))
            for m, b, steps, flags in rows]


def _event_ms(fn, iters: int = TRANSFORM_ITERS) -> float:
    """Device ms a call of ``fn``, CUDA events around ``iters`` calls after
    a warm-up (the host enqueues ahead; each call is milliseconds long)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_transforms(result: dict) -> None:
    """The new attacks' per-step transforms on one full-width clip gradient
    (1, 3, 32, 224, 224), TF32 off, and a cuDNN depthwise conv3d of the 15³
    Gaussian beside the separable shifted-slice form."""
    import torch.nn.functional as F

    from i2v_tpu_torch.ops import diversity, smoothing

    common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(1, 3, 32, 224, 224, device="cuda", generator=gen)
    x = g.clone().requires_grad_(True)
    k1d = smoothing.gaussian_1d(15)
    k3 = smoothing.ti_kernel_3d(15)
    tap_k = smoothing.uniform_kernel_3d(3, 3)
    filt = torch.from_numpy(k3).cuda()[None, None].expand(3, 1, 15, 15, 15).contiguous()

    def di():
        y = diversity.diversity_gather(x, 240, 3, 5, 224, 250)
        torch.autograd.grad(y, x, g)

    def tap():
        y = smoothing.depthwise_conv3d(x, tap_k)
        torch.autograd.grad(y, x, g)

    forms = {
        "DI selection, forward and backward": di,
        "TI 2-D separable 15x15 (TIFGSM)": lambda: smoothing.ti_smooth_2d_separable(g, k1d),
        "TI 3-D separable 15^3 (TIFGSM3D)": lambda: smoothing.depthwise_conv3d_separable(g, k1d),
        "TAP 3^3 smoothing, forward and backward": tap,
        "TT 15 variant rolls": lambda: [torch.roll(g, m, dims=2) for m in range(-7, 8)],
        "cuDNN depthwise conv3d 15^3, TF32 off": lambda: F.conv3d(g, filt, padding=7, groups=3),
    }
    result["transforms_ms"] = {}
    for name, fn in forms.items():
        ms = _event_ms(fn)
        result["transforms_ms"][name] = ms
        print(f"[transform] {name}: {ms:.4f} ms on one (1,3,32,224,224) gradient")


def profile_attacks(result: dict, tmp: str, paths=attack_paths, modes=MODES,
                    key: str = "attack_rows", graph_modes=(True,)) -> None:
    import gc

    from torch.profiler import ProfilerActivity, profile

    result[key] = []
    for mode in modes:
        prec = common.apply_matmul_precision(argparse.Namespace(matmul_precision=mode))
        print(f"[precision] {prec}")
        for graphs, (name, batch, steps, make) in (
                (g, path) for g in graph_modes for path in paths(tmp, g)):
            torch.cuda.reset_peak_memory_stats()
            call = make()
            try:
                warm_s, _ = timed(call)
            except torch.OutOfMemoryError as e:  # a result: the batch does not fit
                row = {"mode": mode, "path": name, "batch": batch, "steps": steps,
                       "graphs": graphs, "oom": str(e).splitlines()[0],
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
                result[key].append(row)
                print(f"[{mode}] {name}, B={batch}: out of memory after a peak of "
                      f"{row['peak_gib']:.2f} GiB allocated: {row['oom']}")
                del call, e
                gc.collect()
                torch.cuda.empty_cache()
                continue
            if graphs:
                # a second warm-up: an evaluation forward is captured at its
                # second batch, which for a one-batch path is its second call
                timed(call)
            torch.cuda.reset_peak_memory_stats()
            wall_s, _ = timed(call)
            peak = torch.cuda.max_memory_allocated() / 2**30
            trace_path = os.path.join(tmp, "trace.json")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                timed(call)
            prof.export_chrome_trace(trace_path)
            k = kernel_summary(trace_path)
            os.remove(trace_path)
            del call
            gc.collect()
            torch.cuda.empty_cache()
            row = {"mode": mode, "path": name, "batch": batch, "steps": steps,
                   "graphs": graphs, "warmup_s": warm_s, "wall_s": wall_s,
                   "steps_per_sec": steps / wall_s,
                   "clips_per_sec": batch / wall_s, "peak_gib": peak,
                   "device_ms": k["kernel_us"] / 1e3,
                   "idle_share": 1 - k["busy_us"] / k["span_us"] if k["span_us"] else None,
                   "shares": category_shares(k["by_name"], ATTACK_CATEGORIES),
                   "kernels": {n[:160]: us / k["kernel_us"] for n, us in k["by_name"].items()
                               if us >= 0.002 * k["kernel_us"]}}
            result[key].append(row)
            print(f"[{mode}, {'graphed' if graphs else 'eager'}] {name}, B={batch}, {steps} "
                  f"steps: {row['steps_per_sec']:.3f} "
                  f"steps/s, {row['clips_per_sec']:.4f} clips/s ({wall_s:.3f} s; warm-up "
                  f"{warm_s:.3f} s), device {row['device_ms']:.2f} ms, idle "
                  f"{row['idle_share']:.4f}, peak {peak:.2f} GiB; " + ", ".join(
                      f"{c} {v:.2%}" for c, v in sorted(row["shares"].items(),
                                                        key=lambda kv: -kv[1])))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="default outputs/eval_profile.json, or outputs/attack_profile.json "
                        "with --attacks")
    p.add_argument("--attacks", action="store_true", help="profile the attack paths")
    p.add_argument("--whitebox", action="store_true",
                   help="profile the white-box paths and the new attacks' transforms")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the evaluated models' compute dtype; with --attacks, 'bfloat16' "
                        "profiles the runner at B=16 with bfloat16 surrogates and mu_dtype")
    p.add_argument("--graphs", default="graphed", choices=sorted(GRAPH_MODES),
                   help="each step and forward as a replayed CUDA graph (the port's path), "
                        "eagerly, or both, eager row first")
    p.add_argument("--frame_chunk", default=None, metavar="C,C,...",
                   help="with --attacks: profile the frame-chunked runner at B=16 at each of "
                        "these chunks (ints, 'auto', 'none') instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_eval_profile: no CUDA device is available")
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "torch": torch.__version__, "batch": BATCH, "rows": []}
    if args.attacks or args.whitebox:
        with tempfile.TemporaryDirectory() as tmp:
            g = GRAPH_MODES[args.graphs]
            if args.attacks and args.dtype == "bfloat16":
                out = args.out or "outputs/bf16_runner_profile.json"
                profile_attacks(result, tmp, runner_paths, graph_modes=g)
            elif args.attacks and args.frame_chunk:
                out = args.out or "outputs/chunk_profile.json"
                profile_attacks(result, tmp, chunked_paths(args.frame_chunk.split(",")),
                                graph_modes=g)
            elif args.attacks:
                out = args.out or "outputs/attack_profile.json"
                profile_attacks(result, tmp, graph_modes=g)
            else:
                out = args.out or "outputs/whitebox_profile.json"
                time_transforms(result)
                profile_attacks(result, tmp, whitebox_paths, ("float32",), "whitebox_rows",
                                graph_modes=g)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        return result
    bf16 = args.dtype == "bfloat16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    args.out = args.out or f"outputs/eval_profile{'_bf16' if bf16 else ''}.json"
    result["dtype"] = args.dtype
    with tempfile.TemporaryDirectory() as tmp:
        ds = SyntheticAttackDataset(n_samples=BATCH)
        for label in range(BATCH):
            artifacts.save_adv_clip(tmp, label, ds[label][0])
        batches = artifacts.batch_files(artifacts.list_adv_files(tmp), BATCH)
        # the TF32 flags touch float32 work only
        for mode in ("default",) if bf16 else MODES:
            prec = common.apply_matmul_precision(argparse.Namespace(matmul_precision=mode))
            print(f"[precision] {prec}; models in {args.dtype}")
            for graphs in GRAPH_MODES[args.graphs]:
                g_label = "graphed" if graphs else "eager"
                for name in VIDEO_MODEL_NAMES:
                    bundle = get_video_model(name, device="cuda", dtype=dtype)
                    warm_s, preds = timed_eval(bundle, batches, tmp, graphs)
                    # a second warm-up: a graphed forward is captured at its second batch
                    timed_eval(bundle, batches, tmp, graphs)
                    torch.cuda.reset_peak_memory_stats()
                    wall_s, _ = timed_eval(bundle, batches, tmp, graphs)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    trace_path = os.path.join(tmp, "trace.json")
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        timed_eval(bundle, batches, tmp, graphs)
                    prof.export_chrome_trace(trace_path)
                    k = kernel_summary(trace_path)
                    os.remove(trace_path)
                    flops = forward_flops_per_clip(name)
                    top = sorted(k["by_name"].items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
                    row = {
                        "mode": mode, "model": name, "graphs": graphs, "warmup_s": warm_s,
                        "wall_s": wall_s,
                        "clips_per_sec": BATCH / wall_s, "peak_gib": peak,
                        "device_ms_per_clip": k["kernel_us"] / 1e3 / BATCH,
                        "idle_share": 1 - k["busy_us"] / k["span_us"] if k["span_us"] else None,
                        "kernel_launches": k["launches"], "gflop_per_clip": flops / 1e9,
                        "tflops_on_device": flops * BATCH / (k["kernel_us"] * 1e-6) / 1e12,
                        "top_kernels": [(n[:120], us / k["kernel_us"]) for n, us in top],
                        "shares": category_shares(k["by_name"]),
                        "kernels": {n[:160]: us / k["kernel_us"] for n, us in k["by_name"].items()
                                    if us >= 0.002 * k["kernel_us"]},
                        "preds": preds[:4],
                    }
                    result["rows"].append(row)
                    print(f"[{mode}, {g_label}] {name}: {row['clips_per_sec']:.3f} clips/s "
                          f"({wall_s:.4f} s for {BATCH}; warm-up {warm_s:.3f} s), device "
                          f"{row['device_ms_per_clip']:.3f} ms/clip, idle {row['idle_share']:.4f}, "
                          f"{row['gflop_per_clip']:.1f} GFLOP/clip at {row['tflops_on_device']:.2f} "
                          f"TFLOP/s, peak {peak:.2f} GiB; "
                          + ", ".join(f"{c} {v:.1%}" for c, v in sorted(
                              row["shares"].items(), key=lambda kv: -kv[1]))
                          + "; top: "
                          + "; ".join(f"{n[:60]} {s:.1%}" for n, s in row["top_kernels"][:3]))
                    del bundle
                    torch.cuda.empty_cache()
                bundles = {name: get_video_model(name, device="cuda", dtype=dtype)
                           for name in VIDEO_MODEL_NAMES}

                def one_pass():
                    return single_pass_eval(bundles, batches, tmp, log=lambda *_: None,
                                            graphs=graphs)

                timed(one_pass)
                timed(one_pass)
                torch.cuda.reset_peak_memory_stats()
                wall_s, _ = timed(one_pass)
                peak = torch.cuda.max_memory_allocated() / 2**30
                result["single_pass"] = result.get("single_pass", []) + [
                    {"mode": mode, "graphs": graphs, "wall_s": wall_s,
                     "clips_per_sec": BATCH / wall_s, "peak_gib": peak}]
                serial_s = sum(r["wall_s"] for r in result["rows"] if r["mode"] == mode
                               and r["graphs"] == graphs)
                print(f"[{mode}, {g_label}] single pass, six models: {BATCH / wall_s:.3f} "
                      "clips/s "
                      f"({wall_s:.4f} s for {BATCH}; the six serial evaluations above "
                      f"{serial_s:.4f} s), peak {peak:.2f} GiB")
                del bundles
                torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
