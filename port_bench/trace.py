"""Reduction of a ``torch.profiler`` Chrome trace over the harness's window.

The window is the harness's own span (``port_bench.window``), so idle time
at its edges counts. Busy time is the union of the intervals of every device
operation (kernels, copies, sets) clipped to the window; an idle gap is a
hole in that union, labelled by the innermost host-side event (the
harness's spans and the ops of the thread that opened the window) open at
the gap's middle. ``CATEGORIES`` is copied from
``tools/torch_eval_profile.py``: a kernel's class is the first whose
patterns its name contains."""

from __future__ import annotations

import dataclasses
import json

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CATEGORIES = (
    ("K1+K2", ("rebuild_fwd_kernel", "rebuild_bwd_kernel")),
    ("conv fft", ("fft", "cf32")),
    ("conv dgrad", ("dgrad",)),
    ("conv", ("fprop", "implicit_gemm", "conv")),
    ("gemm", ("gemm",)),
    ("layout", ("nchwToNhwc", "nhwcToNchw", "Transpose")),
    ("pool", ("pool",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
)
CONV_CLASSES = ("conv fft", "conv dgrad", "conv")


def kernel_class(name: str) -> str:
    return next((c for c, pats in CATEGORIES if any(p in name for p in pats)), "other")


@dataclasses.dataclass
class Summary:
    window_us: float
    busy_us: float
    kernels: list          # (name, start_us, dur_us), clipped to the window
    copies: list           # the same of the host/device copies
    gaps: list             # (label, dur_us), longest first

    def kernel_us(self, pred) -> float:
        return sum(d for n, _, d in self.kernels if pred(n))

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, _, d in self.kernels + self.copies:
            by[name] = by.get(name, 0.0) + d
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list) -> Summary:
    """A :class:`Summary` of Chrome-trace ``events`` over the window span."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if len(win) != 1:
        raise ValueError(f"expected one {WINDOW!r} span in the trace, found {len(win)}")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    main = (win[0].get("pid"), win[0].get("tid"))

    def inside(e):
        return e.get("ph") == "X" and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0

    dev = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    busy = _union(clipped)
    busy_us = sum(e - s for s, e in busy)
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation") and inside(e)
            and (e.get("pid"), e.get("tid")) == main and e.get("name") != WINDOW]
    holes = [(w0, busy[0][0])] if busy else [(w0, w1)]
    holes += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    holes.append((busy[-1][1], w1) if busy else (w1, w1))
    gaps = []
    for s, e in holes:
        if e <= s:
            continue
        mid = (s + e) / 2
        open_ = [h for h in host if h["ts"] <= mid <= h["ts"] + h.get("dur", 0)]
        label = min(open_, key=lambda h: h.get("dur", 0))["name"] if open_ else "(no host event)"
        gaps.append((label, e - s))
    gaps.sort(key=lambda g: -g[1])
    def cut(e):
        s = max(e["ts"], w0)
        return e["name"], s, min(e["ts"] + e["dur"], w1) - s

    kernels = [cut(e) for e in dev if e.get("cat") == "kernel"]
    copies = [cut(e) for e in dev if e.get("cat") == "gpu_memcpy"]
    return Summary(w1 - w0, busy_us, kernels, copies, gaps)


def load(path: str) -> Summary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
