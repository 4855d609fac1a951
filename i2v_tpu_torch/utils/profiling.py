"""Throughput meter and profiler trace.

  - :func:`trace`      — a ``torch.profiler`` trace (CPU and CUDA activity)
                         written as a Chrome trace into a directory; a no-op
                         when no directory is given
  - :class:`StepTimer` — attack steps/s and clips/s; on a CUDA device it
                         synchronizes before reading the clock, since kernels
                         run asynchronously to the host
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Tracks attack throughput on one device: steps/sec and clips/sec.

    ``with timer(clips=len(batch)):`` records the actual clip count; the bare
    ``with timer:`` form uses ``clips_per_call``. A call whose body raises is
    not counted. ``last_call_s`` is the last call's time alone: after the
    first call it excludes one-time warm-up (CUDA context, cuDNN set-up).
    ``n_chips``: how many positions of a device mesh the timed runner spans;
    steps/s are reported per position, as the JAX timer reports them per
    chip. The host clock stops after ``device`` synchronizes: the runners
    gather their outputs there, so that waits for every card's share.
    """

    REPORT_EVERY = 5

    def __init__(self, steps_per_call: int, clips_per_call: int, device: torch.device | str,
                 n_chips: int = 1):
        self.steps_per_call = steps_per_call
        self.clips_per_call = clips_per_call
        self.device = torch.device(device)
        self.n_chips = max(1, n_chips)
        self.calls = 0
        self.clips = 0
        self.elapsed = 0.0
        self.last_call_s = 0.0
        self._t0: Optional[float] = None
        self._pending_clips: Optional[int] = None

    def __call__(self, clips: Optional[int] = None) -> "StepTimer":
        self._pending_clips = clips
        return self

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        t0, self._t0 = self._t0, None
        clips, self._pending_clips = self._pending_clips, None
        if exc_type is not None:
            return  # a failed call contributes no throughput
        self._sync()
        self.last_call_s = time.time() - t0
        self.elapsed += self.last_call_s
        self.calls += 1
        self.clips += self.clips_per_call if clips is None else clips
        if self.calls % self.REPORT_EVERY == 0:
            print(f"[throughput] {self.steps_per_sec_per_chip:.2f} "
                     f"attack steps/s/chip, {self.clips_per_sec:.2f} adv clips/s")

    @property
    def steps_per_sec_per_chip(self) -> float:
        if not self.elapsed:
            return 0.0
        return self.calls * self.steps_per_call / self.elapsed / self.n_chips

    @property
    def clips_per_sec(self) -> float:
        if not self.elapsed:
            return 0.0
        return self.clips / self.elapsed

    def summary(self) -> dict:
        return {
            "attack_steps_per_sec_per_chip": self.steps_per_sec_per_chip,
            "adv_clips_per_sec": self.clips_per_sec,
            "n_chips": self.n_chips,
            "calls": self.calls,
            "elapsed_s": self.elapsed,
            "last_call_s": self.last_call_s,
        }
