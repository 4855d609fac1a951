"""Metric meters (reference C2: utils.py:40-56)."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running sum, count, and average."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
