"""Synthetic clip source: checkpoint- and dataset-free end-to-end runs.
Deterministic per label, and the same clips as ``i2v_tpu.data.synthetic``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.pixel import IMAGENET_MEAN, IMAGENET_STD


class SyntheticAttackDataset:
    """Yields (clip (3,T,H,W) normalized f32, label, name, clip_ind) items with
    the Kinetics item contract, or with ``raw_uint8`` (T,H,W,3) uint8 clips;
    pixel content is a function of the label."""

    def __init__(self, n_samples: int = 8, clip_len: int = 32, size: int = 224,
                 n_classes: Optional[int] = None, raw_uint8: bool = False):
        self.n_samples = n_samples
        self.clip_len = clip_len
        self.size = size
        self.n_classes = n_classes or n_samples
        self.raw_uint8 = raw_uint8

    def __len__(self) -> int:
        return self.n_samples

    def clip01(self, label: int) -> np.ndarray:
        """The [0,1]-domain (3,T,H,W) clip of ``label``."""
        rng = np.random.RandomState(label)
        return rng.rand(3, self.clip_len, self.size, self.size).astype(np.float32)

    def __getitem__(self, index: int):
        label = index % self.n_classes
        if self.raw_uint8:
            # the uint8 ingest path: (T,H,W,3) frames, normalized on the
            # device; the same stream as clip01, another shape, so these
            # clips are not clip01's
            rng = np.random.RandomState(label)
            return (rng.randint(0, 256, (self.clip_len, self.size, self.size, 3),
                                dtype=np.uint8),
                    label, f"synthetic_{label}", label)
        mean = np.asarray(IMAGENET_MEAN, np.float32)[:, None, None, None]
        std = np.asarray(IMAGENET_STD, np.float32)[:, None, None, None]
        clip = (self.clip01(label) - mean) / std
        return clip, label, f"synthetic_{label}", label


from .kinetics import iterate_batches  # noqa: E402,F401
