"""Kinetics-400 attack-sample pipeline (reference C3: datasets.py).

PyTorch-side counterpart of :mod:`i2v_tpu.data.kinetics`. Manifest: a CSV
with columns path,gt_label,clip_index, one correctly classified clip per
class (reference C30), read with the ``csv`` module. Decode goes through
:mod:`.decode` (native FFmpeg library, decord, or pre-decoded sidecars),
frames are scaled to a fixed new_width × new_height canvas at decode, and the
validation transform plus the seeded clip selection give the
(3, 32, 224, 224) normalized clip, or with ``raw_uint8`` its (32, 224, 224, 3)
uint8 frames. Corrupt, missing and too-small videos are skipped with a
warning and a resample (reference: datasets.py:127-147).

``iterate_batches`` is the batcher of every dataset of the port.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import warnings
from typing import Iterator, Optional

import numpy as np

from . import native, transforms
from .decode import decode_video


@dataclasses.dataclass
class KineticsSample:
    path: str
    label: int
    clip_index: int


def read_manifest(anno_path: str) -> list[KineticsSample]:
    with open(anno_path, newline="") as f:
        return [KineticsSample(row["path"], int(row["gt_label"]), int(row["clip_index"]))
                for row in csv.DictReader(f)]


class KineticsAttackDataset:
    """Validation-mode dataset yielding (clip, label, video_name, clip_ind),
    the reference item contract (datasets.py:138-150)."""

    def __init__(self, anno_path: str, data_path: str, *, clip_len: int = 32,
                 frame_sample_rate: int = 2, crop_size: int = 224,
                 short_side_size: int = 256, new_height: int = 256,
                 new_width: int = 340, num_segment: int = 1,
                 raw_uint8: bool = False):
        self.samples = read_manifest(anno_path)
        self.data_path = data_path
        self.clip_len = clip_len
        self.frame_sample_rate = frame_sample_rate
        self.crop_size = crop_size
        self.short_side_size = short_side_size
        self.new_height = new_height
        self.new_width = new_width
        self.num_segment = num_segment
        self.raw_uint8 = raw_uint8

    def __len__(self) -> int:
        return len(self.samples)

    def _fname(self, sample: KineticsSample) -> Optional[str]:
        fname = os.path.join(self.data_path, sample.path)
        if not os.path.exists(fname):
            return None
        if os.path.getsize(fname) < 1024:  # reference: datasets.py:197-199
            warnings.warn(f"SKIP tiny file: {fname}")
            return None
        return fname

    def _select_clip(self, frames, sample: KineticsSample) -> Optional[np.ndarray]:
        if frames is None or len(frames) == 0:
            return None
        idx = transforms.kinetics_clip_indices(len(frames), sample.clip_index, self.clip_len,
                                               self.frame_sample_rate, self.num_segment)
        return frames[idx]

    def _load(self, sample: KineticsSample) -> Optional[np.ndarray]:
        fname = self._fname(sample)
        if fname is None:
            return None
        try:
            frames = decode_video(fname, width=self.new_width, height=self.new_height)
        except Exception as e:  # any decode failure: warned, then resampled
            warnings.warn(f"video cannot be decoded: {fname}: {e}")
            return None
        return self._select_clip(frames, sample)

    def load_batch(self, indices) -> list:
        """Decode a batch on the native thread pool (one call for the whole
        batch, the runtime dual of the reference's 9 DataLoader workers,
        datasets.py:272-274). A failed item is resampled as in
        ``__getitem__``. Returns the ``__getitem__`` tuples."""
        if not native.available():
            return [self[i] for i in indices]
        samples = [self.samples[i] for i in indices]
        fnames = [self._fname(s) for s in samples]
        sidecar = [f is not None and f.endswith((".npy", ".npz")) for f in fnames]
        # sidecars go through decode_video's dispatch, not the FFmpeg pool;
        # missing and tiny files (fname None) are known failures already
        todo = [(j, f) for j, f in enumerate(fnames) if f is not None and not sidecar[j]]
        decoded = native.decode_videos([f for _, f in todo], width=self.new_width,
                                       height=self.new_height)
        buffers = [self._load(s) if sc else None for s, sc in zip(samples, sidecar)]
        for (j, _), frames in zip(todo, decoded):
            buffers[j] = self._select_clip(frames, samples[j])
        # a failed item is resampled directly: its file is known to be bad
        return [self._resample(s) if b is None else self._pack(s, b)
                for s, b in zip(samples, buffers)]

    def _pack(self, sample: KineticsSample, buffer: np.ndarray):
        """Apply the validation transform and build the item tuple.
        ``raw_uint8`` keeps the clip as the cropped (T,H,W,3) uint8 frames,
        normalized on the device (``ops.pixel.ingest_u8_clips``): a quarter of
        the host-to-device bytes, and the same clean clip there."""
        frames_u8 = transforms.kinetics_val_frames_u8(buffer, self.short_side_size,
                                                      self.crop_size)
        clip = frames_u8 if self.raw_uint8 else transforms.u8_clip_to_normalized(frames_u8)
        return clip, sample.label, sample.path.split(".")[0], sample.clip_index

    def _resample(self, sample: KineticsSample):
        """Skip and resample (datasets.py:142-147): draws from numpy's global
        stream, as the JAX package does, until one loads. ``sample`` is the
        item that failed (for the warning). After 3·len(dataset) failed draws
        the data source itself is broken (a wrong path, an unmounted volume),
        and this raises."""
        for _ in range(3 * len(self)):
            warnings.warn(f"video {sample.path} not correctly loaded; resampling")
            sample = self.samples[np.random.randint(len(self))]
            buffer = self._load(sample)
            if buffer is not None:
                return self._pack(sample, buffer)
        raise RuntimeError(f"no video in the manifest decoded after {3 * len(self)} random "
                           f"draws: the data source looks unusable (root: {self.data_path!r})")

    def __getitem__(self, index: int):
        sample = self.samples[index]
        buffer = self._load(sample)
        if buffer is None:
            return self._resample(sample)
        return self._pack(sample, buffer)


def iterate_batches(dataset, batch_size: int, left: int = 0,
                    right: Optional[int] = None) -> Iterator[dict]:
    """Sequential batcher over a [left, right) manifest shard. Returns dicts
    with stacked 'clips' (B,3,T,H,W), or (B,T,H,W,3) uint8 ones, 'labels',
    'names', 'clip_inds'."""
    right = len(dataset) if right is None else min(right, len(dataset))
    batched = getattr(dataset, "load_batch", None)
    for start in range(left, right, batch_size):
        idxs = range(start, min(start + batch_size, right))
        items = batched(idxs) if batched else [dataset[i] for i in idxs]
        clips, labels, names, inds = zip(*items)
        yield {
            "clips": np.stack(clips),
            "labels": np.asarray(labels, np.int32),
            "names": list(names),
            "clip_inds": list(inds),
        }
