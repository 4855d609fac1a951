"""UCF-101 frame-JPEG pipeline (reference C4: dataset_ucf101.py).

PyTorch-side counterpart of :mod:`i2v_tpu.data.ucf101`. Samples come from a
setting file of ``dir duration label`` lines, subset by a pickled index list
(101 clips, one per class); frames are ``image_%05d.jpg`` under each clip
directory; the eval transform is Scale(224) → CornerCrop(224,'c') →
normalize with LoopPadding(32) (reference: dataset_ucf101.py:52-126).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Iterator, Optional, Sequence

import numpy as np

from . import native, transforms
from .decode import decode_jpeg


@dataclasses.dataclass
class UCFSample:
    directory: str
    duration: int
    label: int


def read_setting(setting_path: str, image_root: str) -> list[UCFSample]:
    samples = []
    with open(setting_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                raise RuntimeError(f"bad setting line: {line!r}")
            samples.append(UCFSample(os.path.join(image_root, parts[0]),
                                     int(parts[1]), int(parts[2])))
    return samples


def load_used_idxs(path: str) -> list[int]:
    """The attack subset's indices into the setting file: a pickle, as the
    reference ships it (the packaged copy is ``manifests/used_idxs.pkl``)."""
    with open(path, "rb") as f:
        return list(pickle.load(f))


class UCF101AttackDataset:
    """Yields (clip, label) like the reference attack_ucf101 Dataset
    (dataset_ucf101.py:66-81): a (3,32,224,224) normalized float32 clip, or
    with ``raw_uint8`` its (32,224,224,3) uint8 frames."""

    def __init__(self, setting_path: str, image_root: str,
                 used_idxs: Optional[Sequence[int]] = None,
                 clip_len: int = 32, crop_size: int = 224,
                 raw_uint8: bool = False):
        clips = read_setting(setting_path, image_root)
        if used_idxs is not None:
            clips = [clips[i] for i in used_idxs]
        self.clips = clips
        self.clip_len = clip_len
        self.crop_size = crop_size
        self.raw_uint8 = raw_uint8

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, index: int):
        sample = self.clips[index]
        frame_indices = transforms.loop_padding(list(range(1, sample.duration + 1)),
                                                self.clip_len)
        paths = []
        for i in frame_indices:
            path = os.path.join(sample.directory, f"image_{i:05d}.jpg")
            if not os.path.exists(path):
                break
            paths.append(path)
        if not paths:
            # a duration-1 clip meets the reference's LoopPadding [1:size+1]
            # slice (transforms_ucf101.py:33), which drops its only frame; the
            # reference fails on these too (an empty torch.stack)
            raise FileNotFoundError(
                f"no frames under {sample.directory} (duration={sample.duration}; "
                "durations < 2 give an empty clip under the reference's LoopPadding "
                "first-frame skip)")
        if len(paths) < len(frame_indices):
            # a setting file's duration can exceed the real frame count; loop
            # over the frames that exist, so that every clip has clip_len frames
            paths = [paths[i % len(paths)] for i in range(len(frame_indices))]
        frames_u8 = transforms.ucf_test_frames_u8(self._decode(paths), self.crop_size)
        clip = frames_u8 if self.raw_uint8 else transforms.u8_clip_to_normalized(frames_u8)
        return clip, sample.label

    def _decode(self, paths: list) -> list:
        """The clip's frames as uint8 (H,W,3) arrays: each distinct path once
        on the native thread pool (LoopPadding repeats indices), a frame the
        pool failed on through ``decode_jpeg``; ``decode_jpeg`` for each
        without the native library."""
        if native.available():
            uniq = sorted(set(paths))
            by_path = {p: a if a is not None else decode_jpeg(p)
                       for p, a in zip(uniq, native.decode_jpegs(uniq))}
            return [by_path[p] for p in paths]
        return [decode_jpeg(p) for p in paths]


def iterate_batches(dataset, batch_size: int, left: int = 0,
                    right: Optional[int] = None) -> Iterator[dict]:
    right = len(dataset) if right is None else min(right, len(dataset))
    for start in range(left, right, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, right))]
        clips, labels = zip(*items)
        names = [os.path.basename(dataset.clips[start + i].directory)
                 for i in range(len(items))]
        yield {
            "clips": np.stack(clips),
            "labels": np.asarray(labels, np.int32),
            "names": names,
        }
