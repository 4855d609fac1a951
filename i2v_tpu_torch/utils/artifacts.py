"""The .npy artifact protocol — the de-facto IR between attack and eval
stages (SURVEY.md §1 'Artifact protocol').

Contract (reference: attack.py:92-96, image_main.py:90-92, reference.py:38-46):
  - run directory name encodes run identity: ``{kind}-{method}-{steps}-{prefix}``
  - one float32 array per sample, shape (3, T, 224, 224), *normalized* domain,
    file ``{label}-adv.npy`` (and ``{label}-ori.npy`` for white-box runs)
  - the integer label doubles as the unique sample id (1 clip per class)
  - evaluation lists ``*adv*`` files, parses labels from filenames, re-batches
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterable, Sequence

import numpy as np


def run_dir_name(kind: str, method: str, steps: int, prefix: str = "") -> str:
    """``{kind}-{method}-{steps}-{prefix}`` (reference: attack.py:55-60,
    image_main.py:45). kind ∈ {model name, 'Image', 'UCF101_Video',
    'UCF101_Image', ...}."""
    return f"{kind}-{method}-{steps}-{prefix}"


def adv_filename(label: int, kind: str = "adv") -> str:
    return f"{label}-{kind}.npy"


def save_adv_clip(run_dir: str, label: int, clip_cthw: np.ndarray,
                  kind: str = "adv", dtype=np.float32) -> str:
    """Save one normalized-domain (3,T,H,W) clip keyed by label.

    ``dtype=np.float16`` is the opt-in compact format: half the bytes on disk
    and, in the fused path, half the device-to-host copy (the cast runs on the
    device); eval's load casts back to f32 (≤6e-4 absolute pixel error in the
    normalized domain — well under the ε=16/255 perturbation scale)."""
    os.makedirs(run_dir, exist_ok=True)
    arr = np.asarray(clip_cthw, dtype=dtype)
    if arr.ndim != 4 or arr.shape[0] != 3:
        raise ValueError(f"expected (3,T,H,W) clip, got {arr.shape}")
    path = os.path.join(run_dir, adv_filename(label, kind))
    # atomic write: a run killed mid-save must not leave a truncated .npy
    # that skip-if-exists resume would treat as complete (and eval would
    # crash loading). ".tmp.npy" so np.save doesn't append another suffix;
    # list_adv_files requires the ".npy" ending AND 'adv'/'ori' in the name,
    # so a stray tmp ("...-adv.npy.tmp.npy") would match — hence replace, not
    # rename-if-absent, and the tmp lives only within this call.
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)
    return path


def save_batch(run_dir: str, labels: Sequence[int], adv_batch,
               ori_batch=None, dtype=np.float32) -> None:
    """Per-sample save of an attack output batch (B,3,T,H,W)."""
    adv_batch = np.asarray(adv_batch)
    for i, label in enumerate(labels):
        save_adv_clip(run_dir, int(label), adv_batch[i], "adv", dtype=dtype)
        if ori_batch is not None:
            save_adv_clip(run_dir, int(label), np.asarray(ori_batch)[i], "ori",
                          dtype=dtype)


def list_adv_files(run_dir: str, kind: str = "adv") -> list[str]:
    """All ``*{kind}*`` artifact files (reference: reference.py:96-97).
    ``.tmp.npy`` in-flight writes (save_adv_clip) are never artifacts."""
    return [f for f in sorted(os.listdir(run_dir))
            if kind in f and f.endswith(".npy") and not f.endswith(".tmp.npy")]


def label_of(filename: str) -> int:
    return int(os.path.basename(filename).split("-")[0])


def batch_files(files: Sequence[str], batch_size: int) -> list[list[str]]:
    """Chunk the artifact list (reference: reference.py:99-103)."""
    return [list(files[i:i + batch_size])
            for i in range(0, len(files), batch_size)]


def load_adv_batch(run_dir: str, files: Iterable[str]):
    """Load a file batch → (clips (B,3,T,H,W) f32, labels (B,) i32)."""
    clips, labels = [], []
    for f in files:
        clips.append(np.load(os.path.join(run_dir, f)))
        labels.append(label_of(f))
    # compact (f16) artifacts cast back to the protocol's f32 here
    return (np.stack(clips).astype(np.float32, copy=False),
            np.asarray(labels, dtype=np.int32))


def save_loss_info(run_dir: str, loss_info: dict, shard_index: int = 1) -> str:
    """Per-shard per-step loss log (reference: image_main.py:94-95)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"loss_info_{shard_index}.json")
    with open(path, "w") as f:
        json.dump(loss_info, f)
    return path


def existing_labels(run_dir: str, kind: str = "adv") -> set[int]:
    """Labels already attacked — enables idempotent skip-if-exists resume
    (SURVEY.md §5 failure recovery)."""
    if not os.path.isdir(run_dir):
        return set()
    return {label_of(f) for f in list_adv_files(run_dir, kind)}
