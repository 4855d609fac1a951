"""Fused generate→evaluate: attack a batch and evaluate the adversarial clips
on the video models at once, on the device, with the artifact writes off the
main thread.

PyTorch counterpart of :mod:`i2v_tpu.eval.fused`. The reference runs two
processes with an artifact round trip between them (run_image_guided.py:
48-52): generation writes float32 ``.npy`` files, then evaluation reads each
one back and uploads it once a model. Here:

  - the attack's normalized-domain output feeds each resident video model's
    forward on the device; only the predictions, ``(B,)`` int64, come back;
  - artifacts are still written, as the input of ILAF and of offline
    re-evaluation, but the device→host copy runs on a side stream into pinned
    memory and a writer thread saves the files, so both overlap the next
    batch's attack (:class:`AsyncArtifactWriter`); float16 artifacts are cast
    on the device, which halves the copy;
  - the reports keep the reference's schemas (reference.py:105-129) and the
    JAX package's bytes: the CSV of :func:`.transfer.write_reports`, and a
    JSON top-1 that is a float64 mean of the hits over the kept clips (the
    JAX fused path's formula, not :mod:`.transfer`'s float32 mean).
"""

from __future__ import annotations

import csv
import glob
import json
import os
import queue
import re
import threading
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel.replicas import replicas_for
from ..utils import artifacts
from .transfer import order_predictions_by_label, write_reports


class AsyncArtifactWriter:
    """Device→host copy and per-clip ``.npy`` saves, off the main thread.

    ``submit`` starts the copy of a CUDA batch on a side stream into pinned
    host memory, records an event after it, and queues the batch; the writer
    thread waits on the event and saves each clip. ``record_stream`` keeps the
    caching allocator from reusing the source before the copy is done. The
    queue holds at most ``depth`` batches, which bounds the pinned memory (a
    B=16 float32 batch is 308 MB). An error in the writer thread is raised at
    the next ``submit`` and at ``close``.
    """

    def __init__(self, run_dir: str, dtype=np.float32, kind: str = "adv", depth: int = 2):
        self.run_dir = run_dir
        self.dtype = dtype
        self.kind = kind
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []
        self._done = object()
        self._stream: Optional[torch.cuda.Stream] = None  # the copies' side stream
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is self._done:
                return
            labels, host, event = item
            try:
                if event is not None:
                    event.synchronize()
                batch = host.numpy()
                for i, label in enumerate(labels):
                    artifacts.save_adv_clip(self.run_dir, int(label), batch[i], self.kind,
                                            dtype=self.dtype)
            except Exception as e:  # noqa: BLE001 — raised in the main thread
                self._err.append(e)

    def _raise_error(self) -> None:
        if self._err:
            raise RuntimeError("the artifact writer failed") from self._err[0]

    def _copy_to_host(self, adv: torch.Tensor):
        """→ (host tensor, event that marks the end of its copy, or None)."""
        adv = adv.detach()
        if not adv.is_cuda:
            return adv, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=adv.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(adv.device))
        host = torch.empty(adv.shape, dtype=adv.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(adv, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        adv.record_stream(stream)
        return host, event

    def submit(self, labels: Sequence[int], adv: torch.Tensor) -> None:
        self._raise_error()
        host, event = self._copy_to_host(adv)
        self._q.put(([int(x) for x in labels], host, event))

    def close(self) -> None:
        self._q.put(self._done)
        self._t.join()
        self._raise_error()


def _read_csv(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray([[int(c) for c in r] for r in rows[1:]], dtype=np.int64)


def merge_shard_reports(run_dir: str) -> dict:
    """Merge the shard-suffixed fused reports (``*_{k}.csv/json``) of a run
    directory into the two plain reports; returns ``{model: top-1 %}``.

    A ``--no_artifacts`` sharded fused run leaves only these reports, so they
    are merged directly: per-label predictions (rows where a shard has one,
    i.e. not -1) are united over the shards, two shards that give one label
    different predictions raise, and the top-1 is recomputed over the union.
    The bytes are those of the JAX package's pandas version."""
    shard_csvs = sorted(glob.glob(os.path.join(run_dir, "results_all_models_prediction_*.csv")))
    if not shard_csvs:
        raise FileNotFoundError(f"no shard-suffixed reports under {run_dir!r} (pattern "
                                "results_all_models_prediction_<k>.csv)")
    header, merged = _read_csv(shard_csvs[0])
    model_cols = [i for i, c in enumerate(header) if c.endswith("-pre")]
    for p in shard_csvs[1:]:
        cols, theirs = _read_csv(p)
        if cols != header or theirs.shape != merged.shape:
            raise ValueError(f"{p!r} has different model columns than {shard_csvs[0]!r}; "
                             "cannot merge")
        for col in model_cols:
            ours, their = merged[:, col], theirs[:, col]
            clash = (ours != -1) & (their != -1) & (ours != their)
            if clash.any():
                lab = int(np.flatnonzero(clash)[0])
                raise ValueError(f"shards disagree on label {lab} for {header[col]!r} "
                                 f"({int(ours[lab])} vs {int(their[lab])} in {p!r}) — "
                                 "overlapping shard bounds?")
            merged[:, col] = np.where(their != -1, their, ours)
    gt = merged[:, header.index("gt_label")]
    acc = {}
    for col in model_cols:
        preds = merged[:, col]
        have = preds != -1
        n = max(int(have.sum()), 1)
        acc[re.sub(r"-pre$", "", header[col])] = 100.0 * float(
            (preds[have] == gt[have]).sum()) / n
    with open(os.path.join(run_dir, "results_all_models_prediction.csv"), "w",
              newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(merged.tolist())
    with open(os.path.join(run_dir, "top1_acc_all_models.json"), "w") as f:
        json.dump(acc, f)
    return acc


class FusedGenerateEvaluate:
    """Attack, on-device evaluation and asynchronous artifact writes, batch by
    batch.

    ``attack`` is any attack of the reference's calling convention
    (``attack(videos, labels, names) -> adv_norm``; AENS's triple too);
    ``eval_bundles`` maps a model name to a :class:`VideoModel` on the
    attack's device, whose ``apply_norm`` takes normalized clips. Every model
    stays resident, so each clip is evaluated by all of them while it is on
    the device (the reference's per-model reload, reference.py:108-125, goes
    away). ``run_dir=None`` writes no artifacts. The forwards are CUDA
    graphs on a card, as in :func:`.transfer.single_pass_eval`
    (``graphs=False``: eager).
    """

    def __init__(self, attack, eval_bundles: dict, *, run_dir: Optional[str],
                 n_classes: int = 400, artifact_dtype=np.float32, graphs: bool = True):
        self.attack = attack
        self.graphs = graphs
        self.bundles = dict(eval_bundles)
        self.n_classes = n_classes
        self.run_dir = run_dir
        self.writer = (AsyncArtifactWriter(run_dir, dtype=artifact_dtype)
                       if run_dir is not None else None)
        self.predictions: dict[str, list[int]] = {n: [] for n in self.bundles}
        self.labels_seen: list[int] = []

    def _evaluate(self, adv: torch.Tensor, labels) -> None:
        """Every model's forward is issued before any prediction is fetched:
        one CUDA graph a model and batch shape on a card, held on the
        bundle (:func:`~i2v_tpu_torch.parallel.replicas.replicas_for`)."""
        dlabels = torch.as_tensor(np.asarray(labels), device=adv.device).long()
        pending = {name: replicas_for(b, graphs=self.graphs).predict(adv, None, dlabels)[1:]
                   for name, b in self.bundles.items()}
        self.labels_seen += [int(x) for x in labels]
        for name, (_, preds) in pending.items():
            self.predictions[name] += preds.cpu().tolist()

    def process_batch(self, batch) -> None:
        labels = np.asarray(batch["labels"])
        out = self.attack(batch["clips"], batch["labels"], batch.get("names"))
        adv = out[0] if isinstance(out, tuple) else out  # AENS's triple
        if self.writer is not None:
            # float16 is cast on the device, so that it halves the copy too
            egress = adv.to(torch.float16) if np.dtype(self.writer.dtype) == np.float16 else adv
            self.writer.submit(labels, egress)
        self._evaluate(adv, labels)

    def process_artifacts(self, files: Sequence[str]) -> None:
        """Resume: score artifacts already in the run directory through the
        resident models, with no attack and no write. A killed fused run
        resumes as ``process_artifacts`` over the labels on disk, then
        ``process_batch`` over the rest; ``finalize`` then writes complete,
        unsuffixed reports (the reference's re-evaluate protocol,
        reference.py:96-103, inside the fused process)."""
        clips, labels = artifacts.load_adv_batch(self.run_dir, files)
        device = next(iter(self.bundles.values())).device
        self._evaluate(torch.from_numpy(clips).to(device), labels)

    def finalize(self, report_dir: Optional[str] = None, shard: Optional[int] = None) -> dict:
        """Drain the artifact writer and write the two reports; returns
        ``{model: top-1 %}``. A ``shard`` id suffixes the report names
        ``*_{shard}.csv/json`` so that sibling shards of one run directory do
        not overwrite each other (the ``loss_info_{N}.json`` pattern,
        image_main.py:94)."""
        if self.writer is not None:
            self.writer.close()
        labels = self.labels_seen
        keep = list(range(len(labels)))
        if len(set(labels)) != len(labels):
            # a decode resample can put a label in the stream twice; the
            # writer's last file of a label wins on disk, so the reports keep
            # the last prediction of each label too
            warnings.warn("duplicate labels in the fused stream (decode resample); "
                          "keeping the last occurrence per label")
            last = {lab: i for i, lab in enumerate(labels)}
            keep = sorted(last.values())
        n = max(len(keep), 1)
        model_val_acc = {
            name: 100.0 * sum(int(self.predictions[name][i]) == labels[i] for i in keep) / n
            for name in self.bundles}
        report_dir = report_dir or self.run_dir
        if report_dir is not None:
            kept = [labels[i] for i in keep]
            columns = {name: order_predictions_by_label(
                kept, [self.predictions[name][i] for i in keep], self.n_classes)
                for name in self.bundles}
            os.makedirs(report_dir, exist_ok=True)
            write_reports(report_dir, columns, self.n_classes, model_val_acc,
                          suffix="" if shard is None else f"_{shard}")
        return model_val_acc
