"""Transfer evaluation: run adversarial artifacts through the video-model zoo
and write the reference's reports (reference C27/C28: reference.py,
reference_ucf101.py).

PyTorch counterpart of :mod:`i2v_tpu.eval.transfer`. Reports, with the JAX
package's schemas byte for byte:
  - ``results_all_models_prediction.csv``: ``gt_label`` and one
    ``{model}-pre`` column per model, one row per label, ``-1`` where the run
    holds no artifact of that label (reference: reference.py:106-127); the
    bytes ``pandas.DataFrame.to_csv(index=False)`` writes, from the ``csv``
    module
  - ``top1_acc_all_models.json``: ``{model: top-1 accuracy (%)}`` (attack
    success rate = 100 − top-1)

Each batch is read from disk by a prefetch thread into pinned host memory
and uploaded with ``non_blocking=True``; while a profiler runs, the thread
records its read, pin and upload as spans (``ingest.*``) and the loop its
wait for each batch (``eval.ingest_wait``), forwards and fetches, under one
``eval.sweep`` a call (:mod:`i2v_tpu_torch.utils.profiling`). Forwards run under
``torch.inference_mode()`` and top-1 is computed on the device, so only the
predictions and the accuracy come back. The serial mode swaps models as the
reference does (reference.py:124-125: ``del`` and ``empty_cache``); the
single-pass mode keeps every model resident and runs each uploaded batch
through all of them. Both run one batch loop (``_eval_loop``), the serial
mode over one model at a time. ``dtype=torch.bfloat16`` builds the models to compute
in bfloat16 (``cli.evaluate --bf16``); top-1 can then differ from float32's
on borderline clips.

Data-parallel evaluation (``mesh=``, or ``data_parallel=True`` for a mesh
over every local card; ``cli.evaluate --data_parallel``) cuts each batch
over the mesh's positions, in row-major order: each distinct device runs its
replica of the model over its pieces, and the logits are gathered in clip
order on the first device, where top-1 is taken as in the serial loop. A
batch that does not divide over the mesh runs whole on the first device,
with one warning (``i2v_tpu/eval/transfer.py:70-96``).
"""

from __future__ import annotations

import csv
import gc
import json
import os
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import threaded_prefetch
from ..models.video_zoo import get_video_model
from ..parallel.mesh import Mesh, Sharding, attack_mesh, move
from ..parallel.replicas import replicas_for
from ..utils import VIDEO_MODEL_NAMES, AverageMeter, artifacts
from ..utils.profiling import next_number, span


def accuracy_and_preds(logits: torch.Tensor, labels: torch.Tensor):
    """Top-1 accuracy (%) and predictions, on the logits' device (reference:
    reference.py:28-36): the float32 mean of the hits, times 100. The argmax
    is taken of the logits as the model gives them (a bfloat16 model's
    logits are bfloat16 values in float32) and picks the first index on a
    tie, as ``jnp.argmax`` does; ties are far more common in bfloat16."""
    preds = torch.argmax(logits, dim=-1)
    acc = 100.0 * (preds == labels).to(torch.float32).mean()
    return acc, preds


def order_predictions_by_label(labels, preds, n_classes: int) -> np.ndarray:
    """Reorder predictions into label order for the report CSV (reference:
    reference.py:116-119; the label doubles as the sample id).

    A malformed artifact directory fails loudly rather than giving a quietly
    wrong CSV: an out-of-range label (a file from another dataset) or a
    duplicate label (two artifacts claiming one sample id) raises. Labels
    absent from the run (partial or sharded generation) stay ``-1``."""
    ordered = np.zeros(n_classes, dtype=np.int64) - 1
    seen: set[int] = set()
    for lab, pred in zip(labels, preds):
        lab = int(lab)
        if not 0 <= lab < n_classes:
            raise ValueError(
                f"artifact label {lab} outside [0, {n_classes}) — the run "
                "directory mixes artifacts from a different dataset")
        if lab in seen:
            raise ValueError(
                f"duplicate artifact label {lab} — two artifacts claim the "
                "same sample id; the run directory is malformed")
        seen.add(lab)
        ordered[lab] = pred
    return ordered


def _make_uploader(mesh: Optional[Mesh], device: torch.device):
    """→ (``upload``, whether host batches are pinned): ``upload`` takes host
    clips (a tensor, pinned for a card) and labels → (the clips on the
    device, or a list of one piece a mesh position; the labels on the first
    device). A batch that does not divide over the mesh goes whole to its
    first device, with one warning for the run."""
    sharding = None if mesh is None else Sharding(mesh, tuple(mesh.axis_names))
    home = device if mesh is None else mesh.positions[0]
    pin = home.type == "cuda"
    warned: list = []

    def upload(clips_t: torch.Tensor, labels: np.ndarray, unit):
        labels_t = torch.from_numpy(labels.astype(np.int64))
        with span("ingest.pin", unit=unit):
            if pin:
                labels_t = labels_t.pin_memory()
        with span("ingest.upload", unit=unit):
            dlabels = move(labels_t, home)
            if sharding is not None and clips_t.shape[0] % sharding.n_pieces == 0:
                return sharding.split(clips_t).pieces, dlabels
            if sharding is not None and not warned:
                warned.append(True)
                warnings.warn(
                    f"dp eval: batch of {clips_t.shape[0]} does not divide the {mesh.size}-position "
                    "mesh; running this batch on a single device (pick a batch_size divisible by "
                    "the device count to keep eval data-parallel)")
            return move(clips_t, home), dlabels

    return upload, pin


def _prefetched_uploads(files_batches: Sequence[Sequence[str]], run_dir: str,
                        device: torch.device, mesh: Optional[Mesh] = None, sweep=None):
    """Iterator of (device clips or their mesh pieces, device labels, host
    labels). The worker thread reads each batch straight into a pinned host
    buffer (for a card; from PyTorch's caching host allocator, which hands a
    buffer out again once its copy has completed) and starts its upload, so
    that disk reads and the copy overlap the consumer's forwards. At most
    three batches are on the device (in use, queued, in the worker's
    hands): a B=16 batch is 308 MB. The worker's spans name their batch
    ``(sweep, index)``."""
    upload, pin = _make_uploader(mesh, device)

    def uploaded():
        for step, files in enumerate(files_batches):
            with span("ingest.read", unit=(sweep, step)):
                clips = torch.empty(artifacts.batch_shape(run_dir, files), dtype=torch.float32,
                                    pin_memory=pin)
                _, labels = artifacts.load_adv_batch(run_dir, files, out=clips.numpy())
            yield upload(clips, labels, (sweep, step)) + (labels,)

    return threaded_prefetch(uploaded)


def _waited(batches, n: int, sweep: int):
    """``(index, seconds waited, batch)`` of the first ``n`` of ``batches``:
    each blocking ``next`` is the span ``eval.ingest_wait``, and the same
    ``perf_counter`` readings give the loop's ``data_time``."""
    for step in range(n):
        t0 = time.perf_counter()
        with span("eval.ingest_wait", unit=(sweep, step)):
            batch = next(batches)
        yield step, time.perf_counter() - t0, batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log_progress(log, step: int, n: int, data_time, batch_time, top1: dict, title: str):
    log(f"----{title}----")
    log(f"Process: [{step + 1}/{n}]")
    log(f"data_time: {data_time.val:.3f}, batch time: {batch_time.val:.3f}")
    for name, meter in top1.items():
        log(f"top-1 accuracy{f' [{name}]' if name else ''}: {meter.avg:.2f}%")


def _eval_loop(bundles: dict, files_batches: Sequence[Sequence[str]], run_dir: str, *,
               mesh: Optional[Mesh], log, graphs: bool, title: str):
    """The one batch loop of both modes → ({name: preds}, labels, {name:
    top1_avg}): each uploaded batch through every model of ``bundles``, all
    forwards issued before any fetch; the serial mode's is one model."""
    device = next(iter(bundles.values())).device
    data_time, batch_time = AverageMeter(), AverageMeter()
    top1 = {name: AverageMeter() for name in bundles}
    predictions: dict = {name: [] for name in bundles}
    labels_all: list[int] = []
    sweep = next_number("eval.sweep")
    with span("eval.sweep", unit=sweep):
        replicas = {name: replicas_for(b, mesh, graphs=graphs) for name, b in bundles.items()}
        positions = None if mesh is None else mesh.positions
        with torch.inference_mode():
            batches = _prefetched_uploads(files_batches, run_dir, device, mesh, sweep)
            end = time.perf_counter()
            for step, wait, (clips, dlabels, labels) in _waited(batches, len(files_batches), sweep):
                data_time.update(wait)
                with span("eval.forward", unit=(sweep, step)):
                    pending = {name: r.predict(clips, positions, dlabels)[1:]
                               for name, r in replicas.items()}
                with span("eval.fetch", unit=(sweep, step)):
                    for name, (acc, preds) in pending.items():
                        predictions[name] += preds.cpu().tolist()
                        top1[name].update(float(acc), len(labels))
                labels_all += labels.tolist()
                now = time.perf_counter()
                batch_time.update(now - end)
                end = now
                if step % 5 == 0:
                    _log_progress(log, step, len(files_batches), data_time, batch_time, top1,
                                  title)
    return predictions, labels_all, {n: m.avg for n, m in top1.items()}


def reference_eval(bundle, files_batches: Sequence[Sequence[str]], run_dir: str, *,
                   mesh: Optional[Mesh] = None, log=print, graphs: bool = True):
    """Evaluate one model over artifact batches → (preds, labels, top1_avg).

    Artifacts are normalized-domain clips (the protocol); the bundle's
    ``apply_norm`` takes them as they are. With a ``mesh``, each batch is
    cut over its positions (data-parallel evaluation). The forward and
    top-1 of each batch shape are one CUDA graph on a card, held on the
    bundle with its replicas (:func:`~i2v_tpu_torch.parallel.replicas.replicas_for`);
    ``graphs=False`` runs them eagerly."""
    preds, labels, top1 = _eval_loop({"": bundle}, files_batches, run_dir, mesh=mesh, log=log,
                                     graphs=graphs, title="validation")
    return preds[""], labels, top1[""]


def single_pass_eval(bundles: dict, files_batches: Sequence[Sequence[str]], run_dir: str, *,
                     mesh: Optional[Mesh] = None, log=print, graphs: bool = True):
    """Evaluate every model over each uploaded batch → ({model: preds},
    labels, {model: top1_avg}).

    The reference reads and uploads every artifact once per model
    (reference.py:108-125); here each batch is read and uploaded once, and
    every model's forward is issued before any result is fetched, so the
    card runs them back to back. The reports are the serial mode's. With a
    ``mesh``, each batch is cut over its positions. Each model's forward is
    a graph as in :func:`reference_eval`."""
    return _eval_loop(bundles, files_batches, run_dir, mesh=mesh, log=log, graphs=graphs,
                      title="validation (single pass, all models)")


def write_reports(run_dir: str, columns: dict, n_classes: int, model_val_acc: dict,
                  suffix: str = "") -> None:
    """The CSV as ``pandas.DataFrame.to_csv(index=False)`` writes it
    (QUOTE_MINIMAL, ``\\n`` line ends, integer cells) and the JSON as
    ``json.dump`` writes it; ``suffix`` goes before each file's extension."""
    with open(os.path.join(run_dir, f"results_all_models_prediction{suffix}.csv"), "w",
              newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["gt_label"] + [f"{name}-pre" for name in columns])
        for label in range(n_classes):
            w.writerow([label] + [int(col[label]) for col in columns.values()])
    with open(os.path.join(run_dir, f"top1_acc_all_models{suffix}.json"), "w") as f:
        json.dump(model_val_acc, f)


def evaluate_run(
    run_dir: str,
    *,
    model_names: Optional[Sequence[str]] = None,
    batch_size: int = 16,
    n_classes: int = 400,
    ucf101: bool = False,
    tiny: bool = False,
    dtype: torch.dtype = torch.float32,
    get_bundle: Optional[Callable] = None,
    device: torch.device | str = "cuda",
    mesh=None,
    data_parallel: bool = False,
    single_pass: bool = False,
    throughput: Optional[dict] = None,
    log=print,
) -> dict:
    """Evaluate a run directory against the video models (default: the
    reference's six, ``VIDEO_MODEL_NAMES``; ``swin3d_b``, ``mvit_v2_b`` and
    ``uniformer_b`` where named) and
    write the two reports into it. Returns ``{model: top1}``.

    ``dtype`` is the models' compute dtype. ``get_bundle(name)`` supplies a
    model in place of ``get_video_model(name, device=device, dtype=dtype,
    ...)``, and a model of another compute dtype than ``dtype`` is refused,
    so that the reports say what they were computed in. ``single_pass=True``
    keeps all models resident and reads and uploads each batch once.
    ``mesh`` (or ``data_parallel=True``: :func:`attack_mesh` over every local
    card for ``device="cuda"``, else over ``device`` alone) cuts each batch
    over the mesh's positions; the models are built on its first device. A
    ``throughput`` dict is filled with the clips/s of each model's
    evaluation (serial) or of the whole pass (``"single_pass"``), each timed
    on the host's clock around work that ends in a device synchronize."""
    device = torch.device(device)
    if data_parallel and mesh is None:
        # this process's devices only: each process of a multi-process run
        # evaluates its own artifact shard over its own card
        mesh = attack_mesh(None if device == torch.device("cuda") else [device])
    if mesh is not None:
        device = mesh.positions[0]
    files = artifacts.list_adv_files(run_dir)
    if not files:
        raise FileNotFoundError(f"no adv artifacts under {run_dir!r}")
    batches = artifacts.batch_files(files, batch_size)
    if model_names is None:
        model_names = list(VIDEO_MODEL_NAMES)
    throughput = {} if throughput is None else throughput

    def build(name):
        if get_bundle is None:
            return get_video_model(name, device=device, tiny=tiny, ucf101=ucf101, dtype=dtype)
        bundle = get_bundle(name)
        if bundle.dtype != dtype:
            raise ValueError(f"{name} computes in {bundle.dtype}, the evaluation in {dtype}")
        return bundle

    def timed(key: str, dev: torch.device, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        elapsed = time.perf_counter() - t0
        throughput[key] = {"clips": len(files), "elapsed_s": elapsed,
                           "clips_per_sec": len(files) / elapsed}
        return out

    columns: dict = {}
    model_val_acc: dict = {}
    if single_pass:
        bundles = {name: build(name) for name in model_names}
        log(f"Models (single pass): {', '.join(model_names)}")
        dev = next(iter(bundles.values())).device
        preds_by_model, labels, model_val_acc = timed(
            "single_pass", dev,
            lambda: single_pass_eval(bundles, batches, run_dir, mesh=mesh, log=log))
        for name in model_names:
            columns[name] = order_predictions_by_label(labels, preds_by_model[name], n_classes)
    else:
        for name in model_names:
            log(f"Model-{name}:")
            bundle = build(name)
            dev = bundle.device
            preds, labels, top1 = timed(
                name, dev, lambda: reference_eval(bundle, batches, run_dir, mesh=mesh, log=log))
            columns[name] = order_predictions_by_label(labels, preds, n_classes)
            model_val_acc[name] = top1
            # the reference's model swap (reference.py:124-125); the bundle
            # and the replicas it holds refer to each other
            del bundle
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    write_reports(run_dir, columns, n_classes, model_val_acc)
    return model_val_acc
