"""The check that decides ``correct``, at tiny sizes on the CPU: the port
passes it, a bfloat16 run of the program fails it, and so does each fault
a cell can have, planted under the harness in the program's timed path:
a step that leaves its state unchanged, half of the batch left out (the
cost taken over the rest, doubled), an answer altered where it is produced,
and two that act only after the call that set-up makes: a resumed call
that drops the Adam state it is handed, and a call that keeps the clips of
the call before it. On a card the TF32 control fails it too (``gpu``)."""

import pytest
import torch

from i2v_tpu_torch.attacks import i2v as attacks_i2v
from i2v_tpu_torch.eval import transfer
from i2v_tpu_torch.models.api import VideoModel
from i2v_tpu_torch.ops import kernels, losses, pixel
from i2v_tpu_torch.parallel import sharded
from i2v_tpu_torch.utils.graphs import TableAdam

GEN = ("ens_i2v.b16", "ens_i2v.b1")
EVAL = ("video6_eval.single_b16",)
# the runner's window call as a new batch's first, from the fill
NEW_BATCH = {"steps_per_call": 6}


def _failed(out):
    return sorted(k for k, c in out["checks"].items() if not c["value"] <= c["limit"])


@pytest.mark.parametrize("workload,traffic", [(w, None) for w in GEN + EVAL]
                         + [("ens_i2v.b16", NEW_BATCH)])
def test_port_is_correct(run_tiny, workload, traffic):
    out = run_tiny(workload, traffic=traffic)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", GEN + EVAL)
def test_bf16_control_fails(run_tiny, workload):
    out = run_tiny(workload, control="bf16")
    assert not out["correct"], out["checks"]


def _unchanged_state(monkeypatch):
    def step(self, grad):
        self.k.add_(1)

    monkeypatch.setattr(TableAdam, "step", step)


def _half_batch(monkeypatch):
    cost = losses.i2v_cost

    def half(taps_adv, taps_clean, frame_weights=None):
        n = taps_adv[0].shape[0] // 2
        return 2 * cost([a[:n] for a in taps_adv], [c[:n] for c in taps_clean])

    monkeypatch.setattr(losses, "i2v_cost", half)


def _altered_clip(monkeypatch):
    rebuild = kernels.rebuild_adv

    def altered(clean01, modifier, epsilon):
        out = rebuild(clean01, modifier, epsilon)
        if torch.is_grad_enabled():
            return out
        out = out.clone()
        out.view(-1)[0] = 0.0 if out.view(-1)[0] > 0.5 else 1.0
        return out

    monkeypatch.setattr(kernels, "rebuild_adv", altered)


def _dropped_opt_init(monkeypatch):
    """A resumed runner call that starts Adam afresh from the modifier."""
    make = sharded.make_sharded_i2v_runner

    def make_dropping(*args, **kwargs):
        runner = make(*args, **kwargs)

        def dropping(clean01, n_real=None, mod_init=None, opt_init=None):
            return runner(clean01, n_real, mod_init)

        return dropping

    monkeypatch.setattr(sharded, "make_sharded_i2v_runner", make_dropping)


def _stale_clips(monkeypatch):
    """A runner or engine that keeps its first call's clips (and clean taps)
    in its static buffers, where each later call copies its own in."""
    monkeypatch.setattr(sharded, "_load", lambda pos, frames, fmask: None)
    run = attacks_i2v._FrameAttack._run

    def stale(self, clean01):
        key = tuple(pixel.flatten_clip_to_frames(clean01).shape)
        if key not in self._loops:
            return run(self, clean01)
        adv_frames, records, state = self._loops[key][0].run(self._state0())
        return pixel.unflatten_frames_to_clip(adv_frames, clean01.shape[0]), records, state

    monkeypatch.setattr(attacks_i2v._FrameAttack, "_run", stale)


def _half_clips(monkeypatch):
    apply_norm = VideoModel.apply_norm

    def half(self, clips):
        n = clips.shape[0] // 2
        logits = apply_norm(self, clips[:n])
        return torch.cat([logits, logits[: clips.shape[0] - n]])

    monkeypatch.setattr(VideoModel, "apply_norm", half)


def _altered_pred(monkeypatch):
    top1 = transfer.accuracy_and_preds

    def altered(logits, labels):
        acc, preds = top1(logits, labels)
        preds = preds.clone()
        preds[0] = (preds[0] + 1) % logits.shape[1]
        return acc, preds

    monkeypatch.setattr(transfer, "accuracy_and_preds", altered)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in GEN for f in (_unchanged_state, _half_batch, _altered_clip)
] + [(w, f) for w in EVAL for f in (_half_clips, _altered_pred)])
def test_fault_fails(run_tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run_tiny(workload)
    assert not out["correct"], (fault.__name__, out["checks"])


@pytest.mark.parametrize("workload,fault,traffic", [
    ("ens_i2v.b16", _dropped_opt_init, None),
    ("ens_i2v.b16", _stale_clips, NEW_BATCH),
    ("ens_i2v.b1", _stale_clips, None),
])
def test_fault_after_the_first_call_fails(run_tiny, monkeypatch, workload, fault, traffic):
    """Set-up's call is sound under these faults; the window's call is not,
    and only the numbers of the window's call fail."""
    fault(monkeypatch)
    out = run_tiny(workload, traffic=traffic)
    failed = _failed(out)
    assert failed and not any(k.startswith("first_") for k in failed), (
        fault.__name__, out["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", GEN + EVAL)
def test_tf32_control_fails_on_card(cuda, workload):
    from port_bench import harness
    from port_bench.tests.conftest import REPO

    bench = harness.Bench.at(REPO)
    small = {"traffic": {"batch": 2, "artifacts": 4, "sweep_clips": 4, "pool_clips": 2}}
    runs = {c: harness.run_cell(bench, workload, seed=7, seconds=0.1, trace=False, device=cuda,
                                t_start=0.0, overrides=small, control=c, log=lambda *a: None)
            for c in (None, "tf32")}
    assert runs[None]["correct"], runs[None]["checks"]
    assert not runs["tf32"]["correct"], runs["tf32"]["checks"]
