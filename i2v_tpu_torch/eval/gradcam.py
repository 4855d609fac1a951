"""Grad-CAM saliency (reference C21: image_cam.py + image_cam_utils.py).

PyTorch counterpart of :mod:`i2v_tpu.eval.gradcam`. For a tapped image
bundle:

    cam = ReLU(Σ_k mean_spatial(∂logit_y/∂A_k) · A_k),  min-max normalized,

nearest-upsampled to the input size (reference: image_cam.py:97-140).

∂logit/∂(tap activation) is exact: every image module takes a
``tap_offset`` added to the tap in-flow, and the gradient is taken with
respect to that offset at 0. One forward and one backward give a map: the
offset's shape comes from a forward on the meta device (shapes only, no
compute: the counterpart of ``jax.eval_shape``), and the tap activations
come back from the same forward that scores the class. The offset stays in
the graph from the input through the tap to the logits, so
:func:`grad_cam_update` differentiates the map itself (second order).

Maps are NCHW-derived: the channel axis of an activation is 1. ViT taps are
tokens (b, n, dim), not maps; they are refused with a ``ValueError``.

:class:`CamEvaluator` is the CLI's evaluator, the counterpart of the JAX
CLI's one jitted evaluator a bundle (``i2v_tpu/cli/gradcam.py:71-83``): one
capture-ready step a frame-batch shape, with a static frames buffer, the
shapes taken once and a static zero offset, run as a CUDA graph on a card
(:mod:`i2v_tpu_torch.utils.graphs`). :func:`grad_cam`,
:func:`grad_cam_update` and :func:`average_grad_cam` stay eager, for the
callers that differentiate through the map.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..models.api import ImageModel
from ..utils.graphs import StepGraph


def _shapes(bundle: ImageModel, frames01: torch.Tensor):
    """(logits shape or None, tap shape) of ``bundle`` on ``frames01``, from a
    forward on the meta device: parameters and input stand in as meta
    tensors, so nothing is computed or copied."""
    module = bundle.module
    meta = {n: p.to("meta") for n, p in module.named_parameters()}
    logits, taps = functional_call(module, meta, (frames01.to("meta"),))
    return (None if logits is None else logits.shape), taps[bundle.tap_keys[0]].shape


def _checked_shapes(bundle: ImageModel, frames01: torch.Tensor):
    """The tap's shape, for a bundle that can give a Grad-CAM map."""
    logits_shape, acts_shape = _shapes(bundle, frames01)
    if logits_shape is None:
        raise ValueError(
            f"GradCAM needs logits, but bundle {bundle.name!r} was built "
            "truncated (logits=None); build it with truncate=False")
    if len(acts_shape) != 4:
        raise ValueError(
            f"GradCAM needs a spatial feature map (N, C, h, w), but bundle "
            f"{bundle.name!r} taps {tuple(acts_shape)}: ViT taps are tokens "
            "(b, n, dim), which have no spatial map to weigh")
    return acts_shape


def _cam_raw(bundle: ImageModel, frames01: torch.Tensor, labels, create_graph: bool = False):
    """(cam (B, h, w), acts) before normalization, from one forward and one
    backward. With ``labels=None`` the class is the argmax of the same
    forward's logits (the offset is 0, so they are the plain logits).
    ``create_graph`` keeps the map differentiable w.r.t. ``frames01``."""
    offset = torch.zeros(_checked_shapes(bundle, frames01), dtype=frames01.dtype,
                         device=frames01.device, requires_grad=True)
    return _cam_at(bundle, frames01, labels, offset, create_graph)


def _cam_at(bundle: ImageModel, frames01: torch.Tensor, labels, offset: torch.Tensor,
            create_graph: bool = False):
    """:func:`_cam_raw` with the tap's zero ``offset`` (a leaf that requires
    its gradient) given."""
    key = bundle.tap_keys[0]
    with torch.enable_grad():
        logits, taps = bundle.module(frames01, tap_offset={key: offset})
        labs = (logits.argmax(-1) if labels is None
                else torch.as_tensor(labels, device=logits.device).long())
        score = torch.gather(logits, 1, labs[:, None]).sum()
        (grads,) = torch.autograd.grad(score, offset, create_graph=create_graph)
    acts = taps[key]
    if not create_graph:
        acts = acts.detach()
    weights = torch.mean(grads, dim=(2, 3), keepdim=True)  # α_k, GAP of the grads
    return torch.relu(torch.sum(weights * acts, dim=1)), acts


class _CamStep:
    """One bundle's raw map of one frame-batch shape as a capture-ready
    step: the frames are copied into a static buffer, and the forward, the
    offset's backward and the map write a static output."""

    def __init__(self, bundle: ImageModel, frames01: torch.Tensor, graphs: bool):
        self.bundle = bundle
        self.x = torch.empty_like(frames01)
        self.offset = torch.zeros(_checked_shapes(bundle, frames01), dtype=frames01.dtype,
                                  device=frames01.device, requires_grad=True)
        self.cam = None
        self.graph = StepGraph(self._step, frames01.device, enabled=graphs)

    def _step(self) -> None:
        cam, _ = _cam_at(self.bundle, self.x, None, self.offset)
        if self.cam is None:  # step 0 is eager: made outside any capture
            self.cam = cam
        else:
            self.cam.copy_(cam)

    def __call__(self, frames01: torch.Tensor) -> torch.Tensor:
        self.x.copy_(frames01)
        self.graph()
        return self.cam


class CamEvaluator:
    """``evaluator(frames01 (N, 3, H, W)) -> (N, h, w)``: ``bundle``'s raw
    Grad-CAM map at the argmax class (:func:`_cam_raw` with ``labels=None``,
    bit for bit on the CPU), one :class:`_CamStep` a frame-batch shape,
    dtype and device (``steps``): on a card a CUDA graph from the second
    call of a shape on (``graphs=False``: eager). The map returned is the
    step's static output: read it before the next call of its shape."""

    def __init__(self, bundle: ImageModel, graphs: bool = True):
        self.bundle, self.graphs = bundle, graphs
        self.steps: dict = {}

    def __call__(self, frames01: torch.Tensor) -> torch.Tensor:
        key = (tuple(frames01.shape), frames01.dtype, frames01.device)
        if key not in self.steps:
            self.steps[key] = _CamStep(self.bundle, frames01, self.graphs)
        return self.steps[key](frames01)


def _minmax(cam: torch.Tensor) -> torch.Tensor:
    # GLOBAL min/max over the whole batch tensor — the reference normalizes
    # with scalar saliency_map.min()/.max() (image_cam.py:128-129), so all
    # frames of a clip share one scale
    lo, hi = torch.min(cam), torch.max(cam)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-12)


def _upsample(cam: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest upsample of (B, h, w) to (B, size, size) by an integer gather,
    row/column ``(arange(size)·h) // size``: no float scale involved."""
    idx_r = (torch.arange(size, device=cam.device) * cam.shape[1]) // size
    idx_c = (torch.arange(size, device=cam.device) * cam.shape[2]) // size
    return cam.index_select(1, idx_r).index_select(2, idx_c)


def grad_cam(bundle: ImageModel, frames01: torch.Tensor, labels=None,
             upsample_to: Optional[int] = None) -> torch.Tensor:
    """Normalized saliency maps (B, H, W) in [0,1] for the bundle's first tap."""
    cam, _ = _cam_raw(bundle, frames01, labels)
    cam = _minmax(cam)
    if upsample_to:
        cam = _upsample(cam, upsample_to)
    return cam


def grad_cam_update(bundle: ImageModel, frames01: torch.Tensor, ref_cam, labels=None):
    """The 'update' branch: gradient of the summed PER-SAMPLE L2 norms
    ‖cam_i(x) − ref_i‖₂ w.r.t. x (image_cam.py:132-138 computes dim=1 norms
    and backprops grad_outputs=ones, i.e. their sum). The reference's own
    update branch detaches the map via ``.data`` before building the cost
    and cannot run as written; this implements its intent, as the JAX
    package does."""
    x = frames01.detach().requires_grad_(True)
    ref = torch.as_tensor(ref_cam, device=x.device)
    with torch.enable_grad():
        cam, _ = _cam_raw(bundle, x, labels, create_graph=True)
        diff = (_minmax(cam) - ref).reshape(cam.shape[0], -1)
        loss = torch.sum(torch.sqrt(torch.sum(diff * diff, dim=1) + 1e-24))
        (g,) = torch.autograd.grad(loss, x)
    return g


def minmax_per_clip(cam: torch.Tensor, frames_per_clip: int) -> torch.Tensor:
    """Min-max scale a stacked-frame cam (B·T, h, w) with scalar min/max per
    CLIP of ``frames_per_clip`` frames — the reference normalizes one clip's
    stacked frames with scalar saliency_map.min()/.max() (image_cam.py:
    128-129), so a clip's mask must not depend on its batch-mates."""
    per = cam.reshape(-1, frames_per_clip, *cam.shape[1:])
    lo = torch.amin(per, dim=(1, 2, 3), keepdim=True)
    hi = torch.amax(per, dim=(1, 2, 3), keepdim=True)
    return ((per - lo) / torch.clamp(hi - lo, min=1e-12)).reshape(cam.shape)


def average_grad_cam(bundles: Sequence[ImageModel], frames01: torch.Tensor,
                     upsample_to: int = 224,
                     frames_per_clip: Optional[int] = None) -> torch.Tensor:
    """Mean saliency over several image models, each at its own tap
    (reference: average_grad_cam_from_images, image_cam.py:9-37; that code
    stacks maps of UNEQUAL spatial sizes, unrunnable as written, so maps are
    upsampled to a common size before averaging).

    ``frames_per_clip``: when the frame batch stacks several clips, each
    model's cam is min-max scaled per clip (:func:`minmax_per_clip`) instead
    of over the whole batch, so that every clip's mask is independent of its
    batch-mates; by default one global min/max (the same when the batch is
    one clip)."""
    cams = []
    for b in bundles:
        cam, _ = _cam_raw(b, frames01, None)
        cam = (_minmax(cam) if frames_per_clip is None
               else minmax_per_clip(cam, frames_per_clip))
        cams.append(_upsample(cam, upsample_to))
    return torch.mean(torch.stack(cams), dim=0)


# ---------------------------------------------------------------------------
# visualization (cv2-free)
# ---------------------------------------------------------------------------

def _jet(v: np.ndarray) -> np.ndarray:
    """Jet colormap: v in [0,1] → RGB in [0,1]."""
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def visualize_cam(cam, frame01, alpha: float = 0.5) -> np.ndarray:
    """Overlay a (H,W) cam onto an (H,W,3) [0,1] frame → uint8 RGB image
    (reference: image_cam_utils.visualize_cam)."""
    heat = _jet(_host(cam))
    out = alpha * heat + (1 - alpha) * _host(frame01)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
