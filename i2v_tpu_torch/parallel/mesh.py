"""Device mesh and dim-0 shardings over a grid of ``torch.device``\\ s.

PyTorch counterpart of :mod:`i2v_tpu.parallel.mesh`. The JAX mesh is
single-controller: one process holds ``jax.devices()`` and XLA inserts the
collectives its sharding annotations imply. Here one process holds a grid of
``torch.device``\\ s, a tensor laid out over it is a list of per-position
pieces (:class:`Sharded`), and the runners reduce across positions
explicitly: each position's cost (and, on the model axis, its gradient) is
copied to the reducing device without the host waiting (:func:`move`) and
summed there in position order, so the result does not depend on which card
finishes first.

Axes of :func:`attack_mesh`:
  - ``data``   — the clip batch axis
  - ``frames`` — the flattened B·T frame axis of the image-guided attacks

A position is a cell of the grid, in row-major order. A device may fill
several positions (``[torch.device("cpu")] * 4``, or ``[cuda:0] * 4`` on a
one-card machine): the counterpart of the JAX suite's
``--xla_force_host_platform_device_count``. Its positions then run one after
another, and share one copy of each model and of each piece they hold.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices: ``devices`` is a numpy object array of
    ``torch.device``\\ s with one dimension per name in ``axis_names``. Two
    meshes are equal when they lay out the same devices under the same
    names."""

    devices: np.ndarray
    axis_names: tuple

    def _key(self) -> tuple:
        return self.axis_names, self.devices.shape, tuple(self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> list:
        """The device of each position, in row-major order."""
        return list(self.devices.flat)

    @property
    def distinct_devices(self) -> list:
        """Each device once, in the order of its first position."""
        return list(dict.fromkeys(self.positions))


def move(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``, without the host waiting where the destination is
    a card (a copy to the host waits, so that the host never reads a buffer
    still being written).

    A copy from one card to another goes through the destination's side
    stream (:func:`_side_stream`): PyTorch makes the stream that runs a peer
    copy wait for all the work queued so far on the destination's current
    stream, and were that the destination's compute stream, the source card
    would stall until the destination caught up, and the cards of a mesh
    would take their turns one after another. The destination's compute
    stream then waits for the copy alone."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if t.device == device:
        return t
    if not (t.is_cuda and device.type == "cuda"):
        return t.to(device, non_blocking=device.type == "cuda")
    side = _side_stream(device.index)
    with torch.cuda.stream(side):
        out = t.to(device, non_blocking=True)
    compute = torch.cuda.current_stream(device)
    compute.wait_stream(side)
    # allocated on the side stream, read on the compute stream
    out.record_stream(compute)
    return out


@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> "torch.cuda.Stream":
    """One stream a card for the peer copies of :func:`move`."""
    return torch.cuda.Stream(torch.device("cuda", index))


def make_mesh(devices: Sequence, shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A :class:`Mesh` of ``devices`` laid out row-major in ``shape``."""
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(tuple(shape)), tuple(axis_names))


def local_devices() -> list:
    """Every CUDA device of this process. Without a card this raises: a
    multi-device path never falls back to the CPU (pass the CPU explicitly,
    as ``[torch.device("cpu")] * n``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the device mesh (pass the "
                           "devices explicitly, e.g. [torch.device('cpu')], to run on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def attack_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
                frames: Optional[int] = None) -> Mesh:
    """A ``('data', 'frames')`` mesh over ``devices`` (default: every local
    CUDA device, :func:`local_devices`).

    With no sizes given, the device count splits into its most-square
    factorization with the larger factor on the frame axis (the B·T frame
    count is never below the clip count, so it shards further)."""
    if devices is None:
        devices = local_devices()
    n = len(devices)
    if data is None and frames is None:
        data = 1
        for d in range(int(math.isqrt(n)), 0, -1):
            if n % d == 0:
                data = d
                break
        frames = n // data
    elif data is None:
        data = n // frames
    elif frames is None:
        frames = n // data
    if data * frames != n:
        raise ValueError(f"data({data})×frames({frames}) != devices({n})")
    return make_mesh(devices, (data, frames), ("data", "frames"))


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Dim 0 cut into contiguous pieces over the mesh axes ``axes`` (in
    row-major order over them, the JAX ``P(axes)``) and replicated over the
    mesh's other axes; ``axes=()`` replicates the whole tensor."""

    mesh: Mesh
    axes: tuple

    @property
    def n_pieces(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axes], dtype=np.int64))

    def piece_of(self) -> list:
        """The piece index that each mesh position (row-major) holds."""
        idx = np.indices(self.mesh.devices.shape).reshape(self.mesh.devices.ndim, -1)
        names = list(self.mesh.axis_names)
        out = np.zeros(idx.shape[1], dtype=np.int64)
        for a in self.axes:
            out = out * self.mesh.shape[a] + idx[names.index(a)]
        return out.tolist()

    def split(self, x: torch.Tensor) -> "Sharded":
        """``x`` cut along dim 0, each piece on its positions' device. A
        piece that several positions of one device hold is one tensor, moved
        there once (:func:`move`)."""
        x = torch.as_tensor(x)
        k = self.n_pieces
        if x.shape[0] % k:
            raise ValueError(f"dim 0 of size {x.shape[0]} does not divide into {k} pieces "
                             f"over mesh axes {self.axes}")
        per = x.shape[0] // k
        placed: dict = {}
        pieces = []
        for piece, dev in zip(self.piece_of(), self.mesh.positions):
            if (piece, dev) not in placed:
                placed[piece, dev] = move(x[piece * per:(piece + 1) * per], dev)
            pieces.append(placed[piece, dev])
        return Sharded(self, pieces)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor laid out by ``sharding``: one piece for each mesh position,
    in row-major order, on that position's device."""

    sharding: Sharding
    pieces: list

    @property
    def shape(self) -> tuple:
        first = self.pieces[0]
        return (first.shape[0] * self.sharding.n_pieces,) + tuple(first.shape[1:])

    def distinct_pieces(self) -> list:
        """Piece 0, 1, … once each: the copy held by its first position."""
        first: dict = {}
        for piece, t in zip(self.sharding.piece_of(), self.pieces):
            first.setdefault(piece, t)
        return [first[i] for i in range(self.sharding.n_pieces)]

    def map(self, fn) -> "Sharded":
        """``fn`` applied to each distinct tensor once, the layout kept."""
        done: dict = {}
        out = []
        for t in self.pieces:
            if id(t) not in done:
                done[id(t)] = fn(t)
            out.append(done[id(t)])
        return Sharded(self.sharding, out)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first position's)."""
        device = self.sharding.mesh.positions[0] if device is None else torch.device(device)
        return torch.cat([move(p, device) for p in self.distinct_pieces()])


def clip_sharding(mesh: Mesh) -> Sharding:
    """(B, C, T, H, W) clips: the batch over ``data``."""
    return Sharding(mesh, ("data",))


def frame_sharding(mesh: Mesh) -> Sharding:
    """(B·T, C, H, W) frame batches: the frame axis over both mesh axes."""
    return Sharding(mesh, ("data", "frames"))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_clips(batch, mesh: Mesh) -> Sharded:
    """Lay a clip batch (host array or tensor) out with the clip sharding."""
    return clip_sharding(mesh).split(torch.as_tensor(batch))


def gather(x: Sharded, device=None) -> torch.Tensor:
    """The whole of a :class:`Sharded` tensor on ``device``."""
    return x.gather(device)
