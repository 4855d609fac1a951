"""Multi-process launches: initialization and per-process sample sharding.

PyTorch counterpart of :mod:`i2v_tpu.parallel.dist`. It replaces the
reference's manual ``--batch_nums/--batch_index`` process sharding
(image_main.py:18-19,61-63): each process takes a contiguous slice of the
sample manifest and attacks it on its own card, and all write into one run
directory, which a single ``cli.evaluate`` then reads. No tensor crosses
processes on this path (as none does in the JAX package, whose
``jax.distributed.initialize`` only sets up the coordinator), so the process
group is ``gloo``, whatever the cards.

Launch contract, PyTorch's own (``torchrun`` sets it): ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` on every
process, for example

    torchrun --nproc_per_node 2 -m i2v_tpu_torch.cli.image_main ...

or, as JAX's second branch, a SLURM launch of more than one task
(``SLURM_NTASKS``, ``SLURM_PROCID``, ``SLURM_LOCALID``) with ``MASTER_ADDR``
and ``MASTER_PORT`` set by the batch script.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as tdist


def _launch_env() -> Optional[dict]:
    """``{rank, world_size, local_rank}`` of a multi-process launch, else None."""
    env = os.environ
    if int(env.get("WORLD_SIZE", "1")) > 1:
        return {"rank": int(env["RANK"]), "world_size": int(env["WORLD_SIZE"]),
                "local_rank": int(env.get("LOCAL_RANK", env["RANK"]))}
    if int(env.get("SLURM_NTASKS", "1")) > 1:
        # without this a SLURM multi-task launch would run every task over
        # the whole sample set
        return {"rank": int(env["SLURM_PROCID"]), "world_size": int(env["SLURM_NTASKS"]),
                "local_rank": int(env.get("SLURM_LOCALID", "0"))}
    return None


def maybe_initialize_distributed() -> bool:
    """Join the process group of a multi-process launch (a no-op otherwise)
    and return whether one is active. Idempotent: the CLI entry points call
    it unconditionally."""
    if tdist.is_available() and tdist.is_initialized():
        return True
    launch = _launch_env()
    if launch is None:
        return False
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"a launch of {launch['world_size']} processes needs {var} "
                               "(the address of process 0)")
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=launch["rank"], world_size=launch["world_size"])
    return True


def process_count() -> int:
    """The launch's process count (1 without a process group)."""
    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def local_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK % device_count}``, so that
    processes on one host spread over its cards (and share them when there
    are fewer cards than processes). Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this process")
    launch = _launch_env()
    local_rank = 0 if launch is None else launch["local_rank"]
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def process_shard_bounds(n_samples: int, n_shards: int | None = None,
                         shard_index: int | None = None) -> tuple[int, int]:
    """[left, right) bounds of this shard: contiguous, the remainder to the
    last one.

    Defaults to (:func:`process_count`, :func:`process_index`); explicit
    values reproduce the reference's 1-based --batch_index CLI contract when
    passed as (batch_nums, batch_index-1)."""
    if n_shards is None:
        n_shards = process_count()
    if shard_index is None:
        shard_index = process_index()
    if n_shards < 1 or not 0 <= shard_index < n_shards:
        # a 0-based --batch_index habit would otherwise wrap via Python
        # negative indexing and silently attack the wrong shard
        raise ValueError(
            f"shard index {shard_index} out of range for {n_shards} shards "
            "(the CLI --batch_index contract is 1-based, image_main.py:18-19)")
    per = n_samples // n_shards
    left = shard_index * per
    right = n_samples if shard_index == n_shards - 1 else left + per
    return left, right
