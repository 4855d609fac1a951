"""Frame-chunked attack runners on one device.

PyTorch counterpart of :mod:`i2v_tpu.parallel` without the mesh:

  - :mod:`sharded`   — ``make_sharded_i2v_runner``, the I2V / ENS-I2V /
                       AENS-I2V-MF Adam runner with exact frame-chunked
                       gradient accumulation, warm starts, resumable Adam
                       state and a pad-clip mask; ``ShardedImageGuidedAttack``
                       puts it behind the attack classes' calling convention
                       (``image_main --sharded``)
  - :mod:`multigrid` — ``make_multigrid_i2v_runner``, the coarse-to-fine
                       schedule built from two such runners
                       (``image_main --multigrid K``)

There is no mesh: one card holds the whole frame batch, and a frame chunk
bounds how many frames' activations are alive at once. The JAX package's
``mesh.py``, ``dist.py`` and ``ensemble.py`` (``--model_parallel``) wait for
ROADMAP Queue 1, item 9 (multi-device).
"""

from .multigrid import make_multigrid_i2v_runner  # noqa: F401
from .sharded import (AUTO_CHUNK_BYTES, ShardedImageGuidedAttack,  # noqa: F401
                      make_sharded_i2v_runner, resolve_frame_chunk)
