"""Attack runners on one device or a device mesh, and multi-process launches.

PyTorch counterpart of :mod:`i2v_tpu.parallel`:

  - :mod:`mesh`      — ``attack_mesh`` and the dim-0 shardings over a grid of
                       ``torch.device``\\ s (a device may fill several
                       positions); ``shard_clips`` and ``gather``
  - :mod:`sharded`   — ``make_sharded_i2v_runner``, the I2V / ENS-I2V /
                       AENS-I2V-MF Adam runner with exact frame-chunked
                       gradient accumulation, warm starts, resumable Adam
                       state and a pad-clip mask, on one device or with the
                       frame batch cut over a mesh; ``ShardedImageGuidedAttack``
                       puts it behind the attack classes' calling convention
                       (``image_main --sharded``)
  - :mod:`multigrid` — ``make_multigrid_i2v_runner``, the coarse-to-fine
                       schedule built from two such runners
                       (``image_main --multigrid K``)
  - :mod:`ensemble`  — ``make_ensemble_parallel_runner``, the surrogates
                       split over a mesh's ``model`` axis
                       (``image_main --model_parallel N``)
  - :mod:`dist`      — multi-process initialization and per-process sample
                       sharding (the ``--batch_index`` replacement)
"""

from .dist import maybe_initialize_distributed, process_shard_bounds  # noqa: F401
from .ensemble import (EnsembleParallelAttack, ensemble_mesh,  # noqa: F401
                       make_ensemble_parallel_runner)
from .mesh import (attack_mesh, clip_sharding, frame_sharding, gather,  # noqa: F401
                   replicated, shard_clips)
from .multigrid import make_multigrid_i2v_runner  # noqa: F401
from .sharded import (AUTO_CHUNK_BYTES, ShardedImageGuidedAttack,  # noqa: F401
                      make_sharded_i2v_runner, resolve_frame_chunk)
