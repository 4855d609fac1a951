"""The Kinetics-400 batcher contract (the dataset itself is not ported yet).

``iterate_batches`` is the port of ``i2v_tpu.data.kinetics.iterate_batches``;
every dataset of the port yields its items through it.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def iterate_batches(dataset, batch_size: int, left: int = 0,
                    right: Optional[int] = None) -> Iterator[dict]:
    """Sequential batcher over a [left, right) manifest shard. Returns dicts
    with stacked 'clips' (B,3,T,H,W), 'labels', 'names', 'clip_inds'."""
    right = len(dataset) if right is None else min(right, len(dataset))
    batched = getattr(dataset, "load_batch", None)
    for start in range(left, right, batch_size):
        idxs = range(start, min(start + batch_size, right))
        items = batched(idxs) if batched else [dataset[i] for i in idxs]
        clips, labels, names, inds = zip(*items)
        yield {
            "clips": np.stack(clips),
            "labels": np.asarray(labels, np.int32),
            "names": list(names),
            "clip_inds": list(inds),
        }
