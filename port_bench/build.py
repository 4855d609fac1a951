"""The models of both sides, filled with the same seeded weights.

The program's models are the port's own modules, built on the meta device
and moved to the card empty, so that no weight is drawn on the host, then
filled from :mod:`.weights` and frozen as the port's registries freeze
them (``get_image_models``, ``get_video_model``). The reference's are the
plain copies in :mod:`.reference`, filled from the same draws by name."""

from __future__ import annotations

import torch

from . import weights
from .reference import surrogates as ref_surrogates
from .reference import video as ref_video

VIDEO_STREAM = 10  # + the model's index; the surrogates take 0..3


def port_surrogates(config: dict, seed: int, device, dtype=torch.float32) -> list:
    from i2v_tpu_torch.models.api import ImageModel
    from i2v_tpu_torch.models.common import set_compute_dtype
    from i2v_tpu_torch.models.registry import build_image_model

    out = []
    for i, (name, depth) in enumerate(config["surrogates"]):
        with torch.device("meta"):
            module, taps = build_image_model(name, depth, truncate=True,
                                             tiny=config.get("tiny", False),
                                             input_hw=config["hw"])
        module = weights.fill_(module.to_empty(device=device), seed, i)
        module = set_compute_dtype(module, dtype).eval().requires_grad_(False)
        out.append(ImageModel(name=name, module=module, tap_keys=taps))
    return out


def reference_surrogates(config: dict, seed: int, device) -> list:
    out = []
    for i, (name, depth) in enumerate(config["surrogates"]):
        with torch.device("meta"):
            module = ref_surrogates.build(name, depth, config.get("tiny", False))
        out.append(weights.fill_(module.to_empty(device=device), seed, i))
    return out


def port_video(name: str, index: int, config: dict, seed: int, device, dtype=torch.float32):
    from i2v_tpu_torch.models.api import VideoModel
    from i2v_tpu_torch.models.common import set_compute_dtype
    from i2v_tpu_torch.models.video_zoo import TINY_BUILDERS, VIDEO_BUILDERS, tap_keys_for

    taps = tap_keys_for(name)
    with torch.device("meta"):
        builders = TINY_BUILDERS if config.get("tiny", False) else VIDEO_BUILDERS
        module = builders[name](taps=taps)
    module = weights.fill_(module.to_empty(device=device), seed, VIDEO_STREAM + index)
    module = set_compute_dtype(module, dtype).eval().requires_grad_(False)
    return VideoModel(name=name, module=module, tap_keys=taps)


def reference_video(name: str, index: int, config: dict, seed: int, device):
    with torch.device("meta"):
        module = ref_video.build(name, config.get("tiny", False))
    return weights.fill_(module.to_empty(device=device), seed, VIDEO_STREAM + index)
