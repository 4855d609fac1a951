"""Image backbones with explicit feature taps (the ENS surrogates)."""

from .api import ImageModel  # noqa: F401
from .registry import (  # noqa: F401
    DEPTH_TO_TAP,
    IMAGE_MODEL_NAMES,
    build_image_model,
    get_image_models,
)
