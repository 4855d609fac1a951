"""Image backbones with explicit feature taps (the ENS surrogates,
DenseNet-161 and ViT-B/16) and the video backbones the white-box attacks
target."""

from .api import ImageModel, VideoModel  # noqa: F401
from .registry import (  # noqa: F401
    DEPTH_TO_TAP,
    IMAGE_MODEL_NAMES,
    build_image_model,
    get_image_models,
)
from .video_zoo import get_video_model, tap_keys_for  # noqa: F401
