"""Attack engines. Class names mirror the reference so CLI dispatch via
``getattr`` works unchanged (image_main.py:66-80)."""

from .core import Attack  # noqa: F401
from .i2v import (  # noqa: F401
    ImageGuidedFMDirection_Adam,
    ImageGuidedFML2_Adam_MultiModels,
    run_adam_modifier_attack,
)
