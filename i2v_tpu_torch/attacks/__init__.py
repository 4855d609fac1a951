"""Attack engines. Class names mirror the reference so CLI dispatch via
``getattr`` works unchanged (image_main.py:66-80, attack.py:76-83)."""

from .core import Attack, SignAttackConfig, make_ce_grad_fn, run_sign_attack  # noqa: F401
from .i2v import (  # noqa: F401
    AENS_I2V_MF,
    ILAF,
    ImageGuidedFMDirection_Adam,
    ImageGuidedFML2_Adam_MultiModels,
    ImageGuidedStd_Adam,
    run_adam_modifier_attack,
)
from .temporal import TemporalTranslation  # noqa: F401
from .whitebox import BIM, DIFGSM, FGSM, MIFGSM, SGM, SIM, TAP, TIFGSM, TIFGSM3D  # noqa: F401
