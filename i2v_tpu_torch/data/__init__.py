"""Clip sources (Kinetics-400 clips, UCF-101 frame JPEGs, synthetic clips),
the batcher, and the host-to-device prefetch pipeline."""

from .kinetics import KineticsAttackDataset  # noqa: F401
from .pipeline import device_prefetch, make_input_pipeline, threaded_prefetch  # noqa: F401
from .synthetic import SyntheticAttackDataset  # noqa: F401
from .ucf101 import UCF101AttackDataset  # noqa: F401
