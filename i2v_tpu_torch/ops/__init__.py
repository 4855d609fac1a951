"""Tensor functions (pixel sandwich, losses) and the hand-written kernels."""

from . import kernels, losses, pixel  # noqa: F401
