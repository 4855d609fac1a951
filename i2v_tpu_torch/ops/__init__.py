"""Tensor functions (pixel sandwich, losses, gradient normalization,
gradient-scaled ReLU) and the hand-written kernels."""

from . import activations, grads, kernels, losses, pixel  # noqa: F401
