"""i2v_tpu_torch — the PyTorch and CUDA port of i2v_tpu, for NVIDIA Hopper.

The JAX package ``i2v_tpu`` is the reference each part of the port is held
against; this package imports neither it nor JAX. Layers:
  - ``i2v_tpu_torch.ops``      — pixel, loss and gradient functions, and the
                                 hand-written CUDA kernels (``csrc/``) with
                                 their wrappers
  - ``i2v_tpu_torch.models``   — image backbones (NCHW) and the six video
                                 backbones, I3D, SlowFast and TPN (NCDHW),
                                 with explicit taps
  - ``i2v_tpu_torch.attacks``  — the image-guided I2V / ENS-I2V attacks and
                                 the white-box sign attacks (FGSM, BIM,
                                 MIFGSM, SGM, SIM)
  - ``i2v_tpu_torch.eval``     — transfer evaluation and its reports
  - ``i2v_tpu_torch.data``     — synthetic clips, the batcher, the prefetch
                                 thread
  - ``i2v_tpu_torch.utils``    — paths, artifact protocol, meters
  - ``i2v_tpu_torch.cli``      — ``image_main``, ``attack``, ``evaluate`` and
                                 ``evaluate_ucf101``
"""

__version__ = "0.1.0"
