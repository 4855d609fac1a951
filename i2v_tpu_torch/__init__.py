"""i2v_tpu_torch — the PyTorch and CUDA port of i2v_tpu, for NVIDIA Hopper.

The JAX package ``i2v_tpu`` is the reference each part of the port is held
against; this package imports neither it nor JAX. Layers:
  - ``i2v_tpu_torch.ops``      — pixel, loss, gradient, diversity and
                                 smoothing functions, and the hand-written
                                 CUDA kernels (``csrc/``) with their wrappers
  - ``i2v_tpu_torch.models``   — the image surrogates (ResNet-101, VGG-16,
                                 AlexNet, SqueezeNet-1.1, DenseNet-161,
                                 ViT-B/16; NCHW, explicit taps, Grad-CAM's
                                 ``tap_offset``) and the six video backbones,
                                 I3D, SlowFast and TPN (NCDHW); checkpoint
                                 files and weight converters
  - ``i2v_tpu_torch.attacks``  — the image-guided attacks (DR, I2V, ENS-I2V,
                                 AENS-I2V-MF, ILAF) and the white-box attacks
                                 (FGSM, BIM, MIFGSM, DIFGSM, TIFGSM, TIFGSM3D,
                                 SGM, SIM, TAP, TemporalTranslation)
  - ``i2v_tpu_torch.parallel`` — the frame-chunked single-device runner and
                                 multigrid
  - ``i2v_tpu_torch.eval``     — transfer evaluation and its reports, fused
                                 generate→evaluate, Grad-CAM saliency
  - ``i2v_tpu_torch.data``     — Kinetics-400, UCF-101 and synthetic clips,
                                 decode, transforms, the batcher and prefetch
  - ``i2v_tpu_torch.utils``    — paths, artifact protocol, meters, profiling
  - ``i2v_tpu_torch.cli``      — ``image_main``, ``image_main_ucf101``,
                                 ``attack``, ``attack_ucf101``, ``fine_tune``,
                                 ``evaluate``, ``evaluate_ucf101``,
                                 ``gradcam``, ``report`` and ``run_grid``
"""

__version__ = "0.1.0"
