"""Command-line entry points (``python -m i2v_tpu_torch.cli.<tool>``):

  image_main, image_main_ucf101   image-guided attacks (DR, I2V, ENS-I2V, AENS)
  attack, attack_ucf101           white-box attacks on a video model
  fine_tune                       ILAF over white-box adv/ori pairs
  evaluate, evaluate_ucf101       transfer evaluation on the six video models
  gradcam                         multi-model Grad-CAM masks over artifacts
  report                          the ASR table over run directories
  run_grid                        the papers' (generate, evaluate) grids

Each runs on ``--device`` (default ``cuda``) and stops on a machine without
a card unless asked for the CPU; ``report`` needs no device.
"""
