"""Command-line entry points (``python -m i2v_tpu_torch.cli.<tool>``)."""
