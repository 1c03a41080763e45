"""Training steps (counterpart of `vjepa2_tpu/train`)."""
