"""Mask sampling (counterpart of `vjepa2_tpu/masks`)."""
