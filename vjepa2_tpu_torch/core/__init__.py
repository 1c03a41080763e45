"""Optimizer and schedules (counterpart of `vjepa2_tpu/core`)."""
