"""See the package docstring of vjepa2_tpu_torch."""
