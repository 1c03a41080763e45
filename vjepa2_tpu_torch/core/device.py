"""Where the entry points build: on the card unless the caller asks otherwise."""

from __future__ import annotations

import torch


def entry_device(device="cuda") -> torch.device:
    """``device`` as a torch device, "cuda" by default. With no CUDA device
    and no other choice made, raise: the entry points never fall back to
    the CPU (pass ``device="cpu"`` for a CPU model, whose flash routes run
    the kernels' plain versions)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: the port's entry points build on the card; pass "
            "device='cpu' to build a CPU model instead")
    return device
