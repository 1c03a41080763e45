"""Token-index masking (counterpart of `vjepa2_tpu/ops/masking.py`).

Masks are index lists [B, K] of kept tokens, as in the reference
(`src/masks/utils.py:9-21`); a gather along the token dim shortens the
sequence fed to the transformer.
"""

from __future__ import annotations

import torch


def apply_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gather kept tokens. x: [B, N, D]; mask: [B, K] int indices -> [B, K, D]."""
    idx = mask.to(device=x.device, dtype=torch.long)[:, :, None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def apply_masks(x: torch.Tensor, masks, concat_axis: int | None = 0):
    """Gather tokens for a list of masks; the per-mask outputs are
    concatenated along ``concat_axis`` (batch by default, the reference's
    ``concat=True``), or returned as a list with ``concat_axis=None``."""
    if not isinstance(masks, (list, tuple)):
        masks = [masks]
    outs = [apply_mask(x, m) for m in masks]
    if concat_axis is None:
        return outs
    return torch.cat(outs, dim=concat_axis)
