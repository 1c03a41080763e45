"""Tubelet tokenizer (counterpart of `vjepa2_tpu/models/patch_embed.py:21,61`).

With stride equal to the kernel, the Conv3d is a patchify-reshape followed by
one matmul, and that is how it is computed. The weight keeps the Conv3d
layout [D, C, t, p, p] under the reference key `patch_embed.proj.weight`, so
released torch checkpoints load as they are; it is permuted to the patch
feature order (t, p, p, C) at use.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vjepa2_tpu_torch.models.modules import trunc_normal_


class _ConvAsMatmul(nn.Module):
    """Holds a Conv3d-layout weight; applies it to pre-extracted patches."""

    def __init__(self, in_chans: int, embed_dim: int, kernel: tuple[int, ...], device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, *kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(embed_dim, device=device))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        # [D, C, t, p, p] -> [D, t*p*p*C], the patches' feature order
        w = self.weight.movedim(1, -1).reshape(self.weight.shape[0], -1)
        return F.linear(patches, w.to(patches.dtype), self.bias.to(patches.dtype))


class PatchEmbed3D(nn.Module):
    """Video -> tubelet tokens: [B, T, H, W, C] -> [B, T'H'W', D], tokens in
    (t', h', w') order, as the reference's ``flatten(2).transpose(1, 2)``."""

    def __init__(self, embed_dim: int, patch_size: int = 16, tubelet_size: int = 2,
                 in_chans: int = 3, dtype=torch.float32, device=None, init_std: float = 0.02):
        super().__init__()
        self.patch_size, self.tubelet_size = patch_size, tubelet_size
        self.dtype = dtype
        self.init_std = init_std
        self.proj = _ConvAsMatmul(in_chans, embed_dim, (tubelet_size, patch_size, patch_size),
                                  device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        trunc_normal_(self.proj.weight, self.init_std, 1.0, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, t = self.patch_size, self.tubelet_size
        B, T, H, W, C = x.shape
        x = x.to(self.dtype).reshape(B, T // t, t, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # [B, T', H', W', t, p, p, C]
        return self.proj(x.reshape(B, (T // t) * (H // p) * (W // p), t * p * p * C))
