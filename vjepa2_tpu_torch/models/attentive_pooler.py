"""Attentive pooler and classifier probes (counterpart of
`vjepa2_tpu/models/attentive_pooler.py:21,73`).

A learnable query cross-attends into frozen features after ``depth - 1``
self-attention blocks (no RoPE; with ``use_flash`` the blocks take the
flash route of their head width, fp32 on the card: B1/B2 at 16-64, the BHND
kernels at 80-104; JAX's probes leave it to its plain route: the same
function); `AttentiveClassifier` adds an fp32 linear head.
The cross-attention (1-3 queries against N keys) stays plain, as in JAX.
State-dict keys follow the reference: ``pooler.query_tokens``, ``pooler.blocks.{i}.*``,
``pooler.cross_attention_block.*``, ``linear.*``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from vjepa2_tpu_torch.models.modules import (
    Block,
    CrossAttention,
    CrossAttentionBlock,
    init_linear_,
    trunc_normal_,
)


class AttentivePooler(nn.Module):
    def __init__(self, num_queries: int = 1, embed_dim: int = 768, num_heads: int = 12,
                 mlp_ratio: float = 4.0, depth: int = 1, qkv_bias: bool = True,
                 complete_block: bool = True, dtype=torch.float32, device=None,
                 init_std: float = 0.02, use_flash: bool = False):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.query_tokens = nn.Parameter(torch.zeros(1, num_queries, embed_dim, device=device))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, use_flash=use_flash, layer_id=i,
                  dtype=dtype, device=device, init_std=init_std)
            for i in range(depth - 1))
        # the reference rescales the cross block's MLP by 1/sqrt(2*(depth-1+1))
        # (`vjepa2_tpu/models/attentive_pooler.py:49`, quirk kept)
        mlp_scale = 1.0 / math.sqrt(2.0 * max(1, depth - 1) if depth > 1 else 2.0)
        if complete_block:
            self.cross_attention_block = CrossAttentionBlock(
                embed_dim, num_heads, mlp_ratio, qkv_bias, dtype, device, init_std,
                mlp_init_scale=mlp_scale)
        else:
            self.cross_attention_block = CrossAttention(embed_dim, num_heads, qkv_bias, dtype,
                                                        device, init_std)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        trunc_normal_(self.query_tokens, self.init_std, 1.0, generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.cross_attention_block.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.query_tokens.expand(x.shape[0], -1, -1).to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.cross_attention_block(q, x.to(self.dtype))


class AttentiveClassifier(nn.Module):
    def __init__(self, embed_dim: int = 768, num_heads: int = 12, mlp_ratio: float = 4.0,
                 depth: int = 1, qkv_bias: bool = True, num_classes: int = 1000,
                 complete_block: bool = True, dtype=torch.float32, device=None,
                 init_std: float = 0.02, use_flash: bool = False):
        super().__init__()
        self.init_std = init_std
        self.pooler = AttentivePooler(1, embed_dim, num_heads, mlp_ratio, depth, qkv_bias,
                                      complete_block, dtype, device, init_std, use_flash)
        self.linear = nn.Linear(embed_dim, num_classes, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.pooler.reset_parameters(generator)
        init_linear_(self.linear, self.init_std, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, N, D] features -> [B, num_classes] fp32 logits."""
        q = self.pooler(x)[:, 0]
        return F.linear(q.float(), self.linear.weight.float(), self.linear.bias.float())
