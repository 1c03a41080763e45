"""JEPA predictor (counterpart of `vjepa2_tpu/models/predictor.py:30`).

A narrower ViT that takes the encoder's context tokens plus learned mask
tokens at the target positions and predicts the target encoder's features.
Masks are [B, K] index tensors, one mask config per call (the train step
calls the predictor once per config). The tokens are sorted by position so
RoPE sees monotone ids, run through the blocks (stack-padded with a static
``kv_valid`` on the flash route, as the encoder), normalised, unsorted and
projected back to the encoder's width.

State-dict keys are the reference's: ``predictor_embed.*``,
``mask_tokens.{j}`` (each [1, 1, P]), ``predictor_blocks.{i}.*``,
``predictor_norm.*``, ``predictor_proj.*``. ``fuse_ln_qkv`` / ``fuse_ln_mlp``
put every block on the fused LayerNorm routes (B7, B8). Not ported yet:
``chop_last_n_tokens``, ``return_all_tokens``, activation checkpointing.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vjepa2_tpu_torch.models.modules import Block, LayerNorm, dense, init_linear_, trunc_normal_
from vjepa2_tpu_torch.models.pos_embs import get_3d_sincos_pos_embed
from vjepa2_tpu_torch.models.vision_transformer import rope_tables, stack_pad


class VisionTransformerPredictor(nn.Module):
    def __init__(self, img_size=(224, 224), patch_size: int = 16, num_frames: int = 1,
                 tubelet_size: int = 2, embed_dim: int = 768, predictor_embed_dim: int = 384,
                 depth: int = 6, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, uniform_power: bool = False,
                 use_mask_tokens: bool = False, num_mask_tokens: int = 2,
                 zero_init_mask_tokens: bool = True, use_rope: bool = False,
                 use_flash: bool = False, dtype=torch.float32, device=None,
                 init_std: float = 0.02, fuse_ln_qkv: bool = False, fuse_ln_mlp: bool = False):
        super().__init__()
        if num_frames <= 1:
            raise NotImplementedError("the image (2D patch) predictor is not ported yet")
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.embed_dim, self.predictor_embed_dim = embed_dim, predictor_embed_dim
        self.num_heads = num_heads
        self.use_rope, self.use_flash = use_rope, use_flash
        self.num_mask_tokens = num_mask_tokens
        self.zero_init_mask_tokens = zero_init_mask_tokens
        self.dtype = dtype
        self.init_std = init_std
        P = predictor_embed_dim
        self.predictor_embed = nn.Linear(embed_dim, P, device=device)
        self.mask_tokens = None
        if use_mask_tokens:
            self.mask_tokens = nn.ParameterList(
                nn.Parameter(torch.zeros(1, 1, P, device=device)) for _ in range(num_mask_tokens))
        self.predictor_blocks = nn.ModuleList(
            Block(P, num_heads, mlp_ratio, qkv_bias, use_rope, use_flash, i, dtype, device,
                  init_std, fuse_ln_qkv, fuse_ln_mlp)
            for i in range(depth))
        self.predictor_norm = LayerNorm(P, dtype=dtype, device=device)
        self.predictor_proj = nn.Linear(P, embed_dim, device=device)
        if not use_rope:
            gh = self.img_size[0] // patch_size
            table = get_3d_sincos_pos_embed(P, gh, num_frames // tubelet_size,
                                            uniform_power=uniform_power)
            self.register_buffer("pos_embed",
                                 torch.as_tensor(table, dtype=torch.float32, device=device),
                                 persistent=False)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_linear_(self.predictor_embed, self.init_std, 1.0, generator)
        if self.mask_tokens is not None:
            for mt in self.mask_tokens:
                if self.zero_init_mask_tokens:
                    nn.init.zeros_(mt)
                else:
                    trunc_normal_(mt, self.init_std, 1.0, generator)
        for blk in self.predictor_blocks:
            blk.reset_parameters(generator)
        self.predictor_norm.reset_parameters()
        init_linear_(self.predictor_proj, self.init_std, 1.0, generator)

    def forward(self, x: torch.Tensor, masks_x: torch.Tensor, masks_y: torch.Tensor,
                mask_index: int = 1, h_patches: int | None = None,
                w_patches: int | None = None) -> torch.Tensor:
        """x: [B, Nc, E] context tokens; masks_x: [B, Nc]; masks_y: [B, Np]
        position ids. h_patches/w_patches: the input clip's patch grid for the
        RoPE factorisation (default: the init grid). Returns [B, Np, E]."""
        B, n_ctxt, _ = x.shape
        n_pred = masks_y.shape[1]
        P = self.predictor_embed_dim
        hp = h_patches or self.img_size[0] // self.patch_size
        wp = w_patches or self.img_size[1] // self.patch_size
        masks_x = masks_x.to(device=x.device, dtype=torch.long)
        masks_y = masks_y.to(device=x.device, dtype=torch.long)

        tokens = dense(self.predictor_embed, x, self.dtype)
        if not self.use_rope:
            tokens = tokens + self.pos_embed[masks_x].to(self.dtype)
        if self.mask_tokens is not None:
            mt = self.mask_tokens[mask_index % self.num_mask_tokens].to(self.dtype)
            pred_tokens = mt.reshape(1, 1, P).expand(B, n_pred, P)
        else:
            pred_tokens = torch.zeros(B, n_pred, P, dtype=self.dtype, device=x.device)
        if not self.use_rope:
            pred_tokens = pred_tokens + self.pos_embed[masks_y].to(self.dtype)

        # sort by position id so RoPE sees monotone positions; unsort at the end
        tokens = torch.cat([tokens, pred_tokens], dim=1)
        positions = torch.cat([masks_x, masks_y], dim=1)
        order = torch.argsort(positions, dim=1, stable=True)
        positions_sorted = torch.gather(positions, 1, order)
        tokens = torch.gather(tokens, 1, order[:, :, None].expand(-1, -1, P))

        n_seq = tokens.shape[1]
        tokens, positions_sorted, kv_valid = stack_pad(tokens, positions_sorted, self.use_flash)
        rope_cache = rope_expanded = qkv_perm = None
        if self.use_rope:
            rope_cache, rope_expanded, qkv_perm = rope_tables(
                positions_sorted, P // self.num_heads, self.num_heads, hp, wp, self.use_flash)
        for blk in self.predictor_blocks:
            tokens = blk(tokens, rope_cache, rope_expanded, qkv_perm, kv_valid)
        tokens = self.predictor_norm(tokens[:, :n_seq])

        inverse = torch.argsort(order, dim=1)
        tokens = torch.gather(tokens, 1, inverse[:, :, None].expand(-1, -1, P))[:, n_ctxt:]
        return dense(self.predictor_proj, tokens, self.dtype)
