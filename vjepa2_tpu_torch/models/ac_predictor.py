"""Action-conditioned predictor, V-JEPA 2-AC (counterpart of
`vjepa2_tpu/models/ac_predictor.py:30`; reference `src/models/ac_predictor.py`).

Per frame, 2 or 3 conditioning tokens (the action, the proprioceptive state
and, with ``use_extrinsics``, the camera extrinsics, each a linear encoding
cast to the compute dtype before its product, JAX `:82-90`) lead the frame's
patch tokens; `ACBlock`s attend frame-causally (a token sees every token of
its own and earlier frames). The conditioning tokens are then stripped and
the frame tokens normalised and projected back to the encoder's width.

The RoPE tables, the qkv row permutation and the segment ids are built once
a call and shared by every block (JAX's hoist, `:95-112`). On the flash
route the sequence is stack-padded to a multiple of 8, as the encoder's
(`vision_transformer.stack_pad`), so that B1 and B2 read v in place: the pad
keys carry `modules.PAD_SEGMENT`, which no real query attends, and the pad
rows are sliced off after the blocks (1806 -> 1808 and 516 -> 520 tokens at
the shipped DROID config).

State-dict keys are the reference's: ``predictor_embed.*``,
``action_encoder.*``, ``state_encoder.*``, ``extrinsics_encoder.*``,
``predictor_blocks.{i}.*``, ``predictor_norm.*``, ``predictor_proj.*``.
``use_activation_checkpointing`` / ``remat_policy`` run every block under
`modules.remat_call` (JAX's ``nn.remat(ACBlock, ...)``, `:115-121`). RoPE is
always on, as in JAX, whose `ACAttention` builds its tables when the model
passes none. Not ported yet: the SwiGLU MLP (``use_silu``) and JAX's
``is_frame_causal=False`` (no caller).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vjepa2_tpu_torch.models.modules import (ACBlock, LayerNorm, ac_rope_tables, block_remat,
                                             dense, frame_segments, init_linear_, remat_call)
from vjepa2_tpu_torch.models.vision_transformer import stack_pad


class VisionTransformerPredictorAC(nn.Module):
    def __init__(self, img_size=(224, 224), patch_size: int = 16, embed_dim: int = 768,
                 predictor_embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, use_silu: bool = False,
                 use_flash: bool = False, action_embed_dim: int = 7, use_extrinsics: bool = False, dtype=torch.float32,
                 device=None, init_std: float = 0.02, fuse_ln_mlp: bool = False,
                 use_activation_checkpointing: bool = False, remat_policy: str | None = None):
        super().__init__()
        if use_silu:
            raise NotImplementedError("the SwiGLU MLP (use_silu) is not ported yet")
        self.remat = block_remat(use_activation_checkpointing, remat_policy, fuse_ln_mlp)
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.embed_dim, self.predictor_embed_dim = embed_dim, predictor_embed_dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.use_extrinsics = use_extrinsics
        self.dtype = dtype
        self.init_std = init_std
        P = predictor_embed_dim
        grid = self.img_size[0] // patch_size
        self.predictor_embed = nn.Linear(embed_dim, P, device=device)
        self.action_encoder = nn.Linear(action_embed_dim, P, device=device)
        self.state_encoder = nn.Linear(action_embed_dim, P, device=device)
        # extrinsics: a 6-dim pose, no gripper (reference `ac_predictor.py:74`)
        self.extrinsics_encoder = (nn.Linear(action_embed_dim - 1, P, device=device)
                                   if use_extrinsics else None)
        self.predictor_blocks = nn.ModuleList(
            ACBlock(P, num_heads, mlp_ratio, qkv_bias, grid, use_flash, i, dtype, device,
                    init_std, fuse_ln_mlp)
            for i in range(depth))
        self.predictor_norm = LayerNorm(P, dtype=dtype, device=device)
        self.predictor_proj = nn.Linear(P, embed_dim, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in (self.predictor_embed, self.action_encoder, self.state_encoder,
                      self.extrinsics_encoder, self.predictor_proj):
            if layer is not None:
                init_linear_(layer, self.init_std, 1.0, generator)
        for blk in self.predictor_blocks:
            blk.reset_parameters(generator)
        self.predictor_norm.reset_parameters()

    def forward(self, x: torch.Tensor, actions: torch.Tensor, states: torch.Tensor,
                extrinsics: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, T * H'W', E] frame tokens; actions and states [B, T, 7];
        extrinsics [B, T, 6] with ``use_extrinsics``. Returns [B, T * H'W', E],
        the predicted next-frame features."""
        gh = self.img_size[0] // self.patch_size
        gw = self.img_size[1] // self.patch_size
        B, n_ctxt, _ = x.shape
        T = n_ctxt // (gh * gw)
        P, dt = self.predictor_embed_dim, self.dtype
        cond = 3 if self.use_extrinsics else 2

        tokens = dense(self.predictor_embed, x, dt).view(B, T, gh * gw, P)
        conds = [dense(self.action_encoder, actions, dt), dense(self.state_encoder, states, dt)]
        if self.use_extrinsics:
            conds.append(dense(self.extrinsics_encoder, extrinsics, dt))
        tokens = torch.cat([c[:, :, None] for c in conds] + [tokens], dim=2)
        n = T * (cond + gh * gw)
        # the pad keys get PAD_SEGMENT: the DN kernels take no kv_valid with segments
        tokens, _, _ = stack_pad(tokens.reshape(B, n, P), None, self.use_flash)
        pad = tokens.shape[1] - n
        rope_cache, rope_expanded, qkv_perm = ac_rope_tables(
            P // self.num_heads, self.num_heads, T, gh, gw, cond, gh, self.use_flash, x.device,
            pad)
        seg = frame_segments(T, cond + gh * gw, x.device, pad)
        for blk in self.predictor_blocks:
            tokens = remat_call(blk, self.remat, tokens, T, gh, gw, cond, rope_cache,
                                rope_expanded, qkv_perm, seg)
        tokens = tokens[:, :n].reshape(B, T, cond + gh * gw, P)[:, :, cond:]
        tokens = self.predictor_norm(tokens.reshape(B, T * gh * gw, P))
        return dense(self.predictor_proj, tokens, dt)


def vit_ac_predictor(**kwargs) -> VisionTransformerPredictorAC:
    """JAX `ac_predictor.py:148`: MLP ratio 4 and a qkv bias unless given."""
    kwargs.setdefault("mlp_ratio", 4.0)
    kwargs.setdefault("qkv_bias", True)
    return VisionTransformerPredictorAC(**kwargs)
