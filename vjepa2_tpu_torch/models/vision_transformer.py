"""Video ViT encoder (counterpart of `vjepa2_tpu/models/vision_transformer.py:37`).

Channels-last input [B, T, H, W, C]. The unmasked forward with RoPE or with
the sincos table. With ``use_flash`` and RoPE, the split-half tables and the
qkv row permutation are built once per forward and shared by every layer
(the JAX package's ``ROPE_HOIST``). Not ported yet: the masked forward,
``STACK_PAD``, ``out_layers``, activation checkpointing and the image (2D
patch) path.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vjepa2_tpu_torch.models.modules import Block, LayerNorm, qkv_row_perm
from vjepa2_tpu_torch.models.patch_embed import PatchEmbed3D
from vjepa2_tpu_torch.models.pos_embs import get_3d_sincos_pos_embed
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache


class VisionTransformer(nn.Module):
    def __init__(self, img_size=(224, 224), patch_size: int = 16, num_frames: int = 1,
                 tubelet_size: int = 2, in_chans: int = 3, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, uniform_power: bool = False, use_rope: bool = False,
                 use_flash: bool = False, dtype=torch.float32, device=None,
                 init_std: float = 0.02):
        super().__init__()
        if num_frames <= 1:
            raise NotImplementedError("the image (2D patch) encoder is not ported yet")
        self.img_size = tuple(img_size)
        self.patch_size, self.num_frames, self.tubelet_size = patch_size, num_frames, tubelet_size
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.use_rope, self.use_flash = use_rope, use_flash
        self.dtype = dtype
        self.patch_embed = PatchEmbed3D(embed_dim, patch_size, tubelet_size, in_chans, dtype,
                                        device, init_std)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, use_rope, use_flash, i, dtype,
                  device, init_std)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, dtype=dtype, device=device)
        if not use_rope:
            gh = self.img_size[0] // patch_size
            table = get_3d_sincos_pos_embed(embed_dim, gh, num_frames // tubelet_size,
                                            uniform_power=uniform_power)
            self.register_buffer("pos_embed",
                                 torch.as_tensor(table, dtype=torch.float32, device=device),
                                 persistent=False)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.patch_embed.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.norm.reset_parameters()

    def _sincos_table(self, t_patches: int, h_patches: int, w_patches: int) -> torch.Tensor:
        """The init-grid table, or its first frames for a shorter clip at the
        trained spatial size (reference ``interpolate_pos_encoding``)."""
        gh = self.img_size[0] // self.patch_size
        gw = self.img_size[1] // self.patch_size
        gt = self.num_frames // self.tubelet_size
        if (h_patches, w_patches) == (gh, gw) and t_patches <= gt:
            return self.pos_embed[: t_patches * gh * gw]
        raise NotImplementedError(
            f"sincos table resize to a ({t_patches}, {h_patches}, {w_patches}) grid is not "
            "ported yet")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, H, W, C] -> [B, T'H'W', D] in ``dtype``."""
        _, T, H, W, _ = x.shape
        tp, hp, wp = T // self.tubelet_size, H // self.patch_size, W // self.patch_size
        tokens = self.patch_embed(x)
        if not self.use_rope:
            tokens = tokens + self._sincos_table(tp, hp, wp)[None].to(self.dtype)
        rope_cache = rope_expanded = qkv_perm = None
        if self.use_rope:
            head_dim = self.embed_dim // self.num_heads
            pos_ids = torch.arange(tp * hp * wp, device=x.device)
            rope_cache = build_rope_cache(pos_ids, head_dim, hp, wp)
            if self.use_flash:
                rope_expanded, perm = expand_rope_cache(rope_cache, head_dim)
                qkv_perm = qkv_row_perm(perm, self.num_heads, head_dim, x.device)
                rope_cache = None
        for blk in self.blocks:
            tokens = blk(tokens, rope_cache, rope_expanded, qkv_perm)
        return self.norm(tokens)


def _factory(embed_dim, depth, num_heads, mlp_ratio, use_rope=False):
    def make(patch_size=16, **kwargs):
        kwargs.setdefault("use_rope", use_rope)
        return VisionTransformer(patch_size=patch_size, embed_dim=embed_dim, depth=depth,
                                 num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=True,
                                 **kwargs)

    return make


# Factories mirror `vjepa2_tpu/models/vision_transformer.py:268-281`.
vit_tiny = _factory(192, 12, 3, 4)
vit_small = _factory(384, 12, 6, 4)
vit_base = _factory(768, 12, 12, 4)
vit_large = _factory(1024, 24, 16, 4)
vit_huge = _factory(1280, 32, 16, 4)
vit_giant = _factory(1408, 40, 16, 48 / 11)
vit_giant_xformers = _factory(1408, 40, 22, 48 / 11)
vit_gigantic = _factory(1664, 48, 16, 64 / 13)
vit_gigantic_xformers = _factory(1664, 48, 26, 64 / 13)
vit_large_rope = _factory(1024, 24, 16, 4, use_rope=True)
vit_huge_rope = _factory(1280, 32, 16, 4, use_rope=True)
vit_giant_rope = _factory(1408, 40, 16, 48 / 11, use_rope=True)
vit_giant_xformers_rope = _factory(1408, 40, 22, 48 / 11, use_rope=True)

MODEL_REGISTRY = {
    name: fn for name, fn in globals().items() if name.startswith("vit_") and callable(fn)
}
