"""Video ViT encoder (counterpart of `vjepa2_tpu/models/vision_transformer.py:37`).

Channels-last input [B, T, H, W, C]. The forward with RoPE or with the sincos
table, unmasked or masked (tokens gathered after the patch embed, RoPE
position ids carried alongside). With ``use_flash`` and RoPE, the split-half
tables and the qkv row permutation are built once per forward and shared by
every layer (the JAX package's ``ROPE_HOIST``). ``fuse_ln_qkv`` /
``fuse_ln_mlp`` put every block on the fused LayerNorm routes (B7, B8;
`models.modules.Block`).

``STACK_PAD`` (`vision_transformer.py:33,159-176`): with ``use_flash`` the
token stream is padded once, with zero rows, to the next multiple of
``STACK_PAD_MULTIPLE`` and every layer masks the pad keys with a static
``kv_valid``; pad rows are sliced off before the final norm. The JAX rule
pads to x8 or x128 for Mosaic's tiling; the CUDA kernels take any length and
need only x8 for their 16-byte path (578 -> 584 tokens, not 640).

``use_activation_checkpointing`` runs every block under `modules.remat_call`
with the names ``remat_policy`` keeps (`modules.resolve_remat_policy`;
`vision_transformer.py:52-56,185-188`); blocks without gradients (the EMA
target's) run plainly.

``out_layers`` (`vision_transformer.py:59,243-247`): the forward returns the
list of ``norm(tokens[:, :n_real])`` after each listed block, the one final
norm shared by every tap, stack-pad rows sliced off before it (the frozen
evals' multilevel features).

Not ported yet: the image (2D patch) path.
"""

from __future__ import annotations

import torch
import torch.nn as nn

import torch.nn.functional as F

from vjepa2_tpu_torch.models.modules import (Block, LayerNorm, block_remat, qkv_row_perm,
                                             remat_call)
from vjepa2_tpu_torch.models.patch_embed import PatchEmbed3D
from vjepa2_tpu_torch.models.pos_embs import get_3d_sincos_pos_embed
from vjepa2_tpu_torch.ops.masking import apply_masks
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

STACK_PAD_MULTIPLE = 8


def stack_pad(tokens: torch.Tensor, pos_ids: torch.Tensor | None, use_flash: bool):
    """Pad [B, N, C] tokens (and [N] or [B, N] position ids, with 0) to the
    next multiple of ``STACK_PAD_MULTIPLE`` when the flash route runs.
    Returns (tokens, pos_ids, kv_valid): kv_valid is the real length when a
    pad was added, else None."""
    pad = (-tokens.shape[1]) % STACK_PAD_MULTIPLE
    if not use_flash or pad == 0:
        return tokens, pos_ids, None
    kv_valid = tokens.shape[1]
    tokens = F.pad(tokens, (0, 0, 0, pad))
    if pos_ids is not None:
        pos_ids = F.pad(pos_ids, (0, pad))
    return tokens, pos_ids, kv_valid


def rope_tables(pos_ids: torch.Tensor, head_dim: int, num_heads: int, h_patches: int,
                w_patches: int, use_flash: bool):
    """(rope_cache, rope_expanded, qkv_perm) for one forward: the interleaved
    cache for the plain route, or the split-half tables plus the qkv row
    permutation for the flash routes (DN and BHND), shared by every layer.
    Where 3 x the subspace width falls short of ``head_dim`` (78 of 80, 84
    of 88) the tail slots carry cos 1 and sin 0."""
    rope_cache = build_rope_cache(pos_ids, head_dim, h_patches, w_patches)
    if not use_flash:
        return rope_cache, None, None
    rope_expanded, perm = expand_rope_cache(rope_cache, head_dim)
    return None, rope_expanded, qkv_row_perm(perm, num_heads, head_dim, pos_ids.device)


class VisionTransformer(nn.Module):
    def __init__(self, img_size=(224, 224), patch_size: int = 16, num_frames: int = 1,
                 tubelet_size: int = 2, in_chans: int = 3, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, uniform_power: bool = False, use_rope: bool = False,
                 use_flash: bool = False, dtype=torch.float32, device=None,
                 init_std: float = 0.02, fuse_ln_qkv: bool = False, fuse_ln_mlp: bool = False,
                 use_activation_checkpointing: bool = False, remat_policy: str | None = None,
                 out_layers=None):
        super().__init__()
        if num_frames <= 1:
            raise NotImplementedError("the image (2D patch) encoder is not ported yet")
        self.out_layers = None if out_layers is None else tuple(out_layers)
        self.remat = block_remat(use_activation_checkpointing, remat_policy, fuse_ln_mlp)
        self.img_size = tuple(img_size)
        self.patch_size, self.num_frames, self.tubelet_size = patch_size, num_frames, tubelet_size
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.use_rope, self.use_flash = use_rope, use_flash
        self.dtype = dtype
        self.patch_embed = PatchEmbed3D(embed_dim, patch_size, tubelet_size, in_chans, dtype,
                                        device, init_std)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, use_rope, use_flash, i, dtype,
                  device, init_std, fuse_ln_qkv, fuse_ln_mlp)
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

    def forward(self, x: torch.Tensor, masks=None):
        """x: [B, T, H, W, C] -> [B, T'H'W', D] in ``dtype``, or with
        ``out_layers`` the list of those after each listed block.

        masks: None, a [B, K] index tensor, or a list of them; with a list the
        outputs are stacked along batch (reference semantics):
        [B * len(masks), K, D].
        """
        if masks is not None and not isinstance(masks, (list, tuple)):
            masks = [masks]
        _, T, H, W, _ = x.shape
        tp, hp, wp = T // self.tubelet_size, H // self.patch_size, W // self.patch_size
        tokens = self.patch_embed(x)
        if not self.use_rope:
            tokens = tokens + self._sincos_table(tp, hp, wp)[None].to(self.dtype)
        pos_ids = None
        if masks is not None:
            tokens = apply_masks(tokens, masks)
            pos_ids = torch.cat([m.to(device=x.device, dtype=torch.long) for m in masks])
        elif self.use_rope:
            pos_ids = torch.arange(tp * hp * wp, device=x.device)
        n_real = tokens.shape[1]
        tokens, pos_ids, kv_valid = stack_pad(tokens, pos_ids, self.use_flash)
        rope_cache = rope_expanded = qkv_perm = None
        if self.use_rope:
            rope_cache, rope_expanded, qkv_perm = rope_tables(
                pos_ids, self.embed_dim // self.num_heads, self.num_heads, hp, wp,
                self.use_flash)
        outs = []
        for i, blk in enumerate(self.blocks):
            tokens = remat_call(blk, self.remat, tokens, rope_cache, rope_expanded, qkv_perm,
                                kv_valid)
            if self.out_layers is not None and i in self.out_layers:
                outs.append(self.norm(tokens[:, :n_real]))
        if self.out_layers is not None:
            return outs
        return self.norm(tokens[:, :n_real])


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
