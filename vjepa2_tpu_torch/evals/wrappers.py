"""Frozen-encoder feature extractors for evals (counterpart of
`vjepa2_tpu/evals/wrappers.py`).

`encode_clips` is the reference's ``ClipAggregation``
(`vit_encoder_multiclip.py:101-180`): each clip is encoded independently and
the tokens are concatenated, optionally with a 1D sincos temporal embed
indexed by absolute frame (``use_pos_embed``). `encode_multilevel`
concatenates the taps of an encoder built with ``out_layers``
(`..._multilevel.py`). `image_as_video` replicates a still image into a
clip (reference `image_classification_frozen/modelcustom/vit_encoder.py:56-66`).
"""

from __future__ import annotations

from typing import Optional

import torch

from vjepa2_tpu_torch.models.pos_embs import get_1d_sincos_pos_embed


def encode_clips(encoder: torch.nn.Module, clips: torch.Tensor,
                 clip_indices: Optional[torch.Tensor] = None, use_pos_embed: bool = False,
                 max_frames: int = 10000, tubelet_size: int = 2) -> torch.Tensor:
    """clips [B, num_clips, T, H, W, C] -> [B, num_clips*N, D] features.

    clip_indices: [B, num_clips, T] frame indices, read with
    ``use_pos_embed``: the fp32 table row of each tubelet's first frame
    (``clip_indices[..., ::tubelet_size]``) is added to that tubelet's
    spatial tokens (tokens are t-major within a clip; reference
    `vit_encoder_multiclip.py:137-146`). The sum takes torch's promoted
    dtype, as JAX's does: bf16 features plus the fp32 table give fp32.
    """
    B, nc = clips.shape[0], clips.shape[1]
    feats = encoder(clips.reshape((B * nc,) + tuple(clips.shape[2:])))  # [B*nc, N, D]
    N, D = feats.shape[1], feats.shape[2]
    feats = feats.reshape(B, nc * N, D)
    if use_pos_embed and clip_indices is not None:
        table = torch.as_tensor(get_1d_sincos_pos_embed(D, max_frames), dtype=torch.float32,
                                device=feats.device)
        idx = torch.as_tensor(clip_indices, device=feats.device)[:, :, ::tubelet_size].long()
        emb = table[idx].repeat_interleave(N // idx.shape[2], dim=2)  # [B, nc, N, D]
        feats = feats + emb.reshape(B, nc * N, D)
    return feats


def encode_multilevel(encoder: torch.nn.Module, clips: torch.Tensor) -> torch.Tensor:
    """clips [B, num_clips, T, H, W, C] through an encoder built with
    ``out_layers`` -> [B, num_clips * L * N, D]: each clip's taps
    concatenated along the token axis."""
    B, nc = clips.shape[0], clips.shape[1]
    feats = torch.cat(encoder(clips.reshape((B * nc,) + tuple(clips.shape[2:]))), dim=1)
    return feats.reshape(B, nc * feats.shape[1], feats.shape[2])


def image_as_video(images: torch.Tensor, tubelet_size: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, tubelet_size, H, W, C], the image repeated."""
    return images[:, None].expand(-1, tubelet_size, -1, -1, -1)
