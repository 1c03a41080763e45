"""Frozen-encoder feature extraction (counterpart of
`vjepa2_tpu/evals/wrappers.py:23 encode_clips`).

Each clip is encoded independently and the tokens are concatenated
(reference ``ClipAggregation``, `vit_encoder_multiclip.py:101-180`). The
optional temporal embed over absolute frame indices (``use_pos_embed``) is
not ported yet; the SSv2 probe config runs without it.
"""

from __future__ import annotations

import torch


def encode_clips(encoder: torch.nn.Module, clips: torch.Tensor) -> torch.Tensor:
    """clips [B, num_clips, T, H, W, C] -> [B, num_clips*N, D] features."""
    B, nc = clips.shape[0], clips.shape[1]
    feats = encoder(clips.reshape((B * nc,) + tuple(clips.shape[2:])))  # [B*nc, N, D]
    return feats.reshape(B, nc * feats.shape[1], feats.shape[2])
