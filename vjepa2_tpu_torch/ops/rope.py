"""3D rotary position embedding with explicit per-token position ids
(counterpart of `vjepa2_tpu/ops/rope.py`, plus the split-half layout of
`vjepa2_tpu/ops/flash_attention.py:112,919-973`).

Numerical contract (reference `src/models/utils/modules.py:26-50`): cos/sin
*tile* the D/2 frequencies across the rotated width (``repeat(..., 2)``)
while the rotation pairs *interleaved* features ``(x[2i], x[2i+1]) ->
(-x[2i+1], x[2i])``. With that quirk the two slots of a pair carry different
angles. A head of width Dh rotates three subspaces of ``rope_3d_dims(Dh)``
features (frame, row, column ids); at Dh 64 that is 3 x 20 = 60 features and
a 4-wide unrotated tail.

The flash kernel instead pairs feature d with d + Dh/2 ("split-half").
`expand_rope_cache` turns the interleaved tables into split-half [B|1, N, Dh]
tables (cos 1 and sin 0 on the tail) plus the head-dim permutation that the
qkv projection applies to the q and k weight rows.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_angles(pos: torch.Tensor, dim: int, theta: float = 10000.0):
    """(cos, sin) of shape ``pos.shape + (dim,)`` with tiled frequencies."""
    if dim % 2:
        raise ValueError(f"rotary subspace must be even, got {dim}")
    omega = torch.arange(dim // 2, dtype=torch.float32, device=pos.device) / (dim / 2.0)
    omega = 1.0 / (theta ** omega)
    freq = pos.to(torch.float32)[..., None] * omega
    freq = torch.cat([freq, freq], dim=-1)  # tiled, as the reference's .repeat
    return torch.cos(freq), torch.sin(freq)


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """Map interleaved pairs (x0, x1) -> (-x1, x0) along the last dim."""
    y = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-y[..., 1], y[..., 0]], dim=-1).reshape(x.shape)


def separate_positions(ids: torch.Tensor, h_patches: int, w_patches: int):
    """Factorize flat token ids into (frame, row, col) ids."""
    tokens_per_frame = h_patches * w_patches
    frame_ids = ids // tokens_per_frame
    rem = ids - tokens_per_frame * frame_ids
    height_ids = rem // w_patches
    width_ids = rem - w_patches * height_ids
    return frame_ids, height_ids, width_ids


def rope_3d_dims(head_dim: int) -> tuple[int, int, int]:
    """Widths of the (frame, row, col) rotary subspaces; the rest is unrotated."""
    d = 2 * ((head_dim // 3) // 2)
    return d, d, d


def build_rope_cache(pos_ids: torch.Tensor, head_dim: int, h_patches: int, w_patches: int,
                     grid_size: int | None = None, theta: float = 10000.0):
    """Fused interleaved-convention (cos, sin) of shape pos_ids.shape + (rot,),
    rot = the three subspace widths together."""
    d_ids, h_ids, w_ids = (t.to(torch.float32)
                           for t in separate_positions(pos_ids, h_patches, w_patches))
    if grid_size is not None:
        h_ids = h_ids * (grid_size / h_patches)
        w_ids = w_ids * (grid_size / w_patches)
    return rope_from_ids(d_ids, h_ids, w_ids, head_dim, theta)


def rope_from_ids(d_ids: torch.Tensor, h_ids: torch.Tensor, w_ids: torch.Tensor,
                  head_dim: int, theta: float = 10000.0):
    """Fused interleaved-convention (cos, sin) of shape ids.shape + (rot,)
    from per-token (frame, row, col) ids, one subspace of `rope_3d_dims` each."""
    dims = rope_3d_dims(head_dim)
    parts = [rope_angles(ids, dim, theta) for ids, dim in zip((d_ids, h_ids, w_ids), dims)]
    return torch.cat([c for c, _ in parts], dim=-1), torch.cat([s for _, s in parts], dim=-1)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation over the last dim: x*cos + [-x_hi, x_lo]*sin."""
    d = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., d:], x[..., :d]], dim=-1) * sin


def rope_rotate_t(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Adjoint of `rope_rotate` (the JAX package's `_rope_rotate_dn_t`): the
    two slots of a pair may carry different angles under the tiled-frequency
    quirk, so this is R^T, not R(-theta): g*cos + [w_hi, -w_lo], w = g*sin."""
    d = g.shape[-1] // 2
    w = g * sin
    return g * cos + torch.cat([w[..., d:], -w[..., :d]], dim=-1)


def splithalf_layout(d: int, rot: int):
    """Head-dim permutation (interleaved pairs -> split-half) for a head of
    width ``d`` whose first ``rot`` features rotate.

    The rotated pairs' even features go to [0, rot/2), their odd features to
    [d/2, d/2 + rot/2), and the unrotated tail fills the remaining slots.
    Returns (perm, rot_slots, tbl_idx): new[..., j] = old[..., perm[j]], and
    split-half slot ``rot_slots[i]`` takes interleaved table column
    ``tbl_idx[i]``.
    """
    if rot % 2 or d % 2 or rot > d:
        raise ValueError(f"bad rotary layout: d={d}, rot={rot}")
    half = d // 2
    perm = np.empty(d, np.int64)
    perm[: rot // 2] = np.arange(0, rot, 2)
    perm[half: half + rot // 2] = np.arange(1, rot, 2)
    tail = np.arange(rot, d)
    n1 = half - rot // 2
    perm[rot // 2: half] = tail[:n1]
    perm[half + rot // 2:] = tail[n1:]
    rot_slots = np.concatenate([np.arange(0, rot // 2), np.arange(half, half + rot // 2)])
    tbl_idx = np.concatenate([np.arange(0, rot, 2), np.arange(1, rot, 2)])
    return perm, rot_slots, tbl_idx


def expand_rope_tables(cos: torch.Tensor, sin: torch.Tensor, head_dim: int):
    """[..., N, rot] interleaved tables -> split-half [..., N, head_dim]
    (cos 1 and sin 0 on the unrotated tail), plus the q/k permutation."""
    perm, rot_slots, tbl_idx = splithalf_layout(head_dim, cos.shape[-1])
    slots = torch.as_tensor(rot_slots, device=cos.device)
    idx = torch.as_tensor(tbl_idx, device=cos.device)
    shape = cos.shape[:-1] + (head_dim,)
    cos_full = torch.ones(shape, dtype=cos.dtype, device=cos.device)
    sin_full = torch.zeros(shape, dtype=sin.dtype, device=sin.device)
    cos_full[..., slots] = cos[..., idx]
    sin_full[..., slots] = sin[..., idx]
    return cos_full, sin_full, perm


def expand_rope_cache(rope_cache, head_dim: int):
    """Interleaved (cos, sin) [N, rot] or [B, N, rot] -> (split-half fp32
    (cos, sin) [B|1, N, head_dim], perm). Built once per forward; every layer
    reuses the tables and folds ``perm`` into its q/k weight rows."""
    cos, sin = rope_cache
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos_full, sin_full, perm = expand_rope_tables(cos, sin, head_dim)
    return (cos_full.to(torch.float32), sin_full.to(torch.float32)), perm
