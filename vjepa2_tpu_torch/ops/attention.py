"""Attention math and dispatch (counterpart of `vjepa2_tpu/ops/attention.py`).

One math path serves every layout: fp32 scores, an fp32 softmax, the
probabilities cast to the compute dtype before P.V, fp32 accumulation and the
result cast back (`_manual_sdpa:19`). With ``use_flash``, `attend_bhdn`
routes [B, H, D, N] operands to the DN flash kernels
(`flash_attention_dn.flash_attention_bhdn`), and `attend_bhnd`, `attend` and
`sdpa` route [B, H, N, D] / [B, N, H, D] operands to the BHND ones
(`flash_attention.flash_attention_bhnd`). The TPU's x128 lane padding
(`_flash_pad_plan`, `_pad_flash_operands`) has no counterpart: the CUDA kernels
mask their own ragged edge.
"""

from __future__ import annotations

import math

import torch

from vjepa2_tpu_torch.ops.rope import rotate_pairs


def softmax_attention(q, k, v, scale: float | None = None, mask=None):
    """q [..., N, D], k and v [..., M, D]; mask broadcastable to [..., N, M],
    True = attend. Returns (out [..., N, D] in q's dtype, lse [..., N] fp32,
    natural log).

    A row with no key to attend gives output 0 and lse -inf, as the flash
    kernel does.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).detach()
    empty = torch.isneginf(m)
    m = m.masked_fill(empty, 0.0)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = denom.masked_fill(empty, 1.0)
    out = torch.matmul((p / denom).to(q.dtype).float(), v.float()).to(q.dtype)
    lse = (m + torch.log(denom)).masked_fill(empty, float("-inf")).squeeze(-1)
    return out, lse


def attention_mask(n: int, m: int, device, kv_valid: int | None = None, segment_ids=None):
    """Boolean [S|1, 1, n, m] mask (True = attend) for a static kv_valid tail
    and/or segment ids ([n] or [S, n], attend iff seg_q >= seg_k), or None."""
    mask = None
    if kv_valid is not None and kv_valid < m:
        mask = (torch.arange(m, device=device) < kv_valid)[None, None, None, :]
    if segment_ids is not None:
        seg = segment_ids if segment_ids.ndim > 1 else segment_ids[None]
        seg = seg.to(device)
        seg_mask = seg[:, None, :, None] >= seg[:, None, None, :]
        mask = seg_mask if mask is None else mask & seg_mask
    return mask


def sdpa(q, k, v, attn_mask=None, is_causal: bool = False, scale: float | None = None,
         use_flash: bool = False):
    """Scaled dot-product attention over [B, N, H, Dh] tensors
    (`vjepa2_tpu/ops/attention.py:38-72`). ``attn_mask`` is boolean, True =
    attend: [N, M], [B, N, M] or [B, H, N, M]; ``is_causal`` ANDs the lower
    triangle into it. ``use_flash`` runs the BHND flash kernel (B3) only with
    no mask, not causal and no scale, as JAX does: on a CUDA tensor a head
    width it does not take raises, as `Attention` does, and on a CPU tensor
    its plain version runs. Otherwise the plain math runs on any device, as
    JAX's branch is plain XLA: fp32 scores, the probabilities cast before
    P.V. A row with no key to attend gives 0 (JAX's -1e30 fill averages v
    there: ROADMAP queue C, "Fully masked rows")."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    if use_flash and attn_mask is None and not is_causal and scale is None:
        return fa.flash_attention(q, k, v)
    mask = None
    if attn_mask is not None:
        mask = attn_mask.to(device=q.device, dtype=torch.bool)
        if mask.ndim == 2:
            mask = mask[None, None]
        elif mask.ndim == 3:  # one mask an example, shared by its heads
            mask = mask[:, None]
    if is_causal:
        causal = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        mask = causal if mask is None else mask & causal
    out, _ = softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale,
                               mask)
    return out.transpose(1, 2)


def _apply_rope_cache_bhnd(x, cache):
    """Interleaved-pair RoPE over [B, H, N, D] (cache [N, rot] or [B, N, rot])."""
    cos, sin = cache
    if cos.ndim == 3:
        cos, sin = cos[:, None], sin[:, None]
    rot = cos.shape[-1]
    sub = x[..., :rot]
    rotated = (sub * cos + rotate_pairs(sub) * sin).to(x.dtype)
    if rot < x.shape[-1]:
        return torch.cat([rotated, x[..., rot:]], dim=-1)
    return rotated


def attend_bhnd(q, k, v, rope_cache=None, segment_ids=None, use_flash: bool = False,
                rope_expanded=None, head_perm=None, kv_valid: int | None = None):
    """Attention over [B, H, N, D] operands, returning [B, H, N, D]
    (`vjepa2_tpu/ops/attention.py:301`).

    ``rope_cache`` holds interleaved-convention tables, applied to unrotated
    q and k; or ``rope_expanded`` holds split-half [B|1, N, D] tables with
    ``head_perm``, the matching head-dim permutation, applied here to q and k
    (q·kᵀ is invariant under it, so v and the output stay canonical).
    segment_ids ([N] or [B, N] int): attend iff seg_q >= seg_k. Keys at or
    past ``kv_valid`` are masked. ``use_flash`` runs the BHND flash kernel
    (B3 forward, B4/B5 backward; `flash_attention.flash_attention_bhnd`),
    which on a CPU tensor is its plain version; otherwise the plain math
    runs. The TPU pad search (`_flash_pad_plan`) has no counterpart: the
    CUDA kernels take any length.
    """
    from vjepa2_tpu_torch.ops import flash_attention as fa

    if rope_expanded is not None and head_perm is not None:
        perm = torch.as_tensor(head_perm, device=q.device)
        q, k = q[..., perm], k[..., perm]
    kwargs = dict(segment_ids=segment_ids, kv_valid_len=kv_valid, rope_expanded=rope_expanded)
    if rope_expanded is not None:
        rope_cache = None
    if use_flash:
        return fa.flash_attention_bhnd(q, k, v, rope_tables=rope_cache, **kwargs)
    if rope_cache is not None:  # the interleaved math of the JAX fallback
        q, k = _apply_rope_cache_bhnd(q, rope_cache), _apply_rope_cache_bhnd(k, rope_cache)
    return fa.flash_attention_bhnd_plain(q, k, v, **kwargs)[0]


def attend(q, k, v, rope_cache=None, segment_ids=None, use_flash: bool = False):
    """RoPE plus (frame-causal) attention over unrotated [B, N, H, D]
    operands (`vjepa2_tpu/ops/attention.py:166`): ``rope_cache`` holds
    interleaved-convention tables [N, rot] or [B, N, rot]; token i attends
    to j iff seg[i] >= seg[j]. ``use_flash`` runs the BHND flash kernel as
    `sdpa` does (a head width it does not take raises on a CUDA tensor);
    otherwise the plain math runs."""
    out = attend_bhnd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      rope_cache=rope_cache, segment_ids=segment_ids, use_flash=use_flash)
    return out.transpose(1, 2)


def attend_bhdn(q, k, v, rope_expanded=None, use_flash: bool = False,
                kv_valid: int | None = None, segment_ids=None):
    """Attention over narrow-head [B, H, D, N] operands, returning [B, H, D, N].

    q and k arrive already split-half permuted (the qkv projection folds the
    permutation into its weights); ``rope_expanded`` is the split-half
    [B|1, N, D] table pair. ``use_flash`` runs the flash kernel on a CUDA
    tensor; otherwise, and for a CPU tensor, the plain math runs.
    """
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

    kwargs = dict(rope_expanded=rope_expanded, segment_ids=segment_ids, kv_valid_len=kv_valid)
    if use_flash:
        return fdn.flash_attention_bhdn(q, k, v, **kwargs)
    return fdn.flash_attention_bhdn_plain(q, k, v, **kwargs)[0]
