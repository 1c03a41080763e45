"""Flash attention forward over [B, H, D, N] ("DN") operands — kernel B1.

Counterpart of `vjepa2_tpu/ops/flash_attention_dn.py` (`_fwd_kernel_dn:129`,
`_flash_fwd_bhdn:198`, `flash_attention_bhdn:573`). On a CUDA tensor
`flash_attention_bhdn` launches the hand-written Hopper kernel in
`csrc/flash_fwd_dn.cu` or raises; on a CPU tensor it runs
`flash_attention_bhdn_plain`, the plain PyTorch math of the JAX package's
fallback (`ops/attention.py:278-298`). There is no other route.

The TPU block plan, lane padding and fp32 segment side-inputs have no
counterpart: the CUDA kernel masks its own ragged edge and compares int32
segment ids as integers (the TPU kernel casts them to fp32, exact only below
2**24).

Only the forward is ported. Its backward (B2) is later work, so the CUDA
route refuses inputs that require grad under grad mode; the CPU plain path
stays differentiable by autograd.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vjepa2_tpu_torch import _build
from vjepa2_tpu_torch.ops.attention import attention_mask, softmax_attention
from vjepa2_tpu_torch.ops.rope import rope_rotate

LOG2E = 1.4426950408889634  # 1 / ln 2

# Inclusive head-width bound of the DN route (`flash_attention_dn.py:670`).
DN_MAX_D = 64

# Kernel launches since the last reset; `chip_smoke.py` reads it to show the
# main path went through the kernel.
LAUNCHES = 0

_fn = None


def dn_head_eligible(d: int) -> bool:
    """Head widths the DN kernel takes: 16, 32, 48 and 64."""
    return d % 8 == 0 and (d // 2) % 8 == 0 and 0 < d <= DN_MAX_D


def _normalize(q, k, v, rope_expanded, segment_ids, kv_valid_len):
    """Validate the arguments; return (cos, sin, tables_nd, seg [S, N]) with
    the tables left in the layout they came in (``tables_nd``: [Tb, N, D])."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, H, D, N]")
    B, H, D, N = q.shape
    M = k.shape[3]
    if k.shape != (B, H, D, M) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not dn_head_eligible(D):
        raise ValueError(f"head width {D} is not DN-eligible (16, 32, 48 or 64)")
    if segment_ids is not None and kv_valid_len is not None:
        raise ValueError("segment_ids + kv_valid_len is unsupported: give pad keys "
                         "segment id int32-max instead")
    if kv_valid_len is not None and not 0 < kv_valid_len <= M:
        raise ValueError(f"kv_valid_len {kv_valid_len} outside (0, {M}]")
    seg = None
    if segment_ids is not None:
        seg = segment_ids if segment_ids.ndim == 2 else segment_ids[None]
        if seg.shape[1] != N or N != M or seg.shape[0] not in (1, B):
            raise ValueError(f"segment_ids {tuple(segment_ids.shape)} do not fit N={N}, M={M}")
    cos = sin = None
    tables_nd = True
    if rope_expanded is not None:
        cos, sin = rope_expanded
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        # the JAX rule: [.., N, D] unless the second-to-last dim is D
        tables_nd = cos.shape[-1] == D and cos.shape[-2] != D
        want = (N, D) if tables_nd else (D, N)
        if (N != M or tuple(cos.shape[1:]) != want or sin.shape != cos.shape
                or cos.shape[0] not in (1, B)):
            raise ValueError(f"rope tables {tuple(cos.shape)} do not fit q {tuple(q.shape)}")
    return cos, sin, tables_nd, seg


def flash_attention_bhdn_plain(q, k, v, scale: float | None = None, rope_expanded=None,
                               segment_ids=None, kv_valid_len: int | None = None):
    """Plain PyTorch version of the kernel: (out [B, H, D, N], lse [B, H, N]).

    RoPE rotates q and k in fp32 and rounds them to the compute dtype; the
    scores take the scale in fp32 (the kernel instead folds scale*log2(e)
    into q before rounding, `flash_attention_dn.py:163-164`).
    """
    cos, sin, tables_nd, seg = _normalize(q, k, v, rope_expanded, segment_ids, kv_valid_len)
    D = q.shape[2]
    qn, kn, vn = (t.transpose(2, 3) for t in (q, k, v))
    if cos is not None:
        if not tables_nd:
            cos, sin = cos.transpose(1, 2), sin.transpose(1, 2)
        cos = cos.to(device=q.device, dtype=torch.float32)[:, None]
        sin = sin.to(device=q.device, dtype=torch.float32)[:, None]
        qn = rope_rotate(qn.float(), cos, sin).to(q.dtype)
        kn = rope_rotate(kn.float(), cos, sin).to(k.dtype)
    mask = attention_mask(q.shape[3], k.shape[3], q.device, kv_valid_len, seg)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out, lse = softmax_attention(qn, kn, vn, scale, mask)
    return out.transpose(2, 3), lse


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load()
        fn = lib.vjepa2_flash_fwd_dn_bf16
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _flash_fwd_cuda(q, k, v, scale, cos, sin, tables_nd, seg, kv_valid_len):
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_bhdn on CUDA takes bf16; {name} is {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be unit-stride along N (the kernel's coalesced dim)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash backward (B2) is not ported yet: call the CUDA forward "
                           "under torch.inference_mode() or torch.no_grad()")
    B, H, D, N = q.shape
    M = k.shape[3]
    dev = q.device
    t_b = t_d = t_n = seg_b = 0
    if cos is not None:
        # [B|1, D, N] contiguous: the kernel reads 8 tokens of one feature at a time
        if tables_nd:
            cos, sin = cos.transpose(1, 2), sin.transpose(1, 2)
        cos = cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = sin.to(device=dev, dtype=torch.float32).contiguous()
        t_b = cos.stride(0) if cos.shape[0] > 1 else 0
        t_d, t_n = cos.stride(1), cos.stride(2)
    if seg is not None:
        seg = seg.to(device=dev, dtype=torch.int32).contiguous()
        seg_b = seg.stride(0) if seg.shape[0] > 1 else 0
    out = torch.empty((B, H, D, N), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    # the kernel's prologue writes rotated, rounded q and k here, token-major
    q_rot = torch.empty((B, H, N, D), dtype=q.dtype, device=dev)
    k_rot = torch.empty((B, H, M, D), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 20)(*q.stride(), *k.stride(), *v.stride(), *out.stride(),
                                        t_b, t_d, t_n, seg_b)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_lim = M if kv_valid_len is None else kv_valid_len
    lib, fn = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = fn(ptr(q), ptr(k), ptr(v), ptr(cos), ptr(sin), ptr(seg), ptr(out), ptr(lse),
                 ptr(q_rot), ptr(k_rot), B, H, D, N, M, kv_lim, strides, scale * LOG2E,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "flash_fwd_dn")
    LAUNCHES += 1
    return out, lse


def flash_attention_bhdn(q, k, v, scale: float | None = None, rope_expanded=None,
                         segment_ids=None, kv_valid_len: int | None = None,
                         return_lse: bool = False):
    """Flash attention over [B, H, D, N] tensors.

    rope_expanded: split-half (cos, sin), [B|1, N, D] as
    `ops.rope.expand_rope_cache` emits them, or [B|1, D, N]. q and k must
    carry the matching head-dim permutation.
    segment_ids: [N] or [B, N] int; query i attends to key j iff
    seg[i] >= seg[j]. Exclusive with kv_valid_len.
    kv_valid_len: number of real keys; keys at or beyond it are masked.

    Returns out [B, H, D, N] (and lse [B, H, N] fp32 with ``return_lse``).
    A CUDA tensor launches the kernel (bf16 only) or raises; a CPU tensor
    takes `flash_attention_bhdn_plain`.
    """
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must be on one device")
    if q.device.type == "cuda":
        cos, sin, tables_nd, seg = _normalize(q, k, v, rope_expanded, segment_ids, kv_valid_len)
        out, lse = _flash_fwd_cuda(q, k, v, scale, cos, sin, tables_nd, seg, kv_valid_len)
    elif q.device.type == "cpu":
        out, lse = flash_attention_bhdn_plain(q, k, v, scale, rope_expanded, segment_ids,
                                              kv_valid_len)
    else:
        raise ValueError(f"no DN flash route for device {q.device}")
    return (out, lse) if return_lse else out
