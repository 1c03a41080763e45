"""Flash attention over [B, H, N, D] ("BHND") operands — kernels B3, B4 and B5.

Counterpart of `vjepa2_tpu/ops/flash_attention.py`: the forward
(`_fwd_kernel:166`, `_flash_fwd_bhnd:257`), both backwards (the one-pass
`_bwd_fused_kernel:511` and the two-pass `_dq_kernel:361` / `_dkv_kernel:434`,
chosen in `_flash_bwd_bhnd:613` by a TPU scoped-VMEM rule), and the
differentiable entry points `flash_attention_bhnd:988` and the BNHD
`flash_attention:1148`.

`flash_attention_bhnd` is a `torch.autograd.Function` (`FlashAttentionBHND`):
its forward saves (q, k, v, out, lse) and its backward is
`flash_attention_bhnd_bwd`. On a CUDA tensor each launches its hand-written
Hopper kernel (`csrc/flash_fwd_bhnd.cu`, `csrc/flash_bwd_bhnd.cu`) or raises;
on a CPU tensor they run `flash_attention_bhnd_plain` and
`flash_attention_bhnd_bwd_plain`. There is no other route. One CUDA backward
serves both TPU backwards: it computes their one function, with no gate.
Segment ids and RoPE tables stay outside autograd: they get no gradient.

The TPU-only pieces have no counterpart: block plans (`pick_block`,
`FWD_CAP_WIDE`, `block_h`), the fp32 segment columns and `_seg_mask` (the
CUDA kernels compare int32 ids as integers, where the TPU kernels cast them
to fp32, exact only below 2**24), and `_mosaic_available`. A row with no key
to attend gives output 0 and lse -inf (the TPU kernel's finite -1e30 mask
averages v there).
"""

from __future__ import annotations

import ctypes
import math

import torch

from vjepa2_tpu_torch import _build
from vjepa2_tpu_torch.ops.attention import attention_mask, softmax_attention
from vjepa2_tpu_torch.ops.rope import expand_rope_tables, rope_rotate, rope_rotate_t

# Head widths the CUDA kernels take: ViT-H 1280/16, vit_giant 1408/16,
# vit_gigantic 1664/16, and the ViT-L encoder's 64 and the predictor's 32,
# which the fused LayerNorm route (`models.modules.Attention`, ``ln=``) sends
# here rope-free; the unfused route sends heads of 16-64 to the DN kernels
# (`flash_attention_dn`).
BHND_HEAD_WIDTHS = (32, 64, 80, 88, 104)

# Kernel launches since the last reset, forward (B3) and backward (B4/B5);
# `chip_smoke.py` reads them to show the main path went through the kernels.
LAUNCHES = 0
LAUNCHES_BWD = 0


def bhnd_head_supported(d: int) -> bool:
    """Whether the CUDA kernels take head width ``d``."""
    return d in BHND_HEAD_WIDTHS


def _batch_ids(ids, batch: int, length: int, name: str):
    """[N] / [1, N] / [B, N] integer ids -> [B, N], broadcast explicitly."""
    ids = ids if ids.ndim == 2 else ids[None]
    if ids.shape[1] != length or ids.shape[0] not in (1, batch):
        raise ValueError(f"{name} {tuple(ids.shape)} do not fit [{batch}, {length}]")
    if ids.is_floating_point():
        raise TypeError(f"{name} must be integers (they compare exactly)")
    return ids.expand(batch, length)


def _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len):
    """Validate the arguments; return (cos, sin, seg_q [B, N], seg_k [B, M])."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, H, N, D]")
    B, H, N, D = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if segment_ids is not None and causal:
        # the kernels apply segments or token-causal, as in JAX (`:1033-1039`);
        # frame-causal attention rides segment ids alone
        raise ValueError("segment_ids and causal=True cannot be combined; encode "
                         "causality in the segment ids instead")
    if kv_valid_len is not None and not 0 < kv_valid_len <= M:
        raise ValueError(f"kv_valid_len {kv_valid_len} outside (0, {M}]")
    seg_q = seg_k = None
    if segment_ids is not None:
        seg_q = _batch_ids(segment_ids, B, N, "segment_ids")
        if seg_kv is not None:
            seg_k = _batch_ids(seg_kv, B, M, "seg_kv")
        elif N == M:
            seg_k = seg_q
        else:
            raise ValueError("segment_ids with N != M need seg_kv for the keys")
    elif seg_kv is not None:
        raise ValueError("seg_kv without segment_ids: give the query side's ids too")
    cos = sin = None
    if rope_expanded is not None:
        cos, sin = rope_expanded
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        if (N != M or tuple(cos.shape[1:]) != (N, D) or sin.shape != cos.shape
                or cos.shape[0] not in (1, B)):
            raise ValueError(f"rope tables {tuple(cos.shape)} do not fit q {tuple(q.shape)}")
    return cos, sin, seg_q, seg_k


def _expand(q, k, rope_tables):
    """Interleaved-convention tables [N|B, N, rot] -> (q and k permuted to the
    split-half layout, the split-half fp32 tables, the permutation)."""
    cos, sin = rope_tables
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin, perm = expand_rope_tables(cos, sin, q.shape[-1])
    perm = torch.as_tensor(perm, device=q.device)
    return q[..., perm], k[..., perm], (cos.float(), sin.float()), perm


def _mask(n, m, device, seg_q, seg_k, causal, kv_valid_len):
    mask = attention_mask(n, m, device, kv_valid_len)
    if seg_q is not None:
        seg = seg_q.to(device)[:, None, :, None] >= seg_k.to(device)[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if causal:
        tri = torch.ones(n, m, dtype=torch.bool, device=device).tril()
        mask = tri if mask is None else mask & tri
    return mask


def _rotated(q, k, cos, sin, dtype=None):
    """q and k rotated in fp32 and rounded to their dtype (then cast to
    ``dtype``), as the kernels' prologues round them."""
    if cos is None:
        return (q, k) if dtype is None else (q.to(dtype), k.to(dtype))
    cos = cos.to(device=q.device, dtype=torch.float32)[:, None]
    sin = sin.to(device=q.device, dtype=torch.float32)[:, None]
    qr = rope_rotate(q.float(), cos, sin).to(q.dtype)
    kr = rope_rotate(k.float(), cos, sin).to(k.dtype)
    return (qr, kr) if dtype is None else (qr.to(dtype), kr.to(dtype))


def _plain_fwd(q, k, v, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    qr, kr = _rotated(q, k, cos, sin)
    mask = _mask(q.shape[2], k.shape[2], q.device, seg_q, seg_k, causal, kv_valid_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return softmax_attention(qr, kr, v, scale, mask)


def _plain_bwd(q, k, v, out, lse, do, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    qr, kr = _rotated(q, k, cos, sin, torch.float32)
    vf, of, dof = v.float(), out.float(), do.float()
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    lse = lse.float()[..., None]
    p = torch.exp(torch.matmul(qr, kr.transpose(-1, -2)) * scale - lse)
    keep = ~torch.isneginf(lse)
    mask = _mask(q.shape[2], k.shape[2], q.device, seg_q, seg_k, causal, kv_valid_len)
    if mask is not None:
        keep = keep & mask
    p = torch.where(keep, p, 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qr)
    dq = torch.matmul(ds, kr)
    if cos is not None:
        cos = cos.to(device=q.device, dtype=torch.float32)[:, None]
        sin = sin.to(device=q.device, dtype=torch.float32)[:, None]
        dq = rope_rotate_t(dq, cos, sin)
        dk = rope_rotate_t(dk, cos, sin)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bhnd_plain(q, k, v, segment_ids=None, causal: bool = False,
                               scale: float | None = None, rope_tables=None, rope_expanded=None,
                               kv_valid_len: int | None = None, seg_kv=None):
    """Plain PyTorch version of the kernel: (out [B, H, N, D], lse [B, H, N]).

    RoPE rotates q and k in fp32 and rounds them to the compute dtype; the
    scores take the scale in fp32 (the kernel instead folds scale*log2(e)
    into q before rounding, `flash_attention.py:209-217`).
    """
    if rope_tables is not None:
        q, k, rope_expanded, _ = _expand(q, k, rope_tables)
    norm = _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len)
    return _plain_fwd(q, k, v, scale, *norm, causal, kv_valid_len)


def flash_attention_bhnd_bwd_plain(q, k, v, out, lse, do, segment_ids=None,
                                   causal: bool = False, scale: float | None = None,
                                   rope_tables=None, rope_expanded=None,
                                   kv_valid_len: int | None = None, seg_kv=None):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in q's
    dtype, the math shared by `_bwd_fused_kernel` and `_dq_kernel` /
    `_dkv_kernel` plus `_flash_bwd_bhnd`, in fp32.

    p is recomputed from the given lse (0 where lse is -inf or the pair is
    masked), so a ring hop may pass a global lse; delta = rowsum(do * out);
    dv = p^T do; ds = p (dp - delta) scale with dp = do v^T; dk = ds^T q_rot;
    dq = ds k_rot; then the RoPE adjoint (`rope_rotate_t`).
    """
    return _bwd_with_tables(_plain_bwd, q, k, v, out, lse, do, segment_ids, causal, scale,
                            rope_tables, rope_expanded, kv_valid_len, seg_kv)


def _bwd_with_tables(core, q, k, v, out, lse, do, segment_ids, causal, scale, rope_tables,
                     rope_expanded, kv_valid_len, seg_kv):
    """``core`` on normalised arguments; with interleaved ``rope_tables`` it
    runs in the split-half layout and dq, dk are permuted back."""
    perm = None
    if rope_tables is not None:
        q, k, rope_expanded, perm = _expand(q, k, rope_tables)
    norm = _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len)
    dq, dk, dv = core(q, k, v, out, lse, do, scale, *norm, causal, kv_valid_len)
    if perm is not None:
        inv = torch.argsort(perm)
        dq, dk = dq[..., inv], dk[..., inv]
    return dq, dk, dv


def _check_cuda(D, **tensors):
    if not bhnd_head_supported(D):
        raise ValueError(f"head width {D}: the BHND flash kernels take "
                         f"{', '.join(map(str, BHND_HEAD_WIDTHS))}")
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the BHND flash kernels on CUDA take bf16; {name} is {t.dtype}")


def _side_inputs(dev, cos, sin, seg_q, seg_k):
    """RoPE tables as [B|1, N, D] contiguous fp32 and segment ids as [B, N|M]
    int32, on ``dev``; plus their strides (t_b, t_n, t_d, segq_b, segk_b),
    batch stride 0 when shared."""
    t_b = t_n = t_d = segq_b = segk_b = 0
    if cos is not None:
        cos = cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = sin.to(device=dev, dtype=torch.float32).contiguous()
        t_b = cos.stride(0) if cos.shape[0] > 1 else 0
        t_n, t_d = cos.stride(1), cos.stride(2)
    if seg_q is not None:
        seg_q = seg_q.to(device=dev, dtype=torch.int32).contiguous()
        seg_k = seg_k.to(device=dev, dtype=torch.int32).contiguous()
        segq_b, segk_b = seg_q.stride(0), seg_k.stride(0)
    return cos, sin, seg_q, seg_k, (t_b, t_n, t_d, segq_b, segk_b)


def _flash_fwd_cuda(q, k, v, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    global LAUNCHES
    B, H, N, D = q.shape
    M = k.shape[2]
    _check_cuda(D, q=q, k=k, v=v)
    dev = q.device
    cos, sin, seg_q, seg_k, side = _side_inputs(dev, cos, sin, seg_q, seg_k)
    # BNHD memory seen as BHND: the output projection reads it as [B, N, H*D]
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    lib, fn = _build.function("vjepa2_flash_fwd_bhnd_bf16", _build.launcher_argtypes(10, 7, 1))
    _, size = _build.function("vjepa2_flash_fwd_bhnd_scratch_bytes", [ctypes.c_int] * 5,
                              ctypes.c_longlong)
    # the prologue writes rotated q, k and transposed v here
    scratch = torch.empty(size(B, H, D, N, M), dtype=torch.uint8, device=dev)
    strides = (ctypes.c_longlong * 21)(*q.stride(), *k.stride(), *v.stride(), *out.stride(),
                                        *side)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_lim = M if kv_valid_len is None else kv_valid_len
    with torch.cuda.device(dev):
        err = fn(*map(_build.ptr, (q, k, v, cos, sin, seg_q, seg_k, out, lse, scratch)),
                 B, H, D, N, M, kv_lim, int(causal), strides, scale * _build.LOG2E,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "flash_fwd_bhnd")
    LAUNCHES += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, out, lse, do, scale, cos, sin, seg_q, seg_k, causal,
                    kv_valid_len):
    global LAUNCHES_BWD
    B, H, N, D = q.shape
    M = k.shape[2]
    _check_cuda(D, q=q, k=k, v=v, out=out, do=do)
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, N):
        raise ValueError(f"out {tuple(out.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous fp32 [B, H, N], as the forward returns it")
    dev = q.device
    if any(t.device != dev for t in (out, lse, do)):
        raise ValueError("q, k, v, out, lse and do must be on one device")
    cos, sin, seg_q, seg_k, side = _side_inputs(dev, cos, sin, seg_q, seg_k)
    dq = torch.empty((B, H, N, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, H, M, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, H, M, D), dtype=q.dtype, device=dev)
    lib, fn = _build.function("vjepa2_flash_bwd_bhnd_bf16", _build.launcher_argtypes(14, 7, 2))
    _, size = _build.function("vjepa2_flash_bwd_bhnd_scratch_bytes", [ctypes.c_int] * 5,
                              ctypes.c_longlong)
    # the prologue writes the operands in the layouts the main kernels read
    scratch = torch.empty(size(B, H, D, N, M), dtype=torch.uint8, device=dev)
    strides = (ctypes.c_longlong * 25)(*q.stride(), *k.stride(), *v.stride(), *out.stride(),
                                        *do.stride(), *side)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_lim = M if kv_valid_len is None else kv_valid_len
    with torch.cuda.device(dev):
        err = fn(*map(_build.ptr, (q, k, v, out, do, lse, cos, sin, seg_q, seg_k, dq, dk, dv,
                                   scratch)),
                 B, H, D, N, M, kv_lim, int(causal), strides, scale, scale * _build.LOG2E,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "flash_bwd_bhnd")
    LAUNCHES_BWD += 1
    return dq, dk, dv


def _device(*tensors) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("q, k and v must be on one device")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no BHND flash route for device {dev}")
    return dev.type


def _fwd(q, k, v, *args):
    """The forward on normalised arguments: the kernel or, on the CPU, its
    plain version."""
    return (_plain_fwd if _device(q, k, v) == "cpu" else _flash_fwd_cuda)(q, k, v, *args)


def _bwd(q, k, v, *args):
    """The backward on normalised arguments, dispatched as `_fwd`."""
    return (_plain_bwd if _device(q, k, v) == "cpu" else _flash_bwd_cuda)(q, k, v, *args)


def flash_attention_bhnd_bwd(q, k, v, out, lse, do, segment_ids=None, causal: bool = False,
                             scale: float | None = None, rope_tables=None, rope_expanded=None,
                             kv_valid_len: int | None = None, seg_kv=None):
    """The backward of `flash_attention_bhnd`: (dq, dk, dv) from the forward's
    inputs, an (out, lse) pair and the cotangent ``do`` of out. ``lse`` may be
    a global one, as a ring hop's backward passes it (with ``seg_kv``).

    A CUDA tensor launches the B4/B5 kernel (bf16, any strides) or raises; a
    CPU tensor takes `flash_attention_bhnd_bwd_plain`.
    """
    return _bwd_with_tables(_bwd, q, k, v, out, lse, do, segment_ids, causal, scale,
                            rope_tables, rope_expanded, kv_valid_len, seg_kv)


class FlashAttentionBHND(torch.autograd.Function):
    """B3 forward, B4/B5 backward (`_flash_attention_core:803`,
    `_core_fwd:816`, `_core_bwd:826`). The forward saves (q, k, v, out, lse);
    lse is an output without a gradient; tables and segment ids get none."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len):
        norm = _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len)
        ctx.args = (scale, *norm, causal, kv_valid_len)
        out, lse = _fwd(q, k, v, *ctx.args)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_bhnd(q, k, v, segment_ids=None, causal: bool = False,
                         scale: float | None = None, rope_tables=None, rope_expanded=None,
                         kv_valid_len: int | None = None, seg_kv=None,
                         return_lse: bool = False):
    """Flash attention over [B, H, N, D] tensors. Differentiable in q, k, v.

    segment_ids: [N] or [B, N] int; query i attends to key j iff
    seg[i] >= seg[j] (frame-causal); ``seg_kv`` gives the keys their own ids
    (a ring hop's keys). causal: token-causal, key j <= query i; exclusive
    with segment ids. rope_tables: interleaved-convention (cos, sin) [N, rot]
    or [B, N, rot], applied to unrotated q and k. rope_expanded: split-half
    (cos, sin) [B|1, N, D] from `ops.rope.expand_rope_cache`, with q and k
    already carrying its head-dim permutation. kv_valid_len: number of real
    keys; keys at or beyond it are masked.

    Returns out [B, H, N, D] (and lse [B, H, N] fp32 with ``return_lse``).
    A CUDA tensor launches the kernels (bf16, head width 32, 64, 80, 88 or
    104) or raises; a CPU tensor takes the plain versions.
    """
    if rope_tables is not None:
        q, k, rope_expanded, _ = _expand(q, k, rope_tables)  # differentiable gathers
    out, lse = FlashAttentionBHND.apply(q, k, v, scale, rope_expanded, segment_ids, seg_kv,
                                        causal, kv_valid_len)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, segment_ids=None, causal: bool = False, scale: float | None = None,
                    rope_tables=None, kv_valid_len: int | None = None):
    """BNHD convenience wrapper: q, k, v [B, N, H, D] -> [B, N, H, D]."""
    out = flash_attention_bhnd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               segment_ids=segment_ids, causal=causal, scale=scale,
                               rope_tables=rope_tables, kv_valid_len=kv_valid_len)
    return out.transpose(1, 2)
