"""Flash attention over [B, H, D, N] ("DN") operands — kernels B1 and B2.

Counterpart of `vjepa2_tpu/ops/flash_attention_dn.py`: the forward
(`_fwd_kernel_dn:129`, `_flash_fwd_bhdn:198`), the backward
(`_bwd_fused_kernel_dn:298`, `_flash_bwd_bhdn:379`) and the differentiable
entry point (`_flash_core_dn:492`, `flash_attention_bhdn:573`).

`flash_attention_bhdn` is a `torch.autograd.Function` (`FlashAttentionDN`):
its forward saves (q, k, v, out, lse) and its backward is
`flash_attention_bhdn_bwd`. JAX runs both in the operands' dtype, and so
does the port. On a CUDA tensor each launches its hand-written Hopper kernel
or raises: bf16 operands `csrc/flash_fwd_dn.cu` and `csrc/flash_bwd_dn.cu`
(both on wgmma and TMA); fp32 operands the 3xTF32 kernels of
`csrc/flash_fp32.cuh` (`flash_attention.fp32_forward` / `fp32_backward`),
whose split pre-pass reads the DN layout in place and whose epilogues store
out, dq, dk and dv D-major, head widths 16-64 as JAX's DN route takes them.
On a CPU tensor they run `flash_attention_bhdn_plain` (the plain math of the
JAX package's fallback, `ops/attention.py:278-298`) and
`flash_attention_bhdn_bwd_plain` (the B2 math written out). There is no
other route. Segment ids and RoPE tables stay outside autograd: they get no
gradient.

The TPU block plan, lane padding and fp32 segment side-inputs have no
counterpart: the CUDA kernels mask their own ragged edge and compare int32
segment ids as integers (the TPU kernels cast them to fp32, exact only below
2**24).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vjepa2_tpu_torch import _build
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops.attention import attention_mask, softmax_attention
from vjepa2_tpu_torch.ops.flash_attention import NOT_TMA_READY, padded_queries, tma_ready
from vjepa2_tpu_torch.ops.rope import rope_rotate, rope_rotate_t

# Inclusive head-width bound of the DN route (`flash_attention_dn.py:670`).
DN_MAX_D = 64

# Kernel launches since the last reset, forward (B1) and backward (B2), bf16
# and fp32 apart; `chip_smoke.py` reads them to show the main path went
# through the kernels.
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_FP32 = 0
LAUNCHES_BWD_FP32 = 0


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
        # [.., N, D] unless only [.., D, N] fits; when N == D both fit and the
        # tables are read [N, D], as `expand_rope_cache` emits them (the JAX
        # rule, `flash_attention_dn.py:621`, reads them [D, N] there)
        tables_nd = cos.shape[-1] == D and (cos.shape[-2] != D or N == D)
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


def flash_attention_bhdn_bwd_plain(q, k, v, out, lse, do, scale: float | None = None,
                                   rope_expanded=None, segment_ids=None,
                                   kv_valid_len: int | None = None):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv), each
    [B, H, D, N|M] in q's dtype; the math of `_bwd_fused_kernel_dn` plus
    `_flash_bwd_bhdn`, in fp32 (`flash_attention_dn.py:298-484`).

    p is recomputed from lse (0 where lse is -inf or the pair is masked);
    delta = rowsum(do * out); dv = p^T do; ds = p (dp - delta) scale with
    dp = do v^T; dk = ds^T q_rot; dq = ds k_rot; then the RoPE adjoint
    (`rope_rotate_t`) takes dq and dk back to the unrotated q and k. q and k
    are rotated in fp32 and rounded to their dtype, as in the forward.
    """
    cos, sin, tables_nd, seg = _normalize(q, k, v, rope_expanded, segment_ids, kv_valid_len)
    D = q.shape[2]
    qn, kn, vn, on, don = (t.transpose(2, 3).float() for t in (q, k, v, out, do))
    if cos is not None:
        if not tables_nd:
            cos, sin = cos.transpose(1, 2), sin.transpose(1, 2)
        cos = cos.to(device=q.device, dtype=torch.float32)[:, None]
        sin = sin.to(device=q.device, dtype=torch.float32)[:, None]
        qn = rope_rotate(qn, cos, sin).to(q.dtype).float()
        kn = rope_rotate(kn, cos, sin).to(k.dtype).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lse = lse.float()[..., None]
    p = torch.exp(torch.matmul(qn, kn.transpose(-1, -2)) * scale - lse)
    keep = ~torch.isneginf(lse)
    mask = attention_mask(q.shape[3], k.shape[3], q.device, kv_valid_len, seg)
    if mask is not None:
        keep = keep & mask
    p = torch.where(keep, p, 0.0)
    delta = (don * on).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), don)
    ds = p * (torch.matmul(don, vn.transpose(-1, -2)) - delta) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qn)
    dq = torch.matmul(ds, kn)
    if cos is not None:
        dq = rope_rotate_t(dq, cos, sin)
        dk = rope_rotate_t(dk, cos, sin)
    return tuple(t.transpose(2, 3).to(q.dtype) for t in (dq, dk, dv))


def _side_inputs(dev, cos, sin, tables_nd, seg):
    """RoPE tables as [B|1, D, N] contiguous fp32 (the kernels read 8 tokens
    of one feature at a time) and segment ids as int32, on ``dev``; plus
    their strides (t_b, t_d, t_n, seg_b), batch stride 0 when shared."""
    t_b = t_d = t_n = seg_b = 0
    if cos is not None:
        if tables_nd:
            cos, sin = cos.transpose(1, 2), sin.transpose(1, 2)
        cos = cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = sin.to(device=dev, dtype=torch.float32).contiguous()
        t_b = cos.stride(0) if cos.shape[0] > 1 else 0
        t_d, t_n = cos.stride(1), cos.stride(2)
    if seg is not None:
        seg = seg.to(device=dev, dtype=torch.int32).contiguous()
        seg_b = seg.stride(0) if seg.shape[0] > 1 else 0
    return cos, sin, seg, (t_b, t_d, t_n, seg_b)


def _fp32_side(dev, cos, sin, tables_nd, seg):
    """The fp32 kernels' side inputs of a DN call, in `fa.fp32_forward`'s
    form: the tables as `_side_inputs` lays them out ([B|1, D, N], unit
    along the tokens) with their (t_b, t_n, t_d) strides, and the ids as
    both query and key ids (int32 [S, N]) with their batch strides."""
    cos, sin, seg, (t_b, t_d, _, seg_b) = _side_inputs(dev, cos, sin, tables_nd, seg)
    tables = (t_b, 1, t_d) if cos is not None else (0, 0, 1)
    return cos, sin, tables, seg, seg, (seg_b, seg_b)


def _flash_fwd_fp32(q, k, v, scale, cos, sin, tables_nd, seg, kv_valid_len):
    """B1 on fp32 operands (`fa.fp32_forward` on the [B, H, N, D] views of
    the DN tensors): out [B, H, D, N] contiguous and lse."""
    global LAUNCHES_FP32
    B, H, D, N = q.shape
    M = k.shape[3]
    cos, sin, tables, seg_q, seg_k, seg_b = _fp32_side(q.device, cos, sin, tables_nd, seg)
    out = torch.empty((B, H, D, N), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    Mv = M if kv_valid_len is None else kv_valid_len
    fa.fp32_forward(*(t.transpose(2, 3) for t in (q, k, v, out)), lse, scale, cos, sin, tables,
                    Mv, seg_q, seg_k, seg_b, False)
    LAUNCHES_FP32 += 1
    return out, lse


def _flash_bwd_fp32(q, k, v, out, lse, do, scale, cos, sin, tables_nd, seg, kv_valid_len):
    """B2 on fp32 operands (`fa.fp32_backward`): dq, dk, dv [B, H, D, N|M]
    contiguous, dk and dv zero at and past kv_valid."""
    global LAUNCHES_BWD_FP32
    M = k.shape[3]
    cos, sin, tables, seg_q, seg_k, seg_b = _fp32_side(q.device, cos, sin, tables_nd, seg)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=q.device) for t in (q, k, v))
    Mv = M if kv_valid_len is None else kv_valid_len
    fa.fp32_backward(*(t.transpose(2, 3) for t in (q, k, v, out)), lse, do.transpose(2, 3), dq,
                     dk, dv, True, scale, cos, sin, tables, Mv, seg_q, seg_k, seg_b, False)
    LAUNCHES_BWD_FP32 += 1
    return dq, dk, dv


def v_copy_shape(v) -> tuple:
    """The buffer into which B1's prologue copies v [B, H, D, M] (and B2's
    copies v or do) when its TMA loads cannot read it in place (the entry
    point refuses it, by `tma_ready`'s rule: a contiguous v needs M % 8 ==
    0): [B, H, D, M rounded up to 8], so that each feature's tokens start
    16-byte aligned."""
    B, H, D, M = v.shape
    return (B, H, D, (M + 7) // 8 * 8)


def fwd_scratch_shapes(q, k) -> tuple:
    """The scratch B1 always takes: q' [B, H, N, D] and k' [B, H, M, D]
    (bf16, rotated and rounded by the prologue, token-major)."""
    B, H, D, N = q.shape
    M = k.shape[3]
    return (B, H, N, D), (B, H, M, D)


def _flash_fwd_cuda(q, k, v, scale, cos, sin, tables_nd, seg, kv_valid_len):
    global LAUNCHES
    if fa.operand_dtype("DN", q=q, k=k, v=v) == torch.float32:
        return _flash_fwd_fp32(q, k, v, scale, cos, sin, tables_nd, seg, kv_valid_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be unit-stride along N (the kernel's coalesced dim)")
    B, H, D, N = q.shape
    M = k.shape[3]
    dev = q.device
    cos, sin, seg, side = _side_inputs(dev, cos, sin, tables_nd, seg)
    out = torch.empty((B, H, D, N), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    q_rot, k_rot = (torch.empty(shape, dtype=q.dtype, device=dev)
                    for shape in fwd_scratch_shapes(q, k))
    strides = (ctypes.c_longlong * 20)(*q.stride(), *k.stride(), *v.stride(), *out.stride(),
                                        *side)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_lim = M if kv_valid_len is None else kv_valid_len
    lib, fn = _build.function("vjepa2_flash_fwd_dn_bf16", _build.launcher_argtypes(11, 6, 1))
    v_copy = None
    for attempt in range(2):
        with torch.cuda.device(dev):
            err = fn(*map(_build.ptr, (q, k, v, cos, sin, seg, out, lse, q_rot, k_rot, v_copy)),
                     B, H, D, N, M, kv_lim, strides, scale * _build.LOG2E,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != NOT_TMA_READY or attempt:
            break
        v_copy = torch.empty(v_copy_shape(v), dtype=q.dtype, device=dev)
    _build.check(lib, err, "flash_fwd_dn")
    LAUNCHES += 1
    return out, lse


@functools.lru_cache(maxsize=256)
def bwd_scratch(B: int, H: int, D: int, N: int, M: int) -> tuple[tuple, int]:
    """B2's scratch: byte offsets (256-aligned) in one buffer of q_s and q_u
    [B, H, N, D] and k_rot [B, H, M, D] (bf16, token-major, rotated and
    rounded by the prologue for the TMA loads), delta and lse*log2(e)
    [B, H, Np] fp32 (Np = N rounded up to the dQ block of 128), and its
    size."""
    tokens = padded_queries(N)
    sizes = [B * H * N * D * 2, B * H * N * D * 2, B * H * M * D * 2, B * H * tokens * 4,
             B * H * tokens * 4]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 256) * 256
    return tuple(offsets), total


def bwd_copy_shapes(v, do) -> tuple:
    """The buffers B2's prologue copies v and do into when its TMA loads
    cannot read them in place (`tma_ready`'s rule, which the entry point
    checks before it refuses): [B, H, D, tokens rounded up to 8]
    (`v_copy_shape`), or None for an operand read in place. A do whose unit
    stride is along D, as autograd hands it over from the output projection,
    is copied."""
    return tuple(None if tma_ready(t) else v_copy_shape(t) for t in (v, do))


def _flash_bwd_cuda(q, k, v, out, lse, do, scale, cos, sin, tables_nd, seg, kv_valid_len):
    global LAUNCHES_BWD
    dtype = fa.operand_dtype("DN", q=q, k=k, v=v, out=out, do=do)
    B, H, D, N = q.shape
    M = k.shape[3]
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, N):
        raise ValueError(f"out {tuple(out.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous fp32 [B, H, N], as the forward returns it")
    dev = q.device
    if any(t.device != dev for t in (out, lse, do)):
        raise ValueError("q, k, v, out, lse and do must be on one device")
    if dtype == torch.float32:
        return _flash_bwd_fp32(q, k, v, out, lse, do, scale, cos, sin, tables_nd, seg,
                               kv_valid_len)
    cos, sin, seg, side = _side_inputs(dev, cos, sin, tables_nd, seg)
    dq = torch.empty((B, H, D, N), dtype=q.dtype, device=dev)
    dk = torch.empty((B, H, D, M), dtype=q.dtype, device=dev)
    dv = torch.empty((B, H, D, M), dtype=q.dtype, device=dev)
    offsets, size = bwd_scratch(B, H, D, N, M)
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    pieces = [scratch.data_ptr() + off for off in offsets]
    strides = (ctypes.c_longlong * 24)(*q.stride(), *k.stride(), *v.stride(), *out.stride(),
                                        *do.stride(), *side)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_lim = M if kv_valid_len is None else kv_valid_len
    lib, fn = _build.function("vjepa2_flash_bwd_dn_bf16", _build.launcher_argtypes(19, 6, 2))
    copies = (None, None)
    for attempt in range(2):
        with torch.cuda.device(dev):
            err = fn(*map(_build.ptr, (q, k, v, out, do, lse, cos, sin, seg, dq, dk, dv,
                                       *pieces, *copies)),
                     B, H, D, N, M, kv_lim, strides, scale, scale * _build.LOG2E,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != NOT_TMA_READY or attempt:
            break
        # the prologue copies what TMA cannot step into buffers it can
        copies = tuple(None if shape is None else torch.empty(shape, dtype=q.dtype, device=dev)
                       for shape in bwd_copy_shapes(v, do))
    _build.check(lib, err, "flash_bwd_dn")
    LAUNCHES_BWD += 1
    return dq, dk, dv


def _device(*tensors) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("q, k and v must be on one device")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no DN flash route for device {dev}")
    return dev.type


def flash_attention_bhdn_bwd(q, k, v, out, lse, do, scale: float | None = None,
                             rope_expanded=None, segment_ids=None,
                             kv_valid_len: int | None = None):
    """The backward of `flash_attention_bhdn`: (dq, dk, dv) from the forward's
    inputs, its (out, lse) and the cotangent ``do`` of out.

    A CUDA tensor launches B2 (bf16 or fp32; any strides) or raises; a CPU
    tensor takes `flash_attention_bhdn_bwd_plain`.
    """
    if _device(q, k, v) == "cpu":
        return flash_attention_bhdn_bwd_plain(q, k, v, out, lse, do, scale, rope_expanded,
                                              segment_ids, kv_valid_len)
    norm = _normalize(q, k, v, rope_expanded, segment_ids, kv_valid_len)
    return _flash_bwd_cuda(q, k, v, out, lse, do, scale, *norm, kv_valid_len)


def _fwd_op(q, k, v, scale, cos, sin, segment_ids, kv_valid_len):
    """The forward: B1 on a CUDA tensor, its plain version on a CPU one (laid
    out as the kernel writes them, contiguous, as `_fwd_fake` says)."""
    rope = None if cos is None else (cos, sin)
    if _device(q, k, v) == "cpu":
        out, lse = flash_attention_bhdn_plain(q, k, v, scale, rope, segment_ids, kv_valid_len)
        return out.contiguous(), lse.contiguous()
    norm = _normalize(q, k, v, rope, segment_ids, kv_valid_len)
    return _flash_fwd_cuda(q, k, v, scale, *norm, kv_valid_len)


def _fwd_fake(q, k, v, scale, cos, sin, segment_ids, kv_valid_len):
    """The forward's outputs without the work, for tracing (`torch.export`):
    out [B, H, D, N] in q's dtype and lse [B, H, N] fp32, both contiguous.
    Operands on different devices (or on none the kernels serve) raise, as
    in the real forward."""
    _device(q, k, v)
    B, H, D, N = q.shape
    return q.new_empty((B, H, D, N)), q.new_empty((B, H, N), dtype=torch.float32)


# The forward is one dispatcher op, ``torch.ops.vjepa2.flash_fwd_dn``, so that
# a selective remat policy can keep its (out, lse) (JAX's "flash_out" and
# "flash_lse" names, `flash_attention_dn.py:650-651`) and the recompute
# launches nothing (`models.modules.resolve_remat_policy`); its fake kernel
# lets `torch.export` trace it into a graph as one node (`hub.export`).
_LIB = torch.library.Library("vjepa2", "FRAGMENT")
_LIB.define("flash_fwd_dn(Tensor q, Tensor k, Tensor v, float? scale, Tensor? cos, "
            "Tensor? sin, Tensor? segment_ids, int? kv_valid_len) -> (Tensor, Tensor)")
_LIB.impl("flash_fwd_dn", _fwd_op, "CompositeExplicitAutograd")
torch.library.register_fake("vjepa2::flash_fwd_dn", _fwd_fake, lib=_LIB)


class FlashAttentionDN(torch.autograd.Function):
    """B1 forward, B2 backward (`_flash_core_dn:492`, `_core_fwd_dn:503`,
    `_core_bwd_dn:513`). The forward saves (q, k, v, out, lse); lse is an
    output without a gradient; tables and segment ids get none."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rope_expanded, segment_ids, kv_valid_len):
        cos, sin = (None, None) if rope_expanded is None else rope_expanded
        out, lse = torch.ops.vjepa2.flash_fwd_dn(q, k, v, scale, cos, sin, segment_ids,
                                                 kv_valid_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, rope_expanded, segment_ids, kv_valid_len)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bhdn_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_bhdn(q, k, v, scale: float | None = None, rope_expanded=None,
                         segment_ids=None, kv_valid_len: int | None = None,
                         return_lse: bool = False):
    """Flash attention over [B, H, D, N] tensors. Differentiable in q, k, v.

    rope_expanded: split-half (cos, sin), [B|1, N, D] as
    `ops.rope.expand_rope_cache` emits them, or [B|1, D, N]. q and k must
    carry the matching head-dim permutation.
    segment_ids: [N] or [B, N] int; query i attends to key j iff
    seg[i] >= seg[j]. Exclusive with kv_valid_len.
    kv_valid_len: number of real keys; keys at or beyond it are masked.

    Returns out [B, H, D, N] (and lse [B, H, N] fp32 with ``return_lse``).
    A CUDA tensor launches the kernels (bf16 or fp32: head width 16, 32, 48
    or 64; bf16 q, k, v unit-stride along N, fp32 ones at any strides) or
    raises; a CPU tensor takes the plain versions.
    """
    out, lse = FlashAttentionDN.apply(q, k, v, scale, rope_expanded, segment_ids, kv_valid_len)
    return (out, lse) if return_lse else out
