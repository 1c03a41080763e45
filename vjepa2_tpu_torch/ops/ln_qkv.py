"""Fused LayerNorm + qkv projection (+ split-half RoPE) — kernel B7.

Counterpart of `vjepa2_tpu/ops/ln_qkv.py`: the forward `_ln_qkv_kernel:50`
(`pallas_call` `:108`), its plain formulation `_xla_reference:146`, and the
custom VJP `_core_fwd:176` / `_core_bwd:184`:

    x [B, N, C] (pre-LayerNorm) -> LN (fp32 two-pass statistics) -> y in x's
    dtype -> y W^T (fp32 accumulation) + b (fp32, added before the one
    rounding) -> split-half RoPE on q and k in fp32 -> q, k, v [B, H, N, D]

`ln_qkv` is a `torch.autograd.Function` (`LnQkvFunction`). Its forward is a
hand-written Hopper kernel on a CUDA tensor: `csrc/ln_gemm_hopper.cu` (B8's
wgmma and TMA mainloop with a RoPE epilogue) on bf16 x and w, and
`csrc/ln_gemm_fp32.cu` (the same mainloop at fp32: 3xTF32 on wgmma) on fp32
x and w, as JAX's kernel is generic in the dtype; C in 384, 1024, 1280,
1408; D in 32, 64, 80, 88 with the heads `qkv_heads_per_tile` can tile;
other inputs raise. On a CPU tensor it is `ln_qkv_plain`; it saves (x,
gamma, beta, w, cos, sin, mean, rstd), not the LayerNorm output. Its
backward is `_core_bwd` in PyTorch: the RoPE adjoint R^T (`rope_rotate_t`;
not R(-theta), the tables' two slots of a pair carry different angles), the
fp32 dqkv, y recomputed from the saved statistics, dbias, and dW and dy as
products in x's dtype (JAX leaves those to XLA; at fp32 they are fp32
GEMMs); its LayerNorm tail is `layernorm.ln_backward`, the B6 backward
kernel of x's dtype on a CUDA tensor. The RoPE tables get no gradient.

Layouts: ``w`` is [3 H D, C], the port's ``qkv.weight`` (rows q, k, v, each
(h, d)), with any split-half head permutation already applied to the q and
k rows by the caller; JAX's ``w`` is its transpose. The bias is added in fp32
before the rounding, where the unfused projection adds a bias already cast
to the compute dtype (`models/modules.py:406`): the two routes round
differently there, as in JAX. The TPU gate `supports` and its fall-back to
the plain math have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from vjepa2_tpu_torch import _build
from vjepa2_tpu_torch.ops.flash_attention import NOT_TMA_READY, tma_operand
from vjepa2_tpu_torch.ops.layernorm import LN_WIDTHS, ln_backward, ln_forward_f32
from vjepa2_tpu_torch.ops.rope import rope_rotate, rope_rotate_t

# Head widths the kernel takes: the pretrain predictor (32), ViT-L and
# vit_giant_xformers (64), ViT-H (80), the 16-head vit_giant (88).
QKV_HEAD_WIDTHS = (32, 64, 80, 88)
# The heads a column tile of the kernel's GEMM may hold, per head width,
# widest first: the tile is heads x D <= 256 columns (a wgmma's width), holds
# whole heads of one of q, k, v, so that every RoPE pair (d, d + D/2) lies
# in it, and each (D, heads) is a kernel the library instantiates.
QKV_TILE_HEADS = {32: (6, 4), 64: (4, 2), 80: (2,), 88: (2,)}
# The same at fp32 (`csrc/ln_gemm_fp32.cu`): a tile of at most 128 columns,
# whose W stage holds both tf32 parts (hi, lo) of each row, so that a ring
# of four 48 KB stages fits beside the consumers' 64 accumulators a thread;
# one head where two would pass 128, two at D 32 where four do not divide H.
# It takes every head count the bf16 plan takes, and any at D 80 and 88.
QKV_TILE_HEADS_FP32 = {32: (4, 2), 64: (2,), 80: (1,), 88: (1,)}

# Kernel launches since the last reset, on bf16 and, apart, on fp32
# operands; `chip_smoke.py` reads them.
LAUNCHES = 0
LAUNCHES_FP32 = 0


def _tables(rope, x):
    """Split-half (cos, sin) as [B|1, N, D] fp32 on x's device, or (None, None)."""
    if rope is None:
        return None, None
    cos, sin = rope
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    return (cos.to(device=x.device, dtype=torch.float32),
            sin.to(device=x.device, dtype=torch.float32))


def _check_shapes(x, gamma, beta, w, bias, cos, H, D):
    if x.ndim != 3:
        raise ValueError(f"x must be [B, N, C]; got {tuple(x.shape)}")
    B, N, C = x.shape
    if w.shape != (3 * H * D, C) or bias.shape != (3 * H * D,):
        raise ValueError(f"w {tuple(w.shape)} / bias {tuple(bias.shape)} do not fit "
                         f"[{3 * H * D}, {C}] / [{3 * H * D}]")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"gamma/beta must be [{C}]")
    if cos is not None and (cos.ndim != 3 or tuple(cos.shape[1:]) != (N, D)
                            or cos.shape[0] not in (1, B)):
        raise ValueError(f"rope tables {tuple(cos.shape)} do not fit [B|1, {N}, {D}]")


def _split_heads(qkv, H, D):
    """[B, N, 3 H D] -> q, k, v [B, H, N, D]."""
    B, N, _ = qkv.shape
    return qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)


def _plain_fwd(x, gamma, beta, w, bias, cos, sin, eps, H, D):
    y, mean, rstd = ln_forward_f32(x, gamma, beta, eps)
    qkv = torch.matmul(y.to(x.dtype).float(), w.float().t()) + bias.float()
    q, k, v = _split_heads(qkv, H, D)
    if cos is not None:
        q = rope_rotate(q, cos[:, None], sin[:, None])
        k = rope_rotate(k, cos[:, None], sin[:, None])
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype), mean, rstd


def ln_qkv_plain(x, gamma, beta, w, bias, rope=None, eps: float = 1e-6,
                 num_heads: int | None = None, head_dim: int | None = None):
    """Plain PyTorch version of the kernel (`_xla_reference`): q, k, v
    [B, H, N, D] in x's dtype."""
    cos, sin = _tables(rope, x)
    _check_shapes(x, gamma, beta, w, bias, cos, num_heads, head_dim)
    return _plain_fwd(x, gamma, beta, w, bias, cos, sin, eps, num_heads, head_dim)[:3]


def qkv_heads_per_tile(H: int, D: int, dtype=torch.bfloat16) -> int | None:
    """The heads a column tile of B7's GEMM holds for H heads of width D on
    operands of ``dtype``: the widest of `QKV_TILE_HEADS` (bf16) or
    `QKV_TILE_HEADS_FP32` (fp32) that divides H, so that q, k and v each take
    whole tiles (None: the kernel takes no such H)."""
    plan = QKV_TILE_HEADS_FP32 if dtype == torch.float32 else QKV_TILE_HEADS
    return next((n for n in plan.get(D, ()) if H % n == 0), None)


def _ln_qkv_cuda(x, gamma, beta, w, bias, cos, sin, eps, H, D):
    global LAUNCHES, LAUNCHES_FP32
    B, N, C = x.shape
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the ln_qkv kernel on CUDA takes x and w both bf16 or both fp32; got "
                        f"{x.dtype}, {w.dtype}")
    fp32 = x.dtype == torch.float32
    heads = qkv_heads_per_tile(H, D, x.dtype)
    if D not in QKV_HEAD_WIDTHS or C not in LN_WIDTHS or heads is None:
        plan = QKV_TILE_HEADS_FP32 if fp32 else QKV_TILE_HEADS
        raise ValueError(f"ln_qkv kernel: head width {D} (takes "
                         f"{', '.join(map(str, QKV_HEAD_WIDTHS))}), row width {C} (takes "
                         f"{', '.join(map(str, LN_WIDTHS))}), {H} heads (a multiple of one "
                         f"of {plan.get(D, ())})")
    dev = x.device
    # rows of C elements as the kernel steps them; TMA's alignment is checked
    # by the entry point, which refuses an operand it cannot read
    x, w = x.contiguous(), w.contiguous()
    vec = [t.to(device=dev, dtype=torch.float32).contiguous() for t in (gamma, beta, bias)]
    if cos is not None:  # the epilogue reads two entries of a table row at a time
        cos, sin = (t if t.is_contiguous() and t.data_ptr() % 8 == 0
                    else t.clone(memory_format=torch.contiguous_format) for t in (cos, sin))
    q, k, v = (torch.empty((B, H, N, D), dtype=x.dtype, device=dev) for _ in range(3))
    mean = torch.empty((B, N, 1), dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    # fp32: W's tf32 parts (hi rows, then lo rows), which the kernel writes
    split = (torch.empty((2, 3 * H * D, C), dtype=torch.float32, device=dev),) if fp32 else ()
    lib, fn = _build.function("vjepa2_ln_qkv_f32" if fp32 else "vjepa2_ln_qkv_bf16",
                              [ctypes.c_void_p] * (12 + len(split)) + [ctypes.c_int] * 7
                              + [ctypes.c_float, ctypes.c_void_p])
    for attempt in range(2):
        with torch.cuda.device(dev):
            err = fn(*map(_build.ptr, (x, *vec[:2], w, vec[2], cos, sin, *split, q, k, v, mean,
                                       rstd)),
                     B, N, C, H, D, heads, 1 if cos is None else cos.shape[0], eps,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != NOT_TMA_READY or attempt:
            break
        x, w = tma_operand(x), tma_operand(w)
    _build.check(lib, err, "ln_qkv")
    if fp32:
        LAUNCHES_FP32 += 1
    else:
        LAUNCHES += 1
    return q, k, v, mean, rstd


def _fwd(x, *args):
    """The kernel or, on the CPU, its plain version, laid out as the kernel
    writes its outputs (`_fwd_fake`)."""
    if x.device.type == "cpu":
        return tuple(t.contiguous() for t in _plain_fwd(x, *args))
    if x.device.type == "cuda":
        return _ln_qkv_cuda(x, *args)
    raise ValueError(f"no ln_qkv route for device {x.device}")


def _fwd_fake(x, gamma, beta, w, bias, cos, sin, eps, num_heads, head_dim):
    """The outputs without the work, for tracing (`torch.export`): q, k, v
    [B, H, N, D] in x's dtype and mean, rstd [B, N, 1] fp32, contiguous."""
    B, N, _ = x.shape
    qkv = [x.new_empty((B, num_heads, N, head_dim)) for _ in range(3)]
    return (*qkv, *(x.new_empty((B, N, 1), dtype=torch.float32) for _ in range(2)))


# The forward is one dispatcher op, ``torch.ops.vjepa2.ln_qkv``, so that a
# selective remat policy can keep its q, k and v (JAX's "flash_qkv" name, which
# the fused route's q, k and v carry into `flash_attention.py:1124-1126`) and
# the recompute launches nothing (`models.modules.resolve_remat_policy`); its
# fake kernel lets `torch.export` trace it into a graph as one node.
_LIB = torch.library.Library("vjepa2", "FRAGMENT")
_LIB.define("ln_qkv(Tensor x, Tensor gamma, Tensor beta, Tensor w, Tensor bias, Tensor? cos, "
            "Tensor? sin, float eps, int num_heads, int head_dim) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("ln_qkv", _fwd, "CompositeExplicitAutograd")
torch.library.register_fake("vjepa2::ln_qkv", _fwd_fake, lib=_LIB)


class LnQkvFunction(torch.autograd.Function):
    """B7 forward, `_core_bwd` backward with the B6 backward as its tail."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, cos, sin, eps, num_heads, head_dim):
        q, k, v, mean, rstd = torch.ops.vjepa2.ln_qkv(x, gamma, beta, w, bias, cos, sin, eps,
                                                      num_heads, head_dim)
        ctx.save_for_backward(x, gamma, beta, w, cos, sin, mean, rstd)
        ctx.dims = (num_heads, head_dim, bias.dtype)
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, gamma, beta, w, cos, sin, mean, rstd = ctx.saved_tensors
        H, D, bias_dtype = ctx.dims
        B, N, C = x.shape
        if cos is not None:
            dq = rope_rotate_t(dq.float(), cos[:, None], sin[:, None])
            dk = rope_rotate_t(dk.float(), cos[:, None], sin[:, None])
        dqkv = torch.cat([g.float().transpose(1, 2).reshape(B, N, H * D) for g in (dq, dk, dv)],
                         dim=-1)  # [B, N, 3 H D] fp32
        y = (x.float() - mean) * rstd * gamma.float() + beta.float()
        dbias = dqkv.sum((0, 1))
        dqkv = dqkv.to(x.dtype)
        dw = torch.matmul(dqkv.reshape(-1, 3 * H * D).t(), y.to(x.dtype).reshape(-1, C))
        dy = torch.matmul(dqkv, w.to(x.dtype))
        dx, dgamma, dbeta = ln_backward(x, dy, gamma, mean, rstd)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dw.to(w.dtype),
                dbias.to(bias_dtype), None, None, None, None, None)


def ln_qkv(x, gamma, beta, w, bias, rope=None, eps: float = 1e-6,
           num_heads: int | None = None, head_dim: int | None = None):
    """LN(x) W^T + b split into per-head q, k, v [B, H, N, D] in x's dtype,
    q and k rotated by the split-half tables ``rope`` = (cos, sin)
    [B|1, N, D] (or [N, D]) when given. x [B, N, C]; gamma, beta [C]; w
    [3 H D, C]; bias [3 H D]. Differentiable in x, gamma, beta, w and bias."""
    if num_heads is None or head_dim is None:
        raise ValueError("ln_qkv needs num_heads and head_dim")
    cos, sin = _tables(rope, x)
    _check_shapes(x, gamma, beta, w, bias, cos, num_heads, head_dim)
    return LnQkvFunction.apply(x, gamma, beta, w, bias, cos, sin, eps, num_heads, head_dim)
