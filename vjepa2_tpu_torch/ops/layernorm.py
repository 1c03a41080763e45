"""LayerNorm forward and backward over rows — kernel B6.

Counterpart of `vjepa2_tpu/ops/layernorm.py`: the forward `_ln_fwd_kernel:103`
(`pallas_call` `:137`), the backward `_ln_bwd_kernel:115` (`:164`), the
differentiable `layer_norm:219`, and the shared plain formulas
`ln_forward_f32:73` and `ln_backward_f32:88`, whose variance is the two-pass
``mean((x - mean)^2)``, not the fast variance of the models' `LayerNorm`
module (`models/modules.py`). The fused prologues (`ops/ln_qkv.py`,
`ops/ln_mlp.py`) normalise with these formulas, so their LayerNorm differs
from the unfused one by that rounding, as in JAX.

`layer_norm` is a `torch.autograd.Function` (`LayerNormFunction`) whose
forward and backward are the hand-written Hopper kernels of
`csrc/layernorm.cu` on a CUDA tensor (bf16, C in 384, 1024, 1280, 1408; other
inputs raise) and the plain formulas on a CPU tensor. `ln_backward` is the
backward alone: the fused prologues' backwards end in it. The TPU block
pickers (`_pick_block`, `_pick_block_lane`, `_pick_rows`) and `supports` have
no counterpart: they are Mosaic tiling rules.
"""

from __future__ import annotations

import ctypes

import torch

from vjepa2_tpu_torch import _build

# Row widths the CUDA kernels take (ViT-L 1024, ViT-H 1280, vit_giant 1408,
# the pretrain predictor 384).
LN_WIDTHS = (384, 1024, 1280, 1408)

# Kernel launches since the last reset, forward and backward; `chip_smoke.py`
# reads them to show the main path went through the kernels.
LAUNCHES = 0
LAUNCHES_BWD = 0


def ln_forward_f32(x, gamma, beta, eps: float):
    """The fp32 LayerNorm forward formula (statistics and affine) shared by
    the plain versions of B6, B7 and B8: (y fp32, mean, rstd), mean and rstd
    [..., 1]."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return xc * rstd * gamma.float() + beta.float(), mean, rstd


def ln_backward_f32(x, dy, gamma, mean, rstd):
    """The LayerNorm backward formula given the saved (mean, rstd) [..., 1]
    and an fp32 cotangent ``dy`` of the affine output: fp32 (dx, dgamma,
    dbeta), dgamma and dbeta summed over every leading axis."""
    xhat = (x.float() - mean) * rstd
    wdy = dy * gamma.float()
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd
    red = tuple(range(x.ndim - 1))
    return dx, (dy * xhat).sum(red), dy.sum(red)


def _check_cuda(x, C, *fp32):
    if C not in LN_WIDTHS:
        raise ValueError(f"row width {C}: the LayerNorm kernels take "
                         f"{', '.join(map(str, LN_WIDTHS))}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the LayerNorm kernels on CUDA take bf16 rows; got {x.dtype}")
    for t in fp32:
        if t.device != x.device or t.shape != (C,):
            raise ValueError(f"gamma/beta must be [{C}] on {x.device}")


def _rows(x):
    """x [..., C] as contiguous [R, C] (the kernels read 16-byte chunks)."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("the LayerNorm kernels need 16-byte aligned rows")
    return x2


def _vector(t):
    return t.to(dtype=torch.float32).contiguous()


def _ln_fwd_cuda(x, gamma, beta, eps):
    global LAUNCHES
    C = x.shape[-1]
    _check_cuda(x, C, gamma, beta)
    x2 = _rows(x)
    R = x2.shape[0]
    y = torch.empty_like(x2)
    mean = torch.empty((R,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib, fn = _build.function("vjepa2_layernorm_fwd_bf16",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                              + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(*map(_build.ptr, (x2, _vector(gamma), _vector(beta), y, mean, rstd)), R, C,
                 eps, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layernorm_fwd")
    LAUNCHES += 1
    lead = x.shape[:-1]
    return y.view(x.shape), mean.view(*lead, 1), rstd.view(*lead, 1)


def _ln_bwd_cuda(x, dy, gamma, mean, rstd):
    global LAUNCHES_BWD
    C = x.shape[-1]
    _check_cuda(x, C, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x {tuple(x.shape)} "
                         f"{x.dtype}")
    x2, dy2 = _rows(x), _rows(dy)
    R = x2.shape[0]
    mean, rstd = (t.reshape(R).float().contiguous() for t in (mean, rstd))
    dx = torch.empty_like(x2)
    lib, blocks = _build.function("vjepa2_layernorm_bwd_blocks", [ctypes.c_int])
    parts = torch.empty((2, blocks(R), C), dtype=torch.float32, device=x.device)
    _, fn = _build.function("vjepa2_layernorm_bwd_bf16",
                            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(*map(_build.ptr, (x2, dy2, _vector(gamma), mean, rstd, dx, parts[0], parts[1])),
                 R, C, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layernorm_bwd")
    LAUNCHES_BWD += 1
    dgamma, dbeta = parts.sum(1)  # the per-block partials, as the TPU sums its cells'
    return dx.view(x.shape), dgamma, dbeta


def _device(x) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no LayerNorm route for device {x.device}")
    return x.device.type


def ln_forward(x, gamma, beta, eps: float = 1e-6):
    """(y in x's dtype, mean, rstd [..., 1] fp32): the B6 forward kernel on a
    CUDA tensor, the plain formula on a CPU tensor."""
    if _device(x) == "cuda":
        return _ln_fwd_cuda(x, gamma, beta, eps)
    y, mean, rstd = ln_forward_f32(x, gamma, beta, eps)
    return y.to(x.dtype), mean, rstd


def ln_backward(x, dy, gamma, mean, rstd):
    """The LayerNorm backward from the saved (mean, rstd): (dx in x's dtype,
    dgamma, dbeta fp32). On a CUDA tensor the B6 backward kernel, which takes
    ``dy`` in x's dtype (the fused prologues' backwards hand it a bf16
    product, exact in that dtype); on a CPU tensor `ln_backward_f32` of
    ``dy`` in fp32."""
    if _device(x) == "cuda":
        return _ln_bwd_cuda(x, dy, gamma, mean, rstd)
    dx, dgamma, dbeta = ln_backward_f32(x, dy.float(), gamma, mean, rstd)
    return dx.to(x.dtype), dgamma, dbeta


class LayerNormFunction(torch.autograd.Function):
    """B6 forward and backward (`_ln_core:190`, `_ln_core_fwd:195`,
    `_ln_core_bwd:200`): the forward saves (x, gamma, mean, rstd)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = ln_forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.beta_dtype = beta.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = ln_backward(x, dy.to(x.dtype), gamma, mean, rstd)
        return dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis: x [..., C], gamma and beta [C]. fp32
    statistics and affine whatever x's dtype, output in x's dtype.
    Differentiable in x, gamma and beta."""
    return LayerNormFunction.apply(x, gamma, beta, eps)
