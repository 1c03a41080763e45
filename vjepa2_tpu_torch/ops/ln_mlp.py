"""Fused LayerNorm + MLP-in projection + exact GELU — kernel B8.

Counterpart of `vjepa2_tpu/ops/ln_mlp.py`: the forward `_ln_mlp_kernel:78`
(`pallas_call` `:106`), its plain formulation `_xla_reference:139`, and the
custom VJP `_core_fwd:154` / `_core_bwd:160`:

    x [B, N, C] (pre-LayerNorm) -> LN (fp32 two-pass statistics) -> y in x's
    dtype -> z = y W^T (fp32 accumulation) + b (fp32) -> 0.5 z (1 + erf(z /
    sqrt 2)) -> h [B, N, hidden] in x's dtype

`ln_mlp` is a `torch.autograd.Function` (`LnMlpFunction`). Its forward is the
dispatcher op ``torch.ops.vjepa2.ln_mlp``: on a CUDA tensor a hand-written
Hopper kernel, `csrc/ln_gemm_hopper.cu` (wgmma and TMA) on bf16 x and w and
`csrc/ln_gemm_fp32.cu` (the same mainloop at fp32: 3xTF32 on wgmma) on fp32
x and w, as JAX's kernel is generic in the dtype (C in 384, 1024, 1280,
1408; hidden in 1536, 4096, 5120, 6144; other inputs raise); on a CPU
tensor `ln_mlp_plain`; it saves (x,
gamma, beta, w, bias, mean, rstd). Its backward is `_core_bwd` in PyTorch: z
recomputed with one product (fp32 out), dgelu = Phi(z) + z phi(z), dbias, dW
and dy as products in x's dtype, then the LayerNorm tail
`layernorm.ln_backward` (the B6 backward kernel on a CUDA tensor). ``w`` is
[hidden, C], the port's ``fc1.weight``.

The kernel computes erf with CUDA's `erff`: the TPU kernel's
Abramowitz-Stegun polynomial (`_erf_poly:57`, |err| <= 1.5e-7) stands in for
an `erf` Mosaic cannot lower, and both JAX reference paths use `lax.erf`.
The TPU block pickers and `supports` have no counterpart.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vjepa2_tpu_torch import _build
from vjepa2_tpu_torch.ops.flash_attention import NOT_TMA_READY, tma_operand
from vjepa2_tpu_torch.ops.layernorm import LN_WIDTHS, ln_backward, ln_forward_f32

# Hidden widths the kernel takes: mlp_ratio 4 at C 384, 1024, 1280 and
# vit_giant's 48/11 at 1408.
MLP_HIDDEN_WIDTHS = (1536, 4096, 5120, 6144)

# Kernel launches since the last reset, on bf16 and, apart, on fp32
# operands; `chip_smoke.py` reads them.
LAUNCHES = 0
LAUNCHES_FP32 = 0

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def gelu_exact(z):
    """0.5 z (1 + erf(z / sqrt 2)) (`_gelu_exact:52`)."""
    return 0.5 * z * (1.0 + torch.erf(z * _INV_SQRT2))


def _check_shapes(x, gamma, beta, w, bias):
    if x.ndim != 3:
        raise ValueError(f"x must be [B, N, C]; got {tuple(x.shape)}")
    C = x.shape[-1]
    if w.ndim != 2 or w.shape[1] != C or bias.shape != (w.shape[0],):
        raise ValueError(f"w {tuple(w.shape)} / bias {tuple(bias.shape)} do not fit "
                         f"[hidden, {C}] / [hidden]")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"gamma/beta must be [{C}]")


def _z(y, w, bias):
    """y W^T + b in fp32 from y and w in their (compute) dtype: fp32
    accumulation and no rounding of the product, as JAX's
    ``preferred_element_type=float32``. At fp32 on the card this is an fp32
    GEMM (TF32 off), where the forward's kernel took 3xTF32 products: the
    two z differ by ~1e-6 relative (fp32 sums in another order; the split's
    dropped lo*lo term is below 2^-22), and GELU's derivative Phi(z) + z
    phi(z) has slope phi(z) (2 - z^2), at most 0.8 in magnitude, so dgelu
    moves by ~1e-6 |z| there: four orders below the fp32 step's 1e-3
    gradient tolerance."""
    if y.device.type == "cuda" and y.dtype != torch.float32:
        z = torch.mm(y.reshape(-1, y.shape[-1]), w.t(), out_dtype=torch.float32)
        return z.view(*y.shape[:-1], w.shape[0]) + bias.float()
    return torch.matmul(y.float(), w.float().t()) + bias.float()


def _plain_fwd(x, gamma, beta, w, bias, eps):
    y, mean, rstd = ln_forward_f32(x, gamma, beta, eps)
    z = torch.matmul(y.to(x.dtype).float(), w.float().t()) + bias.float()
    return gelu_exact(z).to(x.dtype), mean, rstd


def ln_mlp_plain(x, gamma, beta, w, bias, eps: float = 1e-6):
    """Plain PyTorch version of the kernel (`_xla_reference`): h
    [B, N, hidden] in x's dtype."""
    _check_shapes(x, gamma, beta, w, bias)
    return _plain_fwd(x, gamma, beta, w, bias, eps)[0]


def _ln_mlp_cuda(x, gamma, beta, w, bias, eps):
    global LAUNCHES, LAUNCHES_FP32
    B, N, C = x.shape
    hidden = w.shape[0]
    if C not in LN_WIDTHS or hidden not in MLP_HIDDEN_WIDTHS:
        raise ValueError(f"ln_mlp kernel: row width {C} (takes {', '.join(map(str, LN_WIDTHS))}), "
                         f"hidden {hidden} (takes {', '.join(map(str, MLP_HIDDEN_WIDTHS))})")
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the ln_mlp kernel on CUDA takes x and w both bf16 or both fp32; got "
                        f"{x.dtype}, {w.dtype}")
    fp32 = x.dtype == torch.float32
    dev = x.device
    # rows of C elements as the kernel steps them; TMA's alignment is checked
    # by the entry point, which refuses an operand it cannot read
    x, w = x.contiguous(), w.contiguous()
    vec = [t.to(device=dev, dtype=torch.float32).contiguous() for t in (gamma, beta, bias)]
    h = torch.empty((B, N, hidden), dtype=x.dtype, device=dev)
    mean = torch.empty((B, N, 1), dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    # fp32: W's tf32 parts (hi rows, then lo rows), which the kernel writes
    split = (torch.empty((2, hidden, C), dtype=torch.float32, device=dev),) if fp32 else ()
    lib, fn = _build.function("vjepa2_ln_mlp_f32" if fp32 else "vjepa2_ln_mlp_bf16",
                              [ctypes.c_void_p] * (8 + len(split)) + [ctypes.c_int] * 3
                              + [ctypes.c_float, ctypes.c_void_p])
    for attempt in range(2):
        with torch.cuda.device(dev):
            err = fn(*map(_build.ptr, (x, *vec[:2], w, vec[2], *split, h, mean, rstd)), B * N, C,
                     hidden, eps, torch.cuda.current_stream(dev).cuda_stream)
        if err != NOT_TMA_READY or attempt:
            break
        x, w = tma_operand(x), tma_operand(w)
    _build.check(lib, err, "ln_mlp")
    if fp32:
        LAUNCHES_FP32 += 1
    else:
        LAUNCHES += 1
    return h, mean, rstd


def _fwd(x, *args):
    """The kernel or, on the CPU, its plain version, laid out as the kernel
    writes its outputs (`_fwd_fake`)."""
    if x.device.type == "cpu":
        return tuple(t.contiguous() for t in _plain_fwd(x, *args))
    if x.device.type == "cuda":
        return _ln_mlp_cuda(x, *args)
    raise ValueError(f"no ln_mlp route for device {x.device}")


def _fwd_fake(x, gamma, beta, w, bias, eps):
    """The outputs without the work, for tracing (`torch.export`): h
    [B, N, hidden] in x's dtype and mean, rstd [B, N, 1] fp32, contiguous."""
    B, N, _ = x.shape
    return (x.new_empty((B, N, w.shape[0])),
            *(x.new_empty((B, N, 1), dtype=torch.float32) for _ in range(2)))


def _op(x, gamma, beta, w, bias, eps):
    """The op's kernel: `_fwd`, looked up at each call, so that a wrapper put
    in its place (a test's count of B8's forwards) sees every launch."""
    return _fwd(x, gamma, beta, w, bias, eps)


# The forward is one dispatcher op, ``torch.ops.vjepa2.ln_mlp``, as B7's: its
# fake kernel lets `torch.export` trace it into a graph as one node.
_LIB = torch.library.Library("vjepa2", "FRAGMENT")
_LIB.define("ln_mlp(Tensor x, Tensor gamma, Tensor beta, Tensor w, Tensor bias, float eps) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.impl("ln_mlp", _op, "CompositeExplicitAutograd")
torch.library.register_fake("vjepa2::ln_mlp", _fwd_fake, lib=_LIB)


class LnMlpFunction(torch.autograd.Function):
    """B8 forward, `_core_bwd` backward with the B6 backward as its tail."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps):
        h, mean, rstd = torch.ops.vjepa2.ln_mlp(x, gamma, beta, w, bias, eps)
        ctx.save_for_backward(x, gamma, beta, w, bias, mean, rstd)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, gamma, beta, w, bias, mean, rstd = ctx.saved_tensors
        C, hidden = x.shape[-1], w.shape[0]
        y = ((x.float() - mean) * rstd * gamma.float() + beta.float()).to(x.dtype)
        z = _z(y, w, bias)  # as the forward produced it
        dgelu = (0.5 * (1.0 + torch.erf(z * _INV_SQRT2))
                 + z * torch.exp(-0.5 * z * z) * _INV_SQRT_2PI)
        dz = dh.float() * dgelu
        dbias = dz.sum((0, 1))
        dz = dz.to(x.dtype)
        dw = torch.matmul(dz.reshape(-1, hidden).t(), y.reshape(-1, C))
        dy = torch.matmul(dz, w.to(x.dtype))
        dx, dgamma, dbeta = ln_backward(x, dy, gamma, mean, rstd)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dw.to(w.dtype),
                dbias.to(bias.dtype), None)


def ln_mlp(x, gamma, beta, w, bias, eps: float = 1e-6):
    """gelu_exact(LN(x) W^T + b) with fp32 LayerNorm statistics: x
    [B, N, C]; gamma, beta [C]; w [hidden, C]; bias [hidden]. Returns h
    [B, N, hidden] in x's dtype. Differentiable in x, gamma, beta, w and
    bias."""
    _check_shapes(x, gamma, beta, w, bias)
    return LnMlpFunction.apply(x, gamma, beta, w, bias, eps)
