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
backward alone: the fused prologues' backwards end in it. `ln_stats` is the
forward writing only mean and rstd, the launch B7 and B8 make first (its
own kernel, which reads rows with no ring). The forward with an output and
the backward run on a persistent grid that `ln_row_plan` lays out from the
card's SM count (`sm_count`). The TPU block
pickers (`_pick_block`, `_pick_block_lane`, `_pick_rows`) and `supports` have
no counterpart: they are Mosaic tiling rules.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


# Blocks an SM of B6's persistent row kernels (`csrc/layernorm.cu`): each
# takes at most ~105 KB of shared memory and 168 registers a thread, so two
# fit. A block takes at most LN_MAX_BLOCK_ROWS rows: the backward stages its
# rows' mean and rstd in shared memory.
LN_BLOCKS_PER_SM = 2
LN_MAX_BLOCK_ROWS = 1024


class LnRowPlan(NamedTuple):
    """How B6's persistent kernels (the forward with an output, the
    backward) split R rows of width C over the card."""

    grid: int  # blocks, each a contiguous range of rows (the backward's partial rows)
    rows_per_block: int  # ceil(R / grid); the last block may hold fewer, none holds none
    lanes: int  # lanes of a warp that hold one row
    per_lane: int  # 16-byte chunks a lane holds: ceil(C / 8 / lanes)


def ln_lanes(C: int) -> int:
    """Lanes that hold one row of width C in B6's kernels: 16 at 384 (48
    chunks of 16 bytes as 16 lanes x 3, two rows a warp), else 32 (1024 as 32
    x 4, 1280 as 32 x 5, and 1408 as 32 x 6 with the sixth chunk on half the
    lanes: 16 lanes x 11 ran slower on an H100, and in the backward would hold
    176 dgamma/dbeta sums a lane in registers)."""
    return 16 if C == 384 else 32


@functools.lru_cache(maxsize=256)
def ln_row_plan(R: int, C: int, sm_count: int) -> LnRowPlan:
    """B6's persistent grid for R rows of width C on a card of ``sm_count``
    SMs: at most `LN_BLOCKS_PER_SM` blocks an SM and at most one a row, each
    block a contiguous range of ceil(R / blocks) rows (at most
    `LN_MAX_BLOCK_ROWS`, so more blocks than that only past 2048 rows an SM),
    then only as many blocks as those ranges need (none empty). Depends on
    nothing else."""
    if C not in LN_WIDTHS:
        raise ValueError(f"row width {C}: the LayerNorm kernels take "
                         f"{', '.join(map(str, LN_WIDTHS))}")
    if R <= 0 or sm_count <= 0:
        raise ValueError(f"no LayerNorm plan for {R} rows on {sm_count} SMs")
    rows = min(-(-R // min(R, LN_BLOCKS_PER_SM * sm_count)), LN_MAX_BLOCK_ROWS)
    lanes = ln_lanes(C)
    return LnRowPlan(-(-R // rows), rows, lanes, -(-(C // 8) // lanes))


_SM_COUNTS: dict[int, int] = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once per device."""
    idx = torch.cuda.current_device() if device.index is None else device.index
    n = _SM_COUNTS.get(idx)
    if n is None:
        n = _SM_COUNTS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


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


def _f32(t):
    """t as a contiguous fp32 tensor (t itself when it is one)."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(dtype=torch.float32).contiguous()


_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch(name, argtypes, device, *args):
    """Call the entry point ``name`` on ``device``'s current stream, switching
    the current device only when it is another."""
    lib, fn = _build.function(name, argtypes)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    _build.check(lib, err, name)


def _ln_fwd_cuda(x, gamma, beta, eps, with_y=True):
    global LAUNCHES
    C = x.shape[-1]
    _check_cuda(x, C, gamma, beta)
    x2 = _rows(x)
    R = x2.shape[0]
    y = torch.empty_like(x2) if with_y else None
    stats = torch.empty((2, R), dtype=torch.float32, device=x.device)  # mean, rstd
    plan = ln_row_plan(R, C, sm_count(x.device))
    p = stats.data_ptr()
    _launch("vjepa2_layernorm_fwd_bf16", _FWD_ARGS, x.device, x2.data_ptr(),
            _f32(gamma).data_ptr(), _f32(beta).data_ptr(), _build.ptr(y), p, p + 4 * R, R, C,
            plan.rows_per_block, eps)
    LAUNCHES += 1
    lead = x.shape[:-1]
    stats = stats.view(2, *lead, 1)
    return (None if y is None else y.view(x.shape)), stats[0], stats[1]


def _ln_bwd_cuda(x, dy, gamma, mean, rstd):
    global LAUNCHES_BWD
    C = x.shape[-1]
    _check_cuda(x, C, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x {tuple(x.shape)} "
                         f"{x.dtype}")
    x2, dy2 = _rows(x), _rows(dy)
    R = x2.shape[0]
    plan = ln_row_plan(R, C, sm_count(x.device))
    dx = torch.empty_like(x2)
    # dgamma and dbeta in one allocation; the partial rows in their own, so
    # that a gradient kept by autograd does not keep them alive
    dparams = torch.empty((2, C), dtype=torch.float32, device=x.device)
    part = torch.empty((2, plan.grid, C), dtype=torch.float32, device=x.device)
    _launch("vjepa2_layernorm_bwd_bf16", _BWD_ARGS, x.device, x2.data_ptr(), dy2.data_ptr(),
            _f32(gamma).data_ptr(), _f32(mean.reshape(R)).data_ptr(),
            _f32(rstd.reshape(R)).data_ptr(), dx.data_ptr(), dparams.data_ptr(),
            part.data_ptr(), R, C, plan.rows_per_block)
    LAUNCHES_BWD += 1
    return dx.view(x.shape), dparams[0], dparams[1]


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


def ln_stats(x, gamma, beta, eps: float = 1e-6):
    """(mean, rstd [..., 1] fp32) of the rows of x: on a CUDA tensor the B6
    forward kernel writing no output, the launch B7 and B8 make first (from
    their C entry points); on a CPU tensor the plain formula."""
    if _device(x) == "cuda":
        return _ln_fwd_cuda(x, gamma, beta, eps, with_y=False)[1:]
    return ln_forward_f32(x, gamma, beta, eps)[1:]


def ln_backward(x, dy, gamma, mean, rstd):
    """The LayerNorm backward from the saved (mean, rstd): (dx in x's dtype,
    dgamma, dbeta fp32). On a CUDA tensor the B6 backward kernels, which take
    ``dy`` in x's dtype (the fused prologues' backwards hand it a bf16
    product, exact in that dtype) and sum dgamma and dbeta on the card in a
    fixed order: the same bits from call to call on one card; a card with
    another SM count has another grid (`ln_row_plan`), which changes only
    their rounding. On a CPU tensor `ln_backward_f32` of ``dy`` in fp32."""
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
