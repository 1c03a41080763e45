"""B6, B7 and B8 on fp32 operands on the card: the LayerNorm kernels of
`vjepa2_tpu_torch/csrc/layernorm.cu` (`_f32` entry points, with the
statistics launch of `csrc/ln_common.cuh`) and the fused prologues of
`csrc/ln_gemm_fp32.cu` (3xTF32 on wgmma after W's tf32 split), against their
plain PyTorch versions on the same fp32 inputs, over the edges the model
shapes do not reach:

* row counts that are not multiples of a ring stage's rows or of the GEMM's
  128-row tiles (1, 7, 37, 130, 1003) and fewer rows than B6's grid has
  blocks; tiles across examples;
* a stack-pad row of zeros, which must give beta (B6) and no NaN;
* rows with |mean| >> std (mean 300, std 1), where a one-pass variance
  E[x^2] - E[x]^2 would lose ~1e-2 of the variance to cancellation: rstd
  and y against an fp64 LayerNorm;
* every head width and heads-a-tile choice of B7 at fp32 (D 32 with 4 or 2
  heads, 64 with 2, 80 and 88 with 1), tables none, shared and per
  example; every hidden width of B8;
* the unaligned-operand retry: an x view at a 4-byte offset and a strided W
  (the entry point refuses, `NOT_TMA_READY`; the wrapper copies,
  `tma_operand`, and the call launches once);
* dgamma/dbeta of the fp32 backward, and B8's h, bit-equal from call to call;
* fp16 and mixed dtypes refused with a message that says what is taken;
* the fp32 launch counters apart from the bf16 ones, and a fused fp32
  `Block` forward and backward on the card (B7, B8, B3 and the BHND backward
  at fp32, two B6 backwards) against the same block on the CPU.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_ln_fp32_cuda.py -q

Tolerances. B6: fp32 on both sides, only the summation order differs (sums
over C <= 1408 in another order, `rsqrtf` within 2 ulp): mean 1e-6 + 1e-6
|mean|, rstd 1e-6 relative, y and dx 1e-5 + 1e-5 |plain|, dgamma/dbeta 1e-5
relative L2 (`chip_smoke.py` LN_FP32_*). The cancellation rows against
fp64: rstd 1e-4 relative, y 1e-3. B7/B8: the fp32 flash kernels' 2e-5
relative L2 and 1e-4 x max|plain| (the tensor cores' truncating adds over
C / 8 k-steps: ~1e-5 at C 1408). The block: fp32 on both sides through
LayerNorm, two products, attention and the backward's fp32 GEMMs: 1e-4
relative L2 per gradient.
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops import layernorm as tln
from vjepa2_tpu_torch.ops import ln_mlp as tlnm
from vjepa2_tpu_torch.ops import ln_qkv as tlnq
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

pytestmark = pytest.mark.cuda

STAT_TOL, RSTD_RTOL, LN_TOL, PARAM_REL_L2 = 1e-6, 1e-6, 1e-5, 1e-5
REL_L2, MAX_ABS = 2e-5, 1e-4
BLOCK_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dev, seed, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(np.float32)).to(dev)


def _affine(C, dev, seed=7):
    return _rand((C,), dev, seed, 0.5, 1.0), _rand((C,), dev, seed + 1, 0.5)


def _close(got, want, atol, rtol, what=""):
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), what
    err = (got.double() - want.double()).abs()
    assert (err <= atol + rtol * want.double().abs()).all(), (what, err.max().item())


def _rel_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()


def _within(got, want, what=""):
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), what
    peak = (got.double() - want.double()).abs().max().item()
    assert _rel_l2(got, want) <= REL_L2, (what, _rel_l2(got, want))
    assert peak <= MAX_ABS * want.abs().max().item(), (what, peak)


def _zero_rows(x, rows):
    x = x.clone()
    x.view(-1, x.shape[-1])[rows] = 0
    return x


def _counts():
    return (tln.LAUNCHES_FP32, tln.LAUNCHES_BWD_FP32, tlnq.LAUNCHES_FP32, tlnm.LAUNCHES_FP32,
            tln.LAUNCHES, tln.LAUNCHES_BWD, tlnq.LAUNCHES, tlnm.LAUNCHES)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


# ---- B6 -----------------------------------------------------------------------

@pytest.mark.parametrize("C", tln.LN_WIDTHS)
# fewer rows than SMs (1, 7, 100), ragged (1003), the fused step's rows
@pytest.mark.parametrize("R", [1, 7, 100, 1003, 1408, 4672])
def test_layernorm_fp32_fwd_bwd_match_plain(dev, C, R):
    x = _zero_rows(_rand((R, C), dev, 0, 2.0, 0.3), [R - 1])  # the last row a pad row
    gamma, beta = _affine(C, dev)
    dy = _rand((R, C), dev, 3)
    before = _counts()
    with torch.no_grad():
        y, mean, rstd = tln.ln_forward(x, gamma, beta)
        dx, dgamma, dbeta = tln.ln_backward(x, dy, gamma, mean, rstd)
    torch.cuda.synchronize()
    assert _delta(before) == (1, 1, 0, 0, 0, 0, 0, 0)  # the fp32 kernels, counted apart
    y_p, mean_p, rstd_p = tln.ln_forward_f32(x, gamma, beta, 1e-6)
    _close(mean, mean_p, STAT_TOL, STAT_TOL, "mean")
    _close(rstd, rstd_p, 0.0, RSTD_RTOL, "rstd")
    _close(y, y_p, LN_TOL, LN_TOL, "y")
    assert torch.equal(y[-1], beta)  # a row of zeros gives beta
    dx_p, dg_p, db_p = tln.ln_backward_f32(x, dy, gamma, mean_p, rstd_p)
    _close(dx, dx_p, LN_TOL, LN_TOL, "dx")
    assert dx.dtype == torch.float32
    assert _rel_l2(dgamma, dg_p) <= PARAM_REL_L2 and _rel_l2(dbeta, db_p) <= PARAM_REL_L2


@pytest.mark.parametrize("C", tln.LN_WIDTHS)
def test_layernorm_fp32_two_pass_variance_survives_a_large_mean(dev, C):
    """mean 300, std 1: the one-pass E[x^2] - E[x]^2 would cancel 9e4 against
    9e4 + 1 in fp32; the kernels' two passes keep rstd and y against an fp64
    LayerNorm, and the statistics launch gives the forward's bits."""
    R = 777
    x = _rand((R, C), dev, 4, 1.0, 300.0)
    gamma, beta = _affine(C, dev)
    y, mean, rstd = tln.ln_forward(x, gamma, beta)
    mean_s, rstd_s = tln.ln_stats(x, gamma, beta)
    torch.cuda.synchronize()
    assert torch.equal(mean, mean_s) and torch.equal(rstd, rstd_s)
    xd = x.double()
    mean_d = xd.mean(-1, keepdim=True)
    rstd_d = torch.rsqrt(((xd - mean_d) ** 2).mean(-1, keepdim=True) + 1e-6)
    y_d = (xd - mean_d) * rstd_d * gamma.double() + beta.double()
    _close(rstd, rstd_d, 0.0, 1e-4, "rstd")
    _close(y, y_d, 1e-3, 0.0, "y")


@pytest.mark.parametrize("C", tln.LN_WIDTHS)
@pytest.mark.parametrize("R", [16384 + 37, 1408, 12992])
def test_layernorm_fp32_bwd_partials_are_deterministic(dev, C, R):
    x, dy = _rand((R, C), dev, 0), _rand((R, C), dev, 1)
    gamma, beta = _affine(C, dev)
    with torch.no_grad():
        _, mean, rstd = tln.ln_forward(x, gamma, beta)
        first = tln.ln_backward(x, dy, gamma, mean, rstd)
        for _ in range(3):
            again = tln.ln_backward(x, dy, gamma, mean, rstd)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_layernorm_fp32_lane_groups_match_the_plan(dev):
    """The fp32 kernels' compile-time lane groups are the ones
    `ln_row_plan(..., itemsize=4)` reports."""
    import ctypes

    from vjepa2_tpu_torch import _build

    _, fn = _build.function("vjepa2_layernorm_layout",
                            [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2)
    for C in tln.LN_WIDTHS:
        lanes, per_lane = ctypes.c_int(), ctypes.c_int()
        assert fn(C, 4, ctypes.byref(lanes), ctypes.byref(per_lane)) == 0
        assert (lanes.value, per_lane.value) == tln.ln_row_plan(100, C, 132, 4)[2:], C
    assert fn(1024, 8, ctypes.byref(lanes), ctypes.byref(per_lane)) != 0


# ---- B7 -----------------------------------------------------------------------

def _qkv_case(B, N, C, H, D, tables, dev, seed=0):
    x = _zero_rows(_rand((B, N, C), dev, seed, 1.5, 0.2), [N - 1, B * N - 2])
    gamma, beta = _affine(C, dev)
    w = _rand((3 * H * D, C), dev, seed + 2, C ** -0.5)
    bias = _rand((3 * H * D,), dev, seed + 3, 0.5)
    rope = None
    if tables != "none":
        pos = torch.arange(N, device=dev)
        if tables == "per_example":
            pos = torch.stack([torch.randperm(4 * N, generator=torch.Generator().manual_seed(i))[:N]
                               for i in range(B)]).sort(1).values.to(dev)
        rope, _ = expand_rope_cache(build_rope_cache(pos, D, 8, 8), D)
    return x, gamma, beta, w, bias, rope


def _check_qkv(x, gamma, beta, w, bias, rope, H, D):
    before = _counts()
    with torch.no_grad():
        got = tlnq.ln_qkv(x, gamma, beta, w, bias, rope, num_heads=H, head_dim=D)
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 1, 0, 0, 0, 0, 0)
    want = tlnq.ln_qkv_plain(x, gamma, beta, w, bias, rope, num_heads=H, head_dim=D)
    for name, g, p in zip("qkv", got, want):
        assert g.shape == (x.shape[0], H, x.shape[1], D)
        _within(g, p, name)


# every (D, heads a tile) of the fp32 plan: H = heads, and H where the plan
# takes the narrower tile (6 heads of 32: 2 a tile)
@pytest.mark.parametrize("D,H", [(32, 4), (32, 6), (64, 2), (80, 2), (88, 2)])
@pytest.mark.parametrize("tables", ["none", "shared", "per_example"])
# 2 x 37: ragged, one 128-row tile; 3 x 130: rows across tiles and examples
@pytest.mark.parametrize("B,N", [(2, 37), (3, 130)])
def test_ln_qkv_fp32_matches_plain(dev, D, H, tables, B, N):
    heads = tlnq.qkv_heads_per_tile(H, D, torch.float32)
    assert heads == {(32, 4): 4, (32, 6): 2, (64, 2): 2, (80, 2): 1, (88, 2): 1}[(D, H)]
    _check_qkv(*_qkv_case(B, N, 384, H, D, tables, dev), H, D)


@pytest.mark.parametrize("C,H,D", [(1024, 16, 64), (1280, 16, 80), (1408, 16, 88),
                                   (384, 12, 32), (1408, 22, 64)])
def test_ln_qkv_fp32_at_model_widths(dev, C, H, D):
    _check_qkv(*_qkv_case(2, 200, C, H, D, "per_example", dev, seed=4), H, D)


# the pretrain contexts' token counts (578 and 173 stack-padded to 8): a
# 128-row tile spans two examples; per-example tables
@pytest.mark.parametrize("B,N", [(3, 584), (4, 176)])
@pytest.mark.parametrize("C,H,D", [(1024, 16, 64), (384, 12, 32)])
def test_ln_qkv_fp32_rows_across_examples(dev, B, N, C, H, D):
    _check_qkv(*_qkv_case(B, N, C, H, D, "per_example", dev, seed=5), H, D)


@pytest.mark.parametrize("C,H,D", [(1024, 16, 64), (384, 12, 32)])
def test_ln_qkv_fp32_large_mean_rows(dev, C, H, D):
    """|mean| >> std rows (300 against 1) through B7, against the plain
    version: the two-pass statistics leave y, so q, k, v, within fp32's
    tolerances."""
    x, gamma, beta, w, bias, rope = _qkv_case(2, 130, C, H, D, "shared", dev, seed=6)
    _check_qkv(x + 300.0, gamma, beta, w, bias, rope, H, D)


# ---- B8 -----------------------------------------------------------------------

@pytest.mark.parametrize("C,hidden", [(384, 1536), (1024, 4096), (1280, 5120), (1408, 6144)])
@pytest.mark.parametrize("B,N", [(1, 1), (1, 37), (2, 37), (3, 130), (1, 1003)])
def test_ln_mlp_fp32_matches_plain(dev, C, hidden, B, N):
    x = _zero_rows(_rand((B, N, C), dev, 0, 1.5, -0.1), [B * N - 1])
    gamma, beta = _affine(C, dev)
    w = _rand((hidden, C), dev, 2, C ** -0.5)
    bias = _rand((hidden,), dev, 3, 0.5)
    before = _counts()
    with torch.no_grad():
        h = tlnm.ln_mlp(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 0, 1, 0, 0, 0, 0) and h.shape == (B, N, hidden)
    _within(h, tlnm.ln_mlp_plain(x, gamma, beta, w, bias), "h")


@pytest.mark.parametrize("C,hidden", [(384, 1536), (1408, 6144)])
def test_ln_mlp_fp32_is_deterministic(dev, C, hidden):
    x = _rand((2, 300, C), dev, 5, 1.5, 0.3)
    gamma, beta = _affine(C, dev)
    w = _rand((hidden, C), dev, 6, C ** -0.5)
    bias = _rand((hidden,), dev, 7, 0.5)
    with torch.no_grad():
        first = tlnm.ln_mlp(x, gamma, beta, w, bias)
        second = tlnm.ln_mlp(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fp32_prologues_copy_what_tma_cannot_read(dev):
    """x as a view at a 4-byte offset (TMA and the 16-byte loads need 16) and
    W as a strided view: the wrappers make W contiguous, the entry points
    refuse x (NOT_TMA_READY), the wrappers copy it (`tma_operand`), and each
    call launches once and matches."""
    C, hidden, H, D, R = 1024, 4096, 16, 64, 2 * 70
    flat = _rand((R * C + 8,), dev, 8, 1.5, -0.2)
    x = flat[1: 1 + R * C].view(2, 70, C)
    assert x.data_ptr() % 16 and not fa.tma_ready(x)
    gamma, beta = _affine(C, dev)
    w = _rand((C, hidden), dev, 9, C ** -0.5).t()
    assert not w.is_contiguous()
    bias = _rand((hidden,), dev, 10, 0.5)
    before = _counts()
    with torch.no_grad():
        h = tlnm.ln_mlp(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 0, 1, 0, 0, 0, 0)
    _within(h, tlnm.ln_mlp_plain(x, gamma, beta, w, bias), "h")
    _, gamma, beta, wq, bq, rope = _qkv_case(2, 70, C, H, D, "shared", dev, seed=11)
    _check_qkv(x, gamma, beta, wq, bq, rope, H, D)


def test_fp32_routes_refuse_other_dtypes(dev):
    C, H, D = 384, 2, 64
    x, gamma, beta, w, bias, _ = _qkv_case(1, 16, C, H, D, "none", dev)
    with pytest.raises(TypeError, match="bf16 or fp32 rows; got torch.float16"):
        tln.ln_forward(x.half(), gamma, beta)
    with pytest.raises(TypeError, match="both bf16 or both fp32; got torch.float16"):
        tlnq.ln_qkv(x.half(), gamma, beta, w.half(), bias, num_heads=H, head_dim=D)
    with pytest.raises(TypeError, match="both bf16 or both fp32; got torch.float32, "
                                        "torch.bfloat16"):
        tlnq.ln_qkv(x, gamma, beta, w.bfloat16(), bias, num_heads=H, head_dim=D)
    with pytest.raises(TypeError, match="both bf16 or both fp32; got torch.bfloat16, "
                                        "torch.float32"):
        tlnm.ln_mlp(x.bfloat16(), gamma, beta, _rand((1536, C), dev, 1), bias.new_zeros(1536))
    with pytest.raises(ValueError, match="must match x"):
        tln.ln_backward(x, x.bfloat16(), gamma, *tln.ln_stats(x, gamma, beta))


# ---- the fused block ------------------------------------------------------------

@pytest.mark.parametrize("dim,heads", [(384, 6), (384, 12)])  # Dh 64, 32
def test_fused_fp32_block_grad_mode(dev, dim, heads):
    """A fused block at fp32 (B7 + B3, B8; backward: the BHND backward and two
    B6 backwards, all fp32, no bf16 kernel) on the card against the same
    block in fp32 on the CPU (the plain versions)."""
    B, N, kv_valid = 2, 136, 131
    gen = torch.Generator().manual_seed(0)
    kw = dict(use_rope=True, use_flash=True, fuse_ln_qkv=True, fuse_ln_mlp=True)
    cpu = tm.Block(dim, heads, **kw)
    cpu.reset_parameters(gen)
    with torch.no_grad():  # a non-trivial LayerNorm affine
        for p in (cpu.norm1.weight, cpu.norm2.weight, cpu.norm1.bias, cpu.norm2.bias):
            p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    gpu = tm.Block(dim, heads, dtype=torch.float32, device=dev, **kw)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(B, N, dim).astype(np.float32))
    w = torch.from_numpy(rng.randn(B, N, dim).astype(np.float32))
    w[:, kv_valid:] = 0.0  # pad rows are sliced off: no cotangent
    Dh = dim // heads
    (cos, sin), perm = expand_rope_cache(build_rope_cache(torch.arange(N), Dh, 4, 4), Dh)
    perm = tm.qkv_row_perm(perm, heads, Dh)

    def counts():
        return _counts() + (fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32, fa.LAUNCHES, fa.LAUNCHES_BWD)

    results = []
    for block, device in ((gpu, dev), (cpu, torch.device("cpu"))):
        xi = x.to(device).requires_grad_()
        before = counts()
        y = block(xi, rope_expanded=(cos.to(device), sin.to(device)), qkv_perm=perm.to(device),
                  kv_valid=kv_valid)
        (y * w.to(device)).sum().backward()
        on = int(device.type == "cuda")
        # B6 fp32 fwd, bwd; B7, B8 fp32; every bf16 counter; B3, BHND bwd fp32; bf16 B3/B4
        assert tuple(a - b for a, b in zip(counts(), before)) == (
            0, 2 * on, on, on, 0, 0, 0, 0, on, on, 0, 0)
        results.append([xi.grad] + [p.grad for p in block.parameters()])
    for got, want in zip(*results):
        assert got.dtype == torch.float32
        assert _rel_l2(got.cpu(), want) <= BLOCK_REL_L2
