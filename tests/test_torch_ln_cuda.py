"""The hand-written LayerNorm kernels (B6 `vjepa2_tpu_torch/csrc/layernorm.cu`,
`csrc/ln_common.cuh`) and the fused LayerNorm prologues (B7 and B8,
`csrc/ln_gemm_hopper.cu`, on wgmma and TMA) against their plain PyTorch
versions on the card, over the edges the model shapes do not reach: ragged
row counts (not multiples of a ring stage's rows or of the GEMM's 128-row
tiles), fewer rows than B6's persistent grid has blocks, and the fused
step's row counts; rows of zeros (the models' stack pad), which must give
beta and no NaN; B6's statistics launch against its forward; B6's backward
launching only its two kernels (no torch reduction of partials), and its
lane groups against `ln_row_plan`; shared against per-example RoPE tables,
at row counts that are not multiples of a 128-row tile (tiles across
examples); every width the kernels take (D 32, 64, 80, 88; C 384, 1024,
1280, 1408; hidden 1536, 4096, 5120, 6144), and B7 at every column tile of
its plan (vit_giant_xformers' 22 heads of 64 among them); shapes and dtypes
they refuse; B6's dgamma/dbeta (at every width, at the fused step's rows)
and B8's h equal from run to run; B8 at R = 1 and ragged R (37, 130, 1003:
part of a 128-row tile, tiles across examples, more tiles than a persistent
block's first) and on an x view TMA cannot read in place (copied, still
launched); and a grad-mode forward and backward through a fused `Block` on
the card against the same block in fp32 on the CPU.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_ln_cuda.py -q

Tolerances. The kernels run on bf16 inputs, the plain versions on the same
inputs in fp32 (their LayerNorm output rounded to the input dtype before the
product, as the kernels round it). mean within 1e-5 and rstd within 1e-4
relative (another summation order; `rsqrtf` is within 2 ulp). B6's y and dx
are bf16 roundings of the same fp32 value, so within 2**-7 relative plus
1e-3 (one bf16 step either side of a rounding boundary); dgamma/dbeta within
1e-4 relative L2 (fp32 sums in another order). B7 and B8: an output rounds
once to bf16 (2**-9), and y may round to the neighbouring bf16 value where
the statistics differ in the last bit, so 5e-3 + 1e-2 |plain|. The block: bf16
against fp32 through LayerNorm, two products and attention: 2e-2 relative
L2 per gradient, as the flash kernels' grad-mode tests.
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

STAT_ATOL, RSTD_RTOL = 1e-5, 1e-4
LN_ATOL, LN_RTOL = 1e-3, 2**-7
GEMM_ATOL, GEMM_RTOL = 5e-3, 1e-2
REL_L2 = 2e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dev, seed, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(np.float32)).to(dev, dtype)


def _affine(C, dev, seed=7):
    return (_rand((C,), dev, seed, 0.5, 1.0, torch.float32),
            _rand((C,), dev, seed + 1, 0.5, 0.0, torch.float32))


def _close(got, want, atol, rtol, what=""):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs()
    assert (err <= atol + rtol * want.abs()).all(), (what, err.max().item())


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def _zero_rows(x, rows):
    x = x.clone()
    x.view(-1, x.shape[-1])[rows] = 0
    return x


@pytest.mark.parametrize("C", tln.LN_WIDTHS)
# fewer rows than SMs (1, 7, 100), ragged (1003), the fused step's contexts
# and predictor (1408, 4672, 12992)
@pytest.mark.parametrize("R", [1, 7, 100, 1003, 1408, 4672, 12992])
def test_layernorm_fwd_bwd_match_plain(dev, C, R):
    x = _zero_rows(_rand((R, C), dev, 0, 2.0, 0.3), [R - 1])  # the last row a pad row
    gamma, beta = _affine(C, dev)
    dy = _rand((R, C), dev, 3)
    before = (tln.LAUNCHES, tln.LAUNCHES_BWD)
    with torch.no_grad():
        y, mean, rstd = tln.ln_forward(x, gamma, beta)
        dx, dgamma, dbeta = tln.ln_backward(x, dy, gamma, mean, rstd)
    torch.cuda.synchronize()
    assert (tln.LAUNCHES, tln.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    y_p, mean_p, rstd_p = tln.ln_forward_f32(x, gamma, beta, 1e-6)
    _close(mean, mean_p, STAT_ATOL, 1e-5, "mean")
    _close(rstd, rstd_p, 0.0, RSTD_RTOL, "rstd")
    _close(y, y_p, LN_ATOL, LN_RTOL, "y")
    assert torch.equal(y[-1], beta.to(torch.bfloat16))  # a row of zeros gives beta
    dx_p, dg_p, db_p = tln.ln_backward_f32(x, dy.float(), gamma, mean_p, rstd_p)
    _close(dx, dx_p, LN_ATOL, LN_RTOL, "dx")
    assert _rel_l2(dgamma, dg_p) <= 1e-4 and _rel_l2(dbeta, db_p) <= 1e-4


@pytest.mark.parametrize("C", tln.LN_WIDTHS)
@pytest.mark.parametrize("R", [16384 + 37, 1408, 4672, 12992])
def test_layernorm_bwd_partials_are_deterministic(dev, C, R):
    x, dy = _rand((R, C), dev, 0), _rand((R, C), dev, 1)
    gamma, beta = _affine(C, dev)
    with torch.no_grad():
        _, mean, rstd = tln.ln_forward(x, gamma, beta)
        first = tln.ln_backward(x, dy, gamma, mean, rstd)
        for _ in range(3):
            again = tln.ln_backward(x, dy, gamma, mean, rstd)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("C", tln.LN_WIDTHS)
def test_layernorm_statistics_launch_matches_forward(dev, C):
    """`ln_stats`, the forward kernel writing no output (B7's and B8's first
    launch), gives the forward's mean and rstd bit for bit."""
    x = _rand((4672, C), dev, 2, 2.0, 0.3)
    gamma, beta = _affine(C, dev)
    _, mean, rstd = tln.ln_forward(x, gamma, beta)
    mean_s, rstd_s = tln.ln_stats(x, gamma, beta)
    assert torch.equal(mean, mean_s) and torch.equal(rstd, rstd_s)


def test_layernorm_backward_runs_only_the_ports_kernels(dev):
    """One `ln_backward` call on the card launches B6's backward and its
    partial-row sum and nothing else: no torch reduction (`reduce_kernel`)
    sums the partials."""
    from torch.profiler import ProfilerActivity, profile

    R, C = 4672, 1024
    x, dy = _rand((R, C), dev, 0), _rand((R, C), dev, 1)
    gamma, beta = _affine(C, dev)
    _, mean, rstd = tln.ln_forward(x, gamma, beta)
    tln.ln_backward(x, dy, gamma, mean, rstd)  # built and warm
    torch.cuda.synchronize()
    for _ in range(5):  # a profiler session now and then records no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tln.ln_backward(x, dy, gamma, mean, rstd)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages() if e.device_time_total > 0]
        if kernels:
            break
    assert not [k for k in kernels if "reduce_kernel" in k], kernels
    assert sorted(k.split("<")[0].split("::")[-1] for k in kernels) == [
        "ln_bwd_kernel", "ln_bwd_sum_kernel"], kernels


def test_layernorm_lane_groups_match_the_plan(dev):
    """The kernels' compile-time lane groups are the ones `ln_row_plan`
    reports (and `tests/test_torch_layernorm_plan.py` checks)."""
    import ctypes

    from vjepa2_tpu_torch import _build

    _, fn = _build.function("vjepa2_layernorm_layout",
                            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2)
    for C in tln.LN_WIDTHS:
        lanes, per_lane = ctypes.c_int(), ctypes.c_int()
        assert fn(C, ctypes.byref(lanes), ctypes.byref(per_lane)) == 0
        plan = tln.ln_row_plan(100, C, 132)
        assert (lanes.value, per_lane.value) == (plan.lanes, plan.per_lane), C


def test_layer_norm_autograd_on_the_card(dev):
    C = 1024
    x = _rand((2, 40, C), dev, 0).requires_grad_()
    gamma, beta = (t.requires_grad_() for t in _affine(C, dev))
    w = _rand((2, 40, C), dev, 5, dtype=torch.float32)
    (tln.layer_norm(x, gamma, beta).float() * w).sum().backward()
    xc, gc, bc = (t.detach().cpu().float().requires_grad_() for t in (x, gamma, beta))
    (tln.layer_norm(xc, gc, bc) * w.cpu()).sum().backward()
    for got, want in ((x.grad, xc.grad), (gamma.grad, gc.grad), (beta.grad, bc.grad)):
        assert _rel_l2(got.cpu(), want) <= REL_L2


def _qkv_case(B, N, C, H, D, tables, dev, seed=0):
    x = _zero_rows(_rand((B, N, C), dev, seed, 1.5, 0.2), [N - 1, B * N - 2])
    gamma, beta = _affine(C, dev)
    w = _rand((3 * H * D, C), dev, seed + 2, C ** -0.5)
    bias = _rand((3 * H * D,), dev, seed + 3, 0.5, dtype=torch.float32)
    rope = None
    if tables != "none":
        pos = torch.arange(N, device=dev)
        if tables == "per_example":
            pos = torch.stack([torch.randperm(4 * N, generator=torch.Generator().manual_seed(i))[:N]
                               for i in range(B)]).sort(1).values.to(dev)
        rope, _ = expand_rope_cache(build_rope_cache(pos, D, 8, 8), D)
    return x, gamma, beta, w, bias, rope


def _check_qkv(x, gamma, beta, w, bias, rope, H, D):
    before = tlnq.LAUNCHES
    with torch.no_grad():
        got = tlnq.ln_qkv(x, gamma, beta, w, bias, rope, num_heads=H, head_dim=D)
    torch.cuda.synchronize()
    assert tlnq.LAUNCHES == before + 1
    want = tlnq.ln_qkv_plain(x, gamma, beta, w, bias, rope, num_heads=H, head_dim=D)
    for name, g, p in zip("qkv", got, want):
        assert g.shape == (x.shape[0], H, x.shape[1], D) and g.dtype == torch.bfloat16
        _close(g, p, GEMM_ATOL, GEMM_RTOL, name)


@pytest.mark.parametrize("D,H", [(32, 4), (64, 2), (80, 2), (88, 2)])
@pytest.mark.parametrize("tables", ["none", "shared", "per_example"])
# 2 x 37: ragged, one 128-row tile; 3 x 130: rows across tiles and examples
@pytest.mark.parametrize("B,N", [(2, 37), (3, 130)])
def test_ln_qkv_matches_plain(dev, D, H, tables, B, N):
    _check_qkv(*_qkv_case(B, N, 384, H, D, tables, dev), H, D)


@pytest.mark.parametrize("C,H,D", [(1024, 16, 64), (1280, 16, 80), (1408, 16, 88),
                                   (384, 12, 32), (1408, 22, 64)])
def test_ln_qkv_at_model_widths(dev, C, H, D):
    _check_qkv(*_qkv_case(2, 200, C, H, D, "per_example", dev, seed=4), H, D)


# the pretrain contexts' token counts (578 and 173 stack-padded to 8): a
# 128-row tile spans two examples; per-example tables
@pytest.mark.parametrize("B,N", [(3, 584), (4, 176)])
@pytest.mark.parametrize("C,H,D", [(1024, 16, 64), (1408, 16, 88), (384, 8, 32)])
def test_ln_qkv_rows_across_examples(dev, B, N, C, H, D):
    _check_qkv(*_qkv_case(B, N, C, H, D, "per_example", dev, seed=5), H, D)


@pytest.mark.parametrize("C,hidden", [(384, 1536), (1024, 4096), (1280, 5120), (1408, 6144)])
@pytest.mark.parametrize("B,N", [(1, 1), (1, 37), (1, 130), (2, 37), (3, 130), (1, 1003)])
def test_ln_mlp_matches_plain(dev, C, hidden, B, N):
    x = _zero_rows(_rand((B, N, C), dev, 0, 1.5, -0.1), [B * N - 1])
    gamma, beta = _affine(C, dev)
    w = _rand((hidden, C), dev, 2, C ** -0.5)
    bias = _rand((hidden,), dev, 3, 0.5, dtype=torch.float32)
    before = tlnm.LAUNCHES
    with torch.no_grad():
        h = tlnm.ln_mlp(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    assert tlnm.LAUNCHES == before + 1 and h.shape == (B, N, hidden)
    _close(h, tlnm.ln_mlp_plain(x, gamma, beta, w, bias), GEMM_ATOL, GEMM_RTOL, "h")


@pytest.mark.parametrize("C,hidden", [(384, 1536), (1408, 6144)])
def test_ln_mlp_is_deterministic(dev, C, hidden):
    """Two calls give equal bits (each output is one tile's fp32 sum)."""
    x = _rand((2, 300, C), dev, 5, 1.5, 0.3)
    gamma, beta = _affine(C, dev)
    w = _rand((hidden, C), dev, 6, C ** -0.5)
    bias = _rand((hidden,), dev, 7, 0.5, dtype=torch.float32)
    with torch.no_grad():
        first = tlnm.ln_mlp(x, gamma, beta, w, bias)
        second = tlnm.ln_mlp(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_ln_mlp_copies_what_tma_cannot_read(dev):
    """x as a view with an unaligned base and w as a strided view: the
    wrapper makes w contiguous, the entry point refuses x (NOT_TMA_READY),
    the wrapper copies it (`tma_operand`), and the call launches and
    matches."""
    C, hidden, R = 1024, 4096, 2 * 70
    flat = _rand((R * C + 8,), dev, 8, 1.5, -0.2)
    x = flat[3: 3 + R * C].view(2, 70, C)
    assert x.data_ptr() % 16 and not fa.tma_ready(x)
    gamma, beta = _affine(C, dev)
    w = _rand((C, hidden), dev, 9, C ** -0.5).t()
    assert not w.is_contiguous()
    bias = _rand((hidden,), dev, 10, 0.5, dtype=torch.float32)
    before = tlnm.LAUNCHES
    with torch.no_grad():
        h = tlnm.ln_mlp(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    assert tlnm.LAUNCHES == before + 1
    _close(h, tlnm.ln_mlp_plain(x, gamma, beta, w, bias), GEMM_ATOL, GEMM_RTOL, "h")


def test_unsupported_shapes_and_dtypes_raise(dev):
    x, gamma, beta, w, bias, _ = _qkv_case(1, 16, 384, 2, 64, "none", dev)
    with pytest.raises(ValueError, match="row width"):
        tln.ln_forward(_rand((4, 512), dev, 0), *_affine(512, dev))
    with pytest.raises(TypeError, match="bf16"):
        tln.ln_forward(x.float(), gamma, beta)
    with pytest.raises(ValueError, match="head width 48"):
        tlnq.ln_qkv(x, gamma, beta, w[: 3 * 2 * 48], bias[: 3 * 2 * 48], num_heads=2,
                    head_dim=48)
    with pytest.raises(ValueError, match="3 heads"):
        tlnq.ln_qkv(x, gamma, beta, _rand((3 * 3 * 64, 384), dev, 1), bias.new_zeros(576),
                    num_heads=3, head_dim=64)
    with pytest.raises(TypeError, match="bf16"):
        tlnq.ln_qkv(x, gamma, beta, w.float(), bias, num_heads=2, head_dim=64)
    with pytest.raises(ValueError, match="hidden 2048"):
        tlnm.ln_mlp(x, gamma, beta, _rand((2048, 384), dev, 1), bias.new_zeros(2048))


@pytest.mark.parametrize("dim,heads", [(384, 6), (384, 12)])  # Dh 64, 32
def test_fused_block_grad_mode(dev, dim, heads):
    """A fused block (B7 + B3, B8; backward: the BHND backward and two B6
    backwards) in bf16 on the card against the same block in fp32 on the CPU
    (the plain versions): the launch counters show the kernels ran, and the
    input and every parameter gradient agree."""
    B, N, kv_valid = 2, 136, 131
    gen = torch.Generator().manual_seed(0)
    kw = dict(use_rope=True, use_flash=True, fuse_ln_qkv=True, fuse_ln_mlp=True)
    cpu = tm.Block(dim, heads, **kw)
    cpu.reset_parameters(gen)
    with torch.no_grad():  # a non-trivial LayerNorm affine
        for p in (cpu.norm1.weight, cpu.norm2.weight, cpu.norm1.bias, cpu.norm2.bias):
            p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    gpu = tm.Block(dim, heads, dtype=torch.bfloat16, device=dev, **kw)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(B, N, dim).astype(np.float32))
    w = torch.from_numpy(rng.randn(B, N, dim).astype(np.float32))
    w[:, kv_valid:] = 0.0  # pad rows are sliced off: no cotangent
    Dh = dim // heads
    (cos, sin), perm = expand_rope_cache(build_rope_cache(torch.arange(N), Dh, 4, 4), Dh)
    perm = tm.qkv_row_perm(perm, heads, Dh)

    def counts():
        return (tlnq.LAUNCHES, tlnm.LAUNCHES, fa.LAUNCHES, fa.LAUNCHES_BWD, tln.LAUNCHES_BWD)

    results = []
    for block, device in ((gpu, dev), (cpu, torch.device("cpu"))):
        xi = x.to(device, block.norm1.dtype).requires_grad_()
        before = counts()
        y = block(xi, rope_expanded=(cos.to(device), sin.to(device)), qkv_perm=perm.to(device),
                  kv_valid=kv_valid)
        (y.float() * w.to(device)).sum().backward()
        on_card = int(device.type == "cuda")
        assert tuple(a - b for a, b in zip(counts(), before)) == (on_card,) * 4 + (2 * on_card,)
        results.append([xi.grad] + [p.grad for p in block.parameters()])
    for got, want in zip(*results):
        assert _rel_l2(got.float().cpu(), want) <= REL_L2
