"""B6, B7 and B8 on fp32 operands (`vjepa2_tpu_torch/csrc/layernorm.cu`,
`csrc/ln_gemm_fp32.cu`) on the CPU, where the kernels cannot run: their
arithmetic, their plans and the fused fp32 route around them.

* B7's and B8's 3xTF32 products, emulated in torch: y = LN(x) in fp32 (not
  rounded), y and W each split into tf32 hi and lo, rounded to nearest with
  ties away from zero as `cvt.rna` does (`test_torch_flash_fp32_split.tf32`),
  and y_lo W_hi + y_hi W_lo + y_hi W_hi summed in fp32, then the bias, and
  RoPE (B7) or the exact GELU (B8) in fp32. Held against JAX's `ln_qkv` /
  `ln_mlp` at fp32 in interpret mode (the Pallas kernels) and against the
  port's plain versions, at the fp32 kernels' tolerances: 2e-5 relative L2
  and 1e-4 x max|reference| (`chip_smoke.py` holds the kernels to the plain
  versions at the same). One TF32 product (y_hi W_hi) misses both: its
  operands keep 11 bits, ~3e-4 relative.
* B6's fp32 row plan (`ln_row_plan(..., itemsize=4)`): the lane groups (16
  x 6, 32 x 8, 32 x 10, 32 x 11 chunks of 4 elements), the grid the same as
  bf16's, and every block's shared memory (`ln_block_bytes`) small enough
  for two an SM at both dtypes, which `LN_BLOCKS_PER_SM` assumes.
* B7's fp32 tile plan (`qkv_heads_per_tile(..., torch.float32)`): tiles of
  at most 128 columns holding whole heads of one of q, k, v, so that every
  RoPE pair lies in one tile, at the models' head counts.
* The wrappers' refusals, raised before any build: fp16, and x and W of
  different dtypes.
* The fused route at fp32 on the CPU: a fused `Block` forward and backward
  makes no bf16 tensor, sends B7's q, k, v in fp32 to the BHND attention at
  heads of 64 and 32, and its LayerNorm backward gets dy in fp32; an
  `ACBlock` with ``fuse_ln_mlp`` reaches B8 at fp32. (The fused fp32 Block,
  encoder, predictor and train step against JAX's with both fusions on are
  `tests/test_torch_fused_step.py`: the CPU path is fp32 there.)

Needs no GPU. JAX on the CPU, interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_fp32_split import split, tf32
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from vjepa2_tpu.ops import ln_mlp as jlnm
from vjepa2_tpu.ops import ln_qkv as jlnq
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops import layernorm as tln
from vjepa2_tpu_torch.ops import ln_mlp as tlnm
from vjepa2_tpu_torch.ops import ln_qkv as tlnq
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache, rope_rotate

B, N = 2, 40
REL_L2, MAX_ABS = 2e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (6 pytest workers share
    the host; see `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def product(a, w, parts: int = 3):
    """a @ w^T as the fp32 kernels take it: lo·hi + hi·lo + hi·hi of the tf32
    parts in fp32 (3), or hi·hi alone (1)."""
    (ah, al), (wh, wl) = split(a), split(w)
    if parts == 1:
        return ah @ wh.t()
    return al @ wh.t() + ah @ wl.t() + ah @ wh.t()


def emulated_ln_qkv(x, gamma, beta, w, bias, rope, H, D, parts=3):
    """B7 at fp32: LN in fp32 (`ln_forward_f32`, the kernel's formula), the
    product, the bias, then the split-half rotation of q and k in fp32."""
    y = tln.ln_forward_f32(x, gamma, beta, 1e-6)[0]
    q, k, v = tlnq._split_heads(product(y, w, parts) + bias, H, D)
    if rope is not None:
        cos, sin = (t[:, None] for t in rope)
        q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
    return q, k, v


def emulated_ln_mlp(x, gamma, beta, w, bias, parts=3):
    """B8 at fp32: LN, the product, the bias, the exact GELU, all fp32."""
    y = tln.ln_forward_f32(x, gamma, beta, 1e-6)[0]
    return tlnm.gelu_exact(product(y, w, parts) + bias)


def _errors(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            np.abs(got - want).max() / np.abs(want).max())


def _within(got, want) -> bool:
    rel, peak = _errors(got, want)
    return rel <= REL_L2 and peak <= MAX_ABS


def _qkv_inputs(C, H, D, rope, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, C) * 1.5 + 0.3).astype(np.float32)
    x[:, -1] = 0.0  # a stack-pad row
    gamma = (rng.randn(C) * 0.5 + 1).astype(np.float32)
    beta = (rng.randn(C) * 0.5).astype(np.float32)
    w = (rng.randn(3 * H * D, C) / np.sqrt(C)).astype(np.float32)
    bias = (rng.randn(3 * H * D) * 0.5).astype(np.float32)
    tables = None
    if rope != "none":
        pos = torch.arange(N) if rope == "shared" else torch.from_numpy(
            np.stack([np.sort(rng.permutation(4 * N)[:N]) for _ in range(B)]))
        tables, _ = expand_rope_cache(build_rope_cache(pos, D, 4, 4), D)
    return [torch.from_numpy(a) for a in (x, gamma, beta, w, bias)], tables


# (C, H, D, RoPE): the pretrain predictor's heads (32) and ViT-L's (64) at
# narrow widths, tables shared and per example, and none
QKV_JAX_CASES = [(128, 4, 32, "per_example"), (128, 2, 64, "shared"), (256, 4, 64, "none"),
                 (256, 8, 32, "shared")]


@pytest.mark.parametrize("C,H,D,rope", QKV_JAX_CASES)
def test_3xtf32_ln_qkv_holds_jax_and_plain_and_1xtf32_does_not(C, H, D, rope):
    (x, gamma, beta, w, bias), tables = _qkv_inputs(C, H, D, rope)
    j_rope = None if tables is None else tuple(jnp.asarray(t.numpy()) for t in tables)
    want_j = jlnq.ln_qkv(*(jnp.asarray(a.numpy()) for a in (x, gamma, beta, w.t(), bias)),
                         rope=j_rope, num_heads=H, head_dim=D, interpret=True)
    plain = tlnq.ln_qkv_plain(x, gamma, beta, w, bias, tables, num_heads=H, head_dim=D)
    three = emulated_ln_qkv(x, gamma, beta, w, bias, tables, H, D)
    one = emulated_ln_qkv(x, gamma, beta, w, bias, tables, H, D, parts=1)
    for name, t3, t1, p, j in zip("qkv", three, one, plain, want_j):
        assert _within(t3, np.asarray(j)), (name, _errors(t3, np.asarray(j)))
        assert _within(t3, p), (name, _errors(t3, p))
        assert not _within(t1, p), (name, _errors(t1, p))


@pytest.mark.parametrize("D,H", [(80, 2), (88, 2)])
def test_3xtf32_ln_qkv_at_the_wide_heads(D, H):
    """ViT-H's and the 16-head ViT-g's head widths (the fp32 kernel's D 80 and
    88 tiles, one head each; at D 88 a RoPE pair's partner is in another
    lane) against the plain version; 1xTF32 misses."""
    (x, gamma, beta, w, bias), tables = _qkv_inputs(128, H, D, "per_example", seed=3)
    plain = tlnq.ln_qkv_plain(x, gamma, beta, w, bias, tables, num_heads=H, head_dim=D)
    three = emulated_ln_qkv(x, gamma, beta, w, bias, tables, H, D)
    one = emulated_ln_qkv(x, gamma, beta, w, bias, tables, H, D, parts=1)
    for t3, t1, p in zip(three, one, plain):
        assert _within(t3, p) and not _within(t1, p), (_errors(t3, p), _errors(t1, p))


@pytest.mark.parametrize("C,hidden", [(128, 256), (256, 512), (384, 1536)])
def test_3xtf32_ln_mlp_holds_jax_and_plain_and_1xtf32_does_not(C, hidden):
    rng = np.random.RandomState(1)
    x = (rng.randn(B, N, C) * 1.5 - 0.2).astype(np.float32)
    x[:, -1] = 0.0
    gamma = (rng.randn(C) * 0.5 + 1).astype(np.float32)
    beta = (rng.randn(C) * 0.5).astype(np.float32)
    w = (rng.randn(hidden, C) / np.sqrt(C)).astype(np.float32)
    bias = (rng.randn(hidden) * 0.5).astype(np.float32)
    want_j = np.asarray(jlnm.ln_mlp(*(jnp.asarray(a) for a in (x, gamma, beta, w.T, bias)),
                                    block_h=min(hidden, 512), interpret=True))
    args = [torch.from_numpy(a) for a in (x, gamma, beta, w, bias)]
    plain = tlnm.ln_mlp_plain(*args)
    three, one = emulated_ln_mlp(*args), emulated_ln_mlp(*args, parts=1)
    assert _within(three, want_j), _errors(three, want_j)
    assert _within(three, plain), _errors(three, plain)
    assert not _within(one, plain), _errors(one, plain)


def test_tf32_rounds_to_nearest_ties_away_and_the_split_holds_fp32():
    """The emulation's rounding is `cvt.rna`'s: 1 + 2^-11 (a tie) rounds up to
    1 + 2^-10, -(1 + 2^-11) to -(1 + 2^-10), 1 + 2^-12 down to 1; hi + lo
    holds x to 2^-22 relative."""
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0]
    v = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0**-22).all()


# ---- B6's fp32 row plan --------------------------------------------------------

@pytest.mark.parametrize("C", tln.LN_WIDTHS)
def test_fp32_lane_groups_hold_twice_the_chunks_on_the_same_lanes(C):
    """An fp32 chunk of 16 bytes holds 4 elements: C / 4 chunks on bf16's
    lanes, 384 as 16 x 6, 1024 as 32 x 8, 1280 as 32 x 10 and 1408 as 32 x 11
    (352 chunks: unlike bf16's 176, no lane idle)."""
    plan = tln.ln_row_plan(1003, C, 132, 4)
    lanes, per_lane = {384: (16, 6), 1024: (32, 8), 1280: (32, 10), 1408: (32, 11)}[C]
    assert (plan.lanes, plan.per_lane) == (lanes, per_lane)
    assert lanes * per_lane == C // 4
    assert tln.ln_row_plan(1003, C, 132, 2).per_lane == -(-(C // 8) // lanes)


@pytest.mark.parametrize("R", [1, 1003, 1408, 4672, 12992, 16384])
@pytest.mark.parametrize("C", tln.LN_WIDTHS)
def test_fp32_grid_is_the_bf16_grid(C, R):
    for sms in (1, 114, 132):
        f32, b16 = tln.ln_row_plan(R, C, sms, 4), tln.ln_row_plan(R, C, sms, 2)
        assert f32[:3] == b16[:3]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("C", tln.LN_WIDTHS)
def test_two_blocks_of_either_dtype_fit_an_sm(C, itemsize):
    """The forward's and the backward's blocks, as `csrc/layernorm.cu` lays
    them out: at most 108.1 KB (the fp32 backward at 1024: three 32 KB
    stages, gamma and the staged statistics), so `LN_BLOCKS_PER_SM` = 2
    holds; an fp32 ring holds fewer, larger stages."""
    for backward in (False, True):
        size = tln.ln_block_bytes(C, itemsize, backward)
        assert tln.LN_BLOCKS_PER_SM * (size + tln.BLOCK_RESERVED_BYTES) <= tln.SM_SHARED_BYTES
        assert size <= 110720
    assert tln.ln_block_bytes(1024, 4, True) == 110720
    assert tln.ln_block_bytes(1408, 4, True) == tln.ln_block_bytes(1408, 2, True)


def test_fp32_plan_refuses_other_element_sizes():
    with pytest.raises(ValueError, match="bf16 and fp32"):
        tln.ln_row_plan(100, 1024, 132, 1)


# ---- B7's fp32 tile plan --------------------------------------------------------

# (C, H, D): the pretrain predictor, ViT-L, ViT-H, the 16-head vit_giant,
# vit_giant_xformers, and the CUDA tests' narrow shapes
FP32_MODEL_SHAPES = [(384, 12, 32), (1024, 16, 64), (1280, 16, 80), (1408, 16, 88),
                     (1408, 22, 64), (384, 4, 32), (384, 2, 32), (384, 6, 32), (384, 2, 64),
                     (384, 2, 80), (384, 2, 88)]


@pytest.mark.parametrize("C,H,D", FP32_MODEL_SHAPES)
def test_fp32_column_tiles_hold_whole_heads_of_one_part(C, H, D):
    heads = tlnq.qkv_heads_per_tile(H, D, torch.float32)
    assert heads in tlnq.QKV_TILE_HEADS_FP32[D] and H % heads == 0
    bn, part = heads * D, H * D
    assert bn % 8 == 0 and bn <= 128  # a tf32 wgmma width of the fp32 mainloop
    for n0 in range(0, 3 * part, bn):
        assert n0 // part == (n0 + bn - 1) // part  # inside one of q, k, v
        assert (n0 % part) % D == 0  # starts at a head
        for d in range(D // 2):  # every RoPE pair of its heads lies in it
            for h in range(heads):
                assert n0 <= n0 + h * D + d + D // 2 < n0 + bn


def test_fp32_tiles_are_the_widest_that_fit():
    """Two heads of 64 at ViT-L (128 columns), four of 32 at the predictor,
    one head at D 80 and 88; every head count the bf16 plan takes is taken
    at fp32 (and any at D 80 and 88), an odd one at D 64 refused as in bf16."""
    pick = {(16, 64): 2, (12, 32): 4, (6, 32): 2, (16, 80): 1, (16, 88): 1, (3, 80): 1,
            (22, 64): 2, (3, 64): None}
    for (H, D), heads in pick.items():
        assert tlnq.qkv_heads_per_tile(H, D, torch.float32) == heads
    for D in tlnq.QKV_HEAD_WIDTHS:
        for H in range(1, 65):
            if tlnq.qkv_heads_per_tile(H, D) is not None:
                assert tlnq.qkv_heads_per_tile(H, D, torch.float32) is not None, (H, D)
    assert tlnq.qkv_heads_per_tile(16, 64) == 4  # bf16's plan is unchanged


# ---- refusals ----------------------------------------------------------------

def test_wrappers_refuse_other_dtypes_before_any_build():
    """The CUDA routes check dtypes first (on any tensor: nothing is built or
    launched): fp16 rows, and x and W of different dtypes, with a message
    that says what is taken."""
    C, H, D = 384, 2, 64
    x16 = torch.zeros(1, 8, C, dtype=torch.float16)
    x32 = torch.zeros(1, 8, C)
    g, b = torch.ones(C), torch.zeros(C)
    w32, bias = torch.zeros(3 * H * D, C), torch.zeros(3 * H * D)
    with pytest.raises(TypeError, match="bf16 or fp32 rows; got torch.float16"):
        tln._ln_fwd_cuda(x16, g, b, 1e-6)
    with pytest.raises(TypeError, match="both bf16 or both fp32"):
        tlnq._ln_qkv_cuda(x16, g, b, w32.half(), bias, None, None, 1e-6, H, D)
    with pytest.raises(TypeError, match="both bf16 or both fp32; got torch.float32, "
                                        "torch.bfloat16"):
        tlnq._ln_qkv_cuda(x32, g, b, w32.bfloat16(), bias, None, None, 1e-6, H, D)
    with pytest.raises(TypeError, match="both bf16 or both fp32; got torch.bfloat16, "
                                        "torch.float32"):
        tlnm._ln_mlp_cuda(x32.bfloat16(), g, b, torch.zeros(1536, C), torch.zeros(1536), 1e-6)
    with pytest.raises(ValueError, match=r"head width 48 .* \(a multiple of one of \(\)\)"):
        tlnq._ln_qkv_cuda(x32, g, b, torch.zeros(3 * 3 * 48, C), torch.zeros(3 * 3 * 48),
                          None, None, 1e-6, 3, 48)


# ---- the fused route at fp32 -----------------------------------------------------

class _Dtypes(TorchDispatchMode):
    """The dtypes of every tensor the dispatched ops make."""

    def __init__(self):
        super().__init__()
        self.made = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.made.update(t.dtype for t in _pytree.tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((name, *(a.dtype for a in args if isinstance(a, torch.Tensor))))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("dim,heads", [(128, 2), (128, 4)])  # heads of 64 (encoder), 32 (predictor)
def test_fused_fp32_block_makes_no_bf16_and_attends_on_bhnd(monkeypatch, dim, heads):
    calls = []
    _spy(monkeypatch, tm, "attend_bhnd", calls)
    _spy(monkeypatch, tm, "attend_bhdn", calls)
    for name in ("ln_backward",):
        _spy(monkeypatch, tlnq, name, calls)
        _spy(monkeypatch, tlnm, name, calls)
    Dh = dim // heads
    blk = tm.Block(dim, heads, use_rope=True, use_flash=True, fuse_ln_qkv=True, fuse_ln_mlp=True)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    (cos, sin), perm = expand_rope_cache(build_rope_cache(torch.arange(24), Dh, 4, 4), Dh)
    x = torch.randn(2, 24, dim, generator=torch.Generator().manual_seed(1), requires_grad=True)
    with _Dtypes() as watch:
        y = blk(x, rope_expanded=(cos, sin), qkv_perm=tm.qkv_row_perm(perm, heads, Dh),
                kv_valid=21)
        y.square().sum().backward()
    assert torch.bfloat16 not in watch.made and torch.float32 in watch.made
    attend = [c for c in calls if c[0].startswith("attend")]
    assert attend == [("attend_bhnd",) + (torch.float32,) * 3]  # q, k, v fp32, Dh `Dh`
    assert sorted(c for c in calls if c[0] == "ln_backward") == [
        ("ln_backward",) + (torch.float32,) * 5] * 2  # x, dy, gamma, mean, rstd: fp32
    assert all(torch.isfinite(p.grad).all() for p in blk.parameters())


def test_fused_fp32_ac_block_reaches_b8_at_fp32(monkeypatch):
    calls = []
    _spy(monkeypatch, tm, "ln_mlp", calls)
    blk = tm.ACBlock(128, 2, grid_size=4, fuse_ln_mlp=True)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    T, hp, wp, cond = 2, 2, 2, 2
    x = torch.randn(1, T * (cond + hp * wp), 128, generator=torch.Generator().manual_seed(2))
    with _Dtypes() as watch:
        y = blk(x, T, hp, wp, cond)
    assert calls == [("ln_mlp",) + (torch.float32,) * 5] and y.dtype == torch.float32
    assert torch.bfloat16 not in watch.made
