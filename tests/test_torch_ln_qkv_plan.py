"""B7's tile plan (`vjepa2_tpu_torch/ops/ln_qkv.py`), on the CPU: the heads a
column tile of its GEMM holds (`qkv_heads_per_tile`), which the kernel, B8's
wgmma/TMA mainloop with a RoPE epilogue, takes as given. Every (C, H, D) the
earlier mma.sync kernel took (H a multiple of 4 at D 32, of 2 otherwise) is
still taken, `vit_giant_xformers`' 22 heads of 64 among them; each column
tile is at most a wgmma's 256 columns, lies inside one of q, k, v and holds
whole heads, so every RoPE pair (d, d + D/2) lies in it. The kernel runs
only on the card (`test_torch_ln_cuda.py`)."""

import pytest
import torch

from vjepa2_tpu_torch.ops import ln_qkv
from vjepa2_tpu_torch.ops.layernorm import LN_WIDTHS

# (C, H, D) of the models that take the fused route: the pretrain predictor,
# ViT-L, ViT-H, the 16-head vit_giant, vit_giant_xformers, and the test
# shapes of `test_torch_ln_cuda.py`
MODEL_SHAPES = [(384, 12, 32), (1024, 16, 64), (1280, 16, 80), (1408, 16, 88), (1408, 22, 64),
                (384, 4, 32), (384, 8, 32), (384, 2, 64), (384, 2, 80), (384, 2, 88)]


def _earlier_rule(H, D):
    """The rule of the earlier kernel: a column tile of 4 heads at D 32, else 2."""
    return H % (4 if D == 32 else 2) == 0


@pytest.mark.parametrize("D", ln_qkv.QKV_HEAD_WIDTHS)
def test_plan_takes_every_head_count_the_earlier_kernel_took(D):
    for H in range(1, 65):
        heads = ln_qkv.qkv_heads_per_tile(H, D)
        if _earlier_rule(H, D):
            assert heads is not None, H
        if heads is not None:
            assert H % heads == 0 and heads * D <= 256 and heads in ln_qkv.QKV_TILE_HEADS[D], H


@pytest.mark.parametrize("C,H,D", MODEL_SHAPES)
def test_column_tiles_hold_whole_heads_of_one_part(C, H, D):
    assert C in LN_WIDTHS
    heads = ln_qkv.qkv_heads_per_tile(H, D)
    bn, part = heads * D, H * D
    assert bn % 16 == 0 and bn <= 256  # a wgmma width
    assert part % bn == 0  # q, k and v each take whole tiles
    for n0 in range(0, 3 * part, bn):
        assert n0 // part == (n0 + bn - 1) // part  # inside one of q, k, v
        assert (n0 % part) % D == 0  # starts at a head
        for d in range(D // 2):  # every RoPE pair of its heads lies in it
            for h in range(heads):
                assert n0 <= n0 + h * D + d + D // 2 < n0 + bn


def test_widest_tile_is_chosen():
    """The widest planned tile that divides H: 4 heads of 64 at ViT-L (256
    columns), 6 of 32 at the predictor, 2 of 64 at vit_giant_xformers' 22
    heads, 2 heads at D 80 and 88."""
    assert ln_qkv.qkv_heads_per_tile(16, 64) == 4
    assert ln_qkv.qkv_heads_per_tile(12, 32) == 6
    assert ln_qkv.qkv_heads_per_tile(8, 32) == 4
    assert ln_qkv.qkv_heads_per_tile(22, 64) == 2
    assert ln_qkv.qkv_heads_per_tile(16, 80) == 2
    assert ln_qkv.qkv_heads_per_tile(16, 88) == 2


@pytest.mark.parametrize("H,D", [(3, 64), (5, 80), (6, 32), (7, 88), (16, 48)])
def test_what_the_plan_refuses(H, D):
    """An odd head count at D 64-88, a count at D 32 that neither 6 nor 4
    divides, a width the kernel does not take: no tile."""
    assert ln_qkv.qkv_heads_per_tile(H, D) == (6 if (H, D) == (6, 32) else None)


def test_refused_shapes_raise_before_any_launch():
    """A head count the plan cannot tile raises on a CUDA tensor before the
    kernel is built; the CPU runs the plain version at any head count."""
    x = torch.zeros(1, 4, 384, dtype=torch.bfloat16)
    gamma, beta = torch.ones(384), torch.zeros(384)
    w, bias = torch.zeros(3 * 3 * 64, 384, dtype=torch.bfloat16), torch.zeros(3 * 3 * 64)
    q, k, v = ln_qkv.ln_qkv(x, gamma, beta, w, bias, num_heads=3, head_dim=64)
    assert q.shape == (1, 3, 4, 64)
    with pytest.raises(ValueError, match="3 heads"):
        ln_qkv._ln_qkv_cuda(x, gamma, beta, w, bias, None, None, 1e-6, 3, 64)
