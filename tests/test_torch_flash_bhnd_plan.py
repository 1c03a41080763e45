"""The pure-Python planning around the BHND Hopper kernels
(`vjepa2_tpu_torch/ops/flash_attention.py`), on the CPU: which operands TMA
may read in place (`tma_ready`, `tma_operand`; the C entry points check the
same rule and refuse the rest, and the wrapper then copies them), and the
backward's scratch layout (`bwd_scratch`, `padded_queries`). The kernels
themselves run only on the card (`test_torch_flash_bhnd_cuda.py`)."""

import pytest
import torch

from vjepa2_tpu_torch.ops import flash_attention as fa


def _qkv_views(B, N, H, D):
    """q, k, v as the model makes them: [B, H, N, D] views of one
    [B, N, 3, H, D] projection output."""
    qkv = torch.zeros(B, N, 3, H, D, dtype=torch.bfloat16)
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("D", [32, 64, 80, 88, 104])
def test_qkv_views_are_read_in_place(D):
    """Every supported head width keeps the qkv views 16-byte aligned (head
    offsets of 64-208 bytes), so TMA reads them without a copy."""
    for t in _qkv_views(2, 136, 4, D):
        assert fa.tma_ready(t)
        assert fa.tma_operand(t) is t


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_unaligned_base_is_copied(offset):
    """A view whose base is not 16-byte aligned is copied to a fresh
    contiguous tensor with the same values."""
    B, H, N, D = 1, 2, 40, 32
    flat = torch.arange(8 + B * H * N * D, dtype=torch.float32).to(torch.bfloat16)
    t = flat[offset: offset + B * H * N * D].view(B, H, N, D)
    assert t.data_ptr() % 16 and not fa.tma_ready(t)
    c = fa.tma_operand(t)
    assert c is not t and c.is_contiguous() and c.data_ptr() % 16 == 0 and torch.equal(c, t)


@pytest.mark.parametrize("case", ["d_stride", "odd_token_stride", "broadcast"])
def test_strides_tma_cannot_step_are_copied(case):
    """Strides TMA cannot take: a feature stride other than 1, a token stride
    that is not a multiple of 16 bytes, a broadcast (stride 0) dim."""
    if case == "d_stride":
        t = torch.zeros(1, 2, 64, 40, dtype=torch.bfloat16).transpose(2, 3)
    elif case == "odd_token_stride":
        t = torch.zeros(1, 2, 40, 36, dtype=torch.bfloat16)[..., :32]
    else:
        t = torch.zeros(1, 2, 1, 32, dtype=torch.bfloat16).expand(1, 2, 40, 32)
    assert not fa.tma_ready(t)
    assert fa.tma_ready(fa.tma_operand(t))


def test_length_one_dims_do_not_matter():
    """A dim of length 1 is never stepped, so its stride is no obstacle."""
    t = torch.zeros(3, 1, 40, 32, dtype=torch.bfloat16)[1:2]
    assert t.data_ptr() % 16 == 0
    assert fa.tma_ready(t.as_strided(t.shape, (5, 3, 32, 1)))


@pytest.mark.parametrize("N,want", [(1, 128), (127, 128), (128, 128), (129, 256), (2048, 2048)])
def test_padded_queries(N, want):
    assert fa.padded_queries(N) == want


@pytest.mark.parametrize("rope", [False, True])
def test_bwd_scratch_layout(rope):
    """q_s always; q_u and k_rot only with RoPE; delta and lse*log2(e) over
    whole 128-query blocks; every piece 256-byte aligned, none overlapping."""
    B, H, N, M, D = 2, 3, 130, 130, 88
    offsets, total = fa.bwd_scratch(B, H, N, M, D, rope)
    sizes = [B * H * N * D * 2, B * H * N * D * 2, B * H * M * D * 2, B * H * 256 * 4,
             B * H * 256 * 4]
    present = [True, rope, rope, True, True]
    assert [o is not None for o in offsets] == present
    spans = sorted((o, o + n) for o, n, keep in zip(offsets, sizes, present) if keep)
    assert all(o % 256 == 0 for o, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= total < spans[-1][1] + 256
