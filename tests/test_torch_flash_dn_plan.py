"""The host side of B1, the DN flash forward on wgmma and TMA
(`vjepa2_tpu_torch/ops/flash_attention_dn.py`), on the CPU: when TMA reads
v [B, H, D, M] in place (`tma_ready`, the rule the C entry point checks
before it refuses a v without a copy buffer), the buffer the wrapper then
gives the prologue to copy v into (`v_copy_shape`: key rows of M rounded up
to 8), and the scratch it always allocates (`fwd_scratch_shapes`). The
kernel itself runs only on the card (`test_torch_flash_dn_cuda.py`)."""

import pytest
import torch

from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops.flash_attention import tma_ready


def _projection_views(B, H, D, N):
    """q, k, v as the DN projection emits them: views of one [B, 3*H*D, N]
    buffer (unit stride along N, d stride N)."""
    y = torch.zeros(B, 3 * H * D, N, dtype=torch.bfloat16)
    return y.view(B, 3, H, D, N).unbind(1)


@pytest.mark.parametrize("M", [64, 584, 1624, 1664, 2048])
def test_contiguous_v_with_whole_16_byte_rows_is_read_in_place(M):
    v = torch.zeros(2, 3, 64, M, dtype=torch.bfloat16)
    assert tma_ready(v)


@pytest.mark.parametrize("M,Mp", [(100, 104), (1806, 1808), (57, 64), (1, 8)])
def test_v_with_ragged_rows_is_copied(M, Mp):
    """M % 8 != 0: a feature's keys do not start 16-byte aligned, so the
    prologue copies v into [B, H, D, M rounded up to 8]."""
    v = torch.zeros(2, 3, 32, M, dtype=torch.bfloat16)
    assert not tma_ready(v)
    assert fdn.v_copy_shape(v) == (2, 3, 32, Mp)


@pytest.mark.parametrize("N,in_place", [(2048, True), (176, True), (1806, False), (100, False)])
def test_projection_views(N, in_place):
    """The model's v is a view of the qkv projection: its d stride is N."""
    _, _, v = _projection_views(2, 4, 64, N)
    assert not v.is_contiguous()
    assert tma_ready(v) == in_place


def test_unaligned_base_is_copied():
    """A v whose base is not 16-byte aligned is copied into a buffer of its
    own shape (M is already a multiple of 8)."""
    B, H, D, M = 1, 2, 16, 64
    flat = torch.zeros(8 + B * H * D * M, dtype=torch.bfloat16)
    v = flat[3: 3 + B * H * D * M].view(B, H, D, M)
    assert v.data_ptr() % 16 and not tma_ready(v)
    assert fdn.v_copy_shape(v) == (B, H, D, M)


def test_length_one_dims_do_not_matter():
    """A batch or head dim of length 1 is never stepped, so its stride is no
    obstacle."""
    v = torch.zeros(1, 1, 48, 256, dtype=torch.bfloat16)
    assert tma_ready(v.as_strided(v.shape, (7, 5, 256, 1)))


@pytest.mark.parametrize("N,M", [(2048, 2048), (100, 203), (300, 100)])
@pytest.mark.parametrize("D", [16, 48])
def test_fwd_scratch_shapes(N, M, D):
    """q' and k' token-major (the prologue's rotated, rounded copies, which
    TMA reads as boxes of 64 features x 128 tokens); v's copy buffer, when
    it is needed, of whole 16-byte key rows."""
    q = torch.zeros(2, 3, D, N, dtype=torch.bfloat16)
    k = torch.zeros(2, 3, D, M, dtype=torch.bfloat16)
    assert fdn.fwd_scratch_shapes(q, k) == ((2, 3, N, D), (2, 3, M, D))
    assert tma_ready(k) == (M % 8 == 0)
    assert fdn.v_copy_shape(k) == (2, 3, D, (M + 7) // 8 * 8)
