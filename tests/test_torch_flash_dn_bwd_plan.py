"""The host side of B2, the DN flash backward on wgmma and TMA
(`vjepa2_tpu_torch/ops/flash_attention_dn.py`), on the CPU: which of v and
do the wrapper lets TMA read in place and which it hands to the prologue to
copy (`bwd_copy_shapes`, by `tma_ready`'s rule, which the C entry point
checks before it refuses), the copy buffers' shapes at N or M % 8 != 0, and
the scratch the prologue writes (`bwd_scratch`) at each shape of
`chip_smoke.py`'s `BWD_SHAPES`. The kernels themselves run only on the card
(`test_torch_flash_dn_bwd_cuda.py`)."""

import importlib.util
from pathlib import Path

import pytest
import torch

from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops.flash_attention import padded_queries, tma_ready


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _projection_views(B, H, D, N):
    """q, k, v as the DN projection emits them: views of one [B, 3*H*D, N]
    buffer (unit stride along N, d stride N)."""
    y = torch.zeros(B, 3 * H * D, N, dtype=torch.bfloat16)
    return y.view(B, 3, H, D, N).unbind(1)


def _autograd_cotangent(B, H, D, N):
    """do as autograd hands it to the backward after the output projection:
    [B, N, H, D] memory seen as [B, H, D, N] (unit stride along D)."""
    return torch.zeros(B, N, H, D, dtype=torch.bfloat16).permute(0, 2, 3, 1)


@pytest.mark.parametrize("N", [64, 176, 584, 1624, 1664, 2048])
def test_contiguous_v_and_do_are_read_in_place(N):
    v = torch.zeros(2, 3, 64, N, dtype=torch.bfloat16)
    do = torch.zeros_like(v)
    assert fdn.bwd_copy_shapes(v, do) == (None, None)


@pytest.mark.parametrize("N,Nr", [(1806, 1808), (100, 104), (24, 24), (173, 176)])
@pytest.mark.parametrize("D", [16, 48, 64])
def test_ragged_rows_are_copied(N, Nr, D):
    """A contiguous v and do with N % 8 != 0: a feature's tokens do not start
    16-byte aligned, so both are copied into [B, H, D, N rounded up to 8]; at
    N 24 the rows are whole 16-byte units and both are read in place."""
    v = torch.zeros(2, 3, D, N, dtype=torch.bfloat16)
    want = None if N % 8 == 0 else (2, 3, D, Nr)
    assert fdn.bwd_copy_shapes(v, torch.zeros_like(v)) == (want, want)
    assert fdn.v_copy_shape(v) == (2, 3, D, Nr)


@pytest.mark.parametrize("N,in_place", [(2048, True), (584, True), (176, True), (1806, False)])
def test_model_operands(N, in_place):
    """In the step: v a view of the qkv projection (read in place when its
    d stride N is a multiple of 8), do the autograd cotangent, whose unit
    stride is along D: always copied."""
    _, _, v = _projection_views(2, 4, 64, N)
    do = _autograd_cotangent(2, 4, 64, N)
    assert not v.is_contiguous() and do.stride(2) == 1
    shapes = fdn.bwd_copy_shapes(v, do)
    assert shapes[0] == (None if in_place else (2, 4, 64, -(-N // 8) * 8))
    assert shapes[1] == (2, 4, 64, -(-N // 8) * 8)
    assert not tma_ready(do)


def test_unaligned_base_is_copied():
    B, H, D, N = 1, 2, 32, 64
    flat = torch.zeros(8 + B * H * D * N, dtype=torch.bfloat16)
    do = flat[3: 3 + B * H * D * N].view(B, H, D, N)
    v = torch.zeros(B, H, D, N, dtype=torch.bfloat16)
    assert do.data_ptr() % 16 and fdn.bwd_copy_shapes(v, do) == (None, (B, H, D, N))


def _scratch_want(B, H, D, N, M):
    """q_s, q_u [B, H, N, D] and k_rot [B, H, M, D] bf16; delta, lse*log2(e)
    [B, H, N rounded up to 128] fp32; each piece starting 256-aligned."""
    Np = -(-N // 128) * 128
    sizes = [B * H * N * D * 2] * 2 + [B * H * M * D * 2] + [B * H * Np * 4] * 2
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 256) * 256
    return tuple(offsets), total


def test_scratch_at_the_smoke_shapes():
    """The prologue's scratch at every `BWD_SHAPES` entry (the step's
    contexts and predictor sequences at batch 8, stack-padded to 8, the
    AC predictor's 1806 and 516 tokens as they come and stack-padded to
    1808 and 520, and the 64-frame cooldown's contexts and predictor
    sequences at batch 2): token-major q_s, q_u, k_rot and the padded fp32
    rows, 256-aligned pieces, about 3 x the size of q."""
    c = _chip_smoke()
    seqs = c._mask_seqs()
    lengths = {name: ids.shape[1] + (-ids.shape[1]) % 8 for name, ids in seqs.items()}
    batches = {name: ids.shape[0] for name, ids in seqs.items()}
    for name, (frames, pad) in c.AC_SEQUENCES.items():
        lengths[name], batches[name] = frames * 258 + pad, 8
    assert [lengths[seq] for _, _, _, seq in c.BWD_SHAPES] == [584, 176, 1624, 1664, 1806,
                                                               1808, 516, 520, 2304, 568,
                                                               6480, 6472]
    for _, H, D, seq in c.BWD_SHAPES:
        N, B = lengths[seq], batches[seq]
        offsets, total = fdn.bwd_scratch(B, H, D, N, N)
        assert (offsets, total) == _scratch_want(B, H, D, N, N)
        assert all(off % 256 == 0 for off in offsets)
        assert padded_queries(N) % 128 == 0 and padded_queries(N) >= N
        assert 3 * B * H * D * N * 2 < total <= 3 * B * H * D * N * 2 + 2 * B * H * (N + 128) * 4 + 5 * 256


@pytest.mark.parametrize("N,M", [(100, 203), (300, 100), (24, 24)])
def test_scratch_keys_and_queries_apart(N, M):
    """k_rot takes M rows, the query pieces N (q_s, q_u) or N rounded up to
    the dQ block of 128 (delta, lse*log2(e))."""
    assert fdn.bwd_scratch(2, 3, 48, N, M) == _scratch_want(2, 3, 48, N, M)
