"""The hand-written DN flash kernel (B1, `vjepa2_tpu_torch/csrc/flash_fwd_dn.cu`,
wgmma and TMA) against its plain PyTorch version on the card, over the
feature surface and the ragged shapes the production shapes do not reach.
The Hopper design's own edges: v that TMA cannot read in place (M % 8 != 0,
or strides that are not multiples of 8), which the prologue copies first,
at every head width, with N != M, strided q/k/v, segments and kv_valid;
key tiles that end past M; two calls giving equal bits; and the DROID
step's shapes (the ViT-g target's single frames, the AC predictor's
frame-causal rollout, and its sequences stack-padded with the pad keys on
segment int32-max).

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax, so it runs
where jax is absent (``--noconftest`` skips the suite's jax conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_flash_dn_cuda.py -q

Tolerance: both sides see the same bf16 inputs. The kernel rounds q to bf16
after folding in scale*log2(e), the plain version rounds q before the fp32
scale (`flash_attention_dn.py:163-164` against `attention.py:283-285`), and
the two round the probabilities at different points (unnormalised in the
kernel, normalised in the plain version). Each rounding is 2**-9 relative,
so a score differs by up to 2**-8*|s| and lse by as much at the row's
largest scores (|s| < ~7 here): out is held to |d| <= 1e-2 + 1e-2*|plain|
and lse to |d| <= 3e-2.
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.models.modules import frame_segments
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops.flash_attention import tma_ready
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, D, N, dev, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, H, D, N).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(3)]


def _tables(N, D, dev):
    pos = torch.arange(N, device=dev)
    (cos, sin), _ = expand_rope_cache(build_rope_cache(pos, D, 16, 16), D)
    return cos, sin


def _close(kernel, plain):
    out_k, lse_k = kernel
    out_p, lse_p = plain
    assert torch.isfinite(out_k.float()).all() and torch.isfinite(lse_k).all()
    d_out = (out_k.float() - out_p.float()).abs()
    assert (d_out <= 1e-2 + 1e-2 * out_p.float().abs()).all(), d_out.max().item()
    assert (lse_k - lse_p).abs().max().item() <= 3e-2


@pytest.mark.parametrize("D", [16, 32, 48, 64])
@pytest.mark.parametrize("N", [64, 100, 200])  # 100: the scalar (unaligned) path
@pytest.mark.parametrize("feature", ["none", "rope", "rope_dn_tables", "rope_per_sample",
                                     "kv_valid", "segments", "segments_2p24"])
def test_kernel_matches_plain(dev, D, N, feature):
    B, H = 2, 3
    q, k, v = _inputs(B, H, D, N, dev)
    kw = {}
    if feature.startswith("rope"):
        cos, sin = _tables(N, D, dev)
        if feature == "rope_dn_tables":
            cos, sin = cos.transpose(1, 2), sin.transpose(1, 2)  # [1, D, N] strides
        if feature == "rope_per_sample":  # [B, N, D]: a table per batch element
            cos, sin = torch.cat([cos, cos.flip(1)]), torch.cat([sin, sin.flip(1)])
        kw["rope_expanded"] = (cos, sin)
    if feature == "kv_valid":
        kw["kv_valid_len"] = N - 37
    if feature.startswith("segments"):
        rng = np.random.RandomState(1)
        seg = np.sort(rng.randint(0, 6, (B, N)), axis=1).astype(np.int32)
        if feature == "segments_2p24":  # ids one fp32 value cannot tell apart
            seg = seg + 2**24
        kw["segment_ids"] = torch.from_numpy(seg).to(dev)
    with torch.inference_mode():
        before = fdn.LAUNCHES
        got = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
        assert fdn.LAUNCHES == before + 1
        want = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
        torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("N,M", [(100, 200), (256, 64)])
def test_kernel_takes_fewer_or_more_keys_than_queries(dev, N, M):
    q = _inputs(2, 3, 32, N, dev)[0]
    k, v = _inputs(2, 3, 32, M, dev, seed=1)[:2]
    with torch.inference_mode():
        got = fdn.flash_attention_bhdn(q, k, v, return_lse=True)
        want = fdn.flash_attention_bhdn_plain(q, k, v)
        torch.cuda.synchronize()
    _close(got, want)


def test_kernel_takes_strided_qkv(dev):
    """q, k, v as the DN projection emits them: views of one [B, 3*H*D, N]
    buffer, unit-stride along N only."""
    B, H, D, N = 2, 4, 64, 192
    rng = np.random.RandomState(2)
    y = torch.from_numpy(rng.randn(B, 3 * H * D, N).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = y.view(B, 3, H, D, N).unbind(1)
    assert not q.is_contiguous()
    rope = _tables(N, D, dev)
    with torch.inference_mode():
        got = fdn.flash_attention_bhdn(q, k, v, rope_expanded=rope, return_lse=True)
        want = fdn.flash_attention_bhdn_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                              rope_expanded=rope)
        torch.cuda.synchronize()
    _close(got, want)


def test_cuda_route_raises_on_what_it_cannot_take(dev):
    q, k, v = _inputs(1, 2, 64, 128, dev)
    with pytest.raises(TypeError, match="one dtype"):  # mixed: fp32 q beside bf16 k, v
        fdn.flash_attention_bhdn(q.float(), k, v)
    with pytest.raises(TypeError, match="one dtype"):  # fp16: no kernel takes it
        fdn.flash_attention_bhdn(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fdn.flash_attention_bhdn(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        qq, kk, vv = _inputs(1, 2, 80, 128, dev)
        fdn.flash_attention_bhdn(qq, kk, vv)
    with pytest.raises(ValueError):
        fdn.flash_attention_bhdn(q, k.cpu(), v)


def _strided_qkv(B, H, D, N, dev, seed=5):
    """q, k, v as views of one [B, 3*H*D, N] buffer: unit stride along N,
    d stride N (not a multiple of 8 when N % 8)."""
    rng = np.random.RandomState(seed)
    y = torch.from_numpy(rng.randn(B, 3 * H * D, N).astype(np.float32)).to(dev, torch.bfloat16)
    return y.view(B, 3, H, D, N).unbind(1)


@pytest.mark.parametrize("D", [16, 32, 48, 64])
@pytest.mark.parametrize("N,M", [(100, 100), (100, 203), (300, 100), (130, 57)])
def test_v_copy_path_n_ne_m(dev, D, N, M):
    """M % 8 != 0: TMA cannot step v's key rows in place, so the prologue
    copies v into rows of M rounded up to 8; key tiles end past M."""
    q = _inputs(2, 3, D, N, dev)[0]
    k, v = _inputs(2, 3, D, M, dev, seed=1)[:2]
    assert tma_ready(v) == (M % 8 == 0)
    kw = {"kv_valid_len": M - 5}
    with torch.inference_mode():
        got = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
        want = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
        torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("D", [16, 48])
@pytest.mark.parametrize("N", [100, 200])
@pytest.mark.parametrize("feature", ["segments", "kv_valid"])
def test_strided_qkv_with_masks(dev, D, N, feature):
    """q, k, v as views of one projection output with RoPE, and a mask: at
    N = 100 v's d stride is not a multiple of 8 (copied), at 200 it is."""
    B, H = 2, 3
    q, k, v = _strided_qkv(B, H, D, N, dev)
    assert tma_ready(v) == (N % 8 == 0)
    kw = {"rope_expanded": _tables(N, D, dev)}
    if feature == "segments":
        rng = np.random.RandomState(3)
        kw["segment_ids"] = torch.from_numpy(
            np.sort(rng.randint(0, 5, (B, N)), axis=1).astype(np.int32)).to(dev)
    else:
        kw["kv_valid_len"] = N - 29
    with torch.inference_mode():
        got = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
        want = fdn.flash_attention_bhdn_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                              **kw)
        torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("D", [16, 32, 48, 64])
def test_forward_is_deterministic(dev, D):
    """Two calls give equal bits, on the in-place and on the copy path."""
    for N in (256, 250):
        q, k, v = _inputs(2, 3, D, N, dev, seed=7)
        kw = {"rope_expanded": _tables(N, D, dev), "kv_valid_len": N - 3}
        with torch.inference_mode():
            first = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
            second = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])



@pytest.mark.parametrize("B, H, N, frames, pad", [
    (64, 22, 256, 0, 0),   # the ViT-g target over single frames
    (8, 16, 516, 2, 0),    # the rollout call: 2 frames of 2 + 256 tokens
    (8, 16, 520, 2, 4),    # ... stack-padded, as the AC predictor runs it
    (8, 16, 1808, 7, 2),   # teacher forcing, 7 frames, stack-padded
])
def test_droid_step_shapes(dev, B, H, N, frames, pad):
    q, k, v = _inputs(B, H, 64, N, dev, seed=11)
    kw = {"rope_expanded": _tables(N, 64, dev)}
    if frames:
        kw["segment_ids"] = frame_segments(frames, (N - pad) // frames, dev, pad)
    assert tma_ready(v) == (N % 8 == 0)
    with torch.inference_mode():
        got = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
        want = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
        torch.cuda.synchronize()
    _close(got, want)
