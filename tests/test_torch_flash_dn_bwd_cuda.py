"""The hand-written DN flash backward (B2, `vjepa2_tpu_torch/csrc/flash_bwd_dn.cu`,
wgmma and TMA) against its plain PyTorch version on the card, over the
feature surface and the edges the training shapes do not reach: short and
ragged N, pad keys past kv_valid, segment ids at 2**24, D 16 and 48, a
non-contiguous cotangent, the copy path of a v and do whose rows TMA cannot
step (N % 8 != 0, with frame-causal segments as the AC predictor has them),
equal bits from two calls, a grad-mode forward and backward through
`Attention`, and the DROID step's AC shapes (the rollout's 516 tokens, and
516 and 1806 stack-padded with the pad keys on segment int32-max).

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_dn_bwd_cuda.py -q

Tolerance: the kernels run on bf16 inputs; the plain forward and backward
run in fp32 on the same inputs (cast up). The kernels round at 2**-9
relative where the plain path does not: q (after the scale) and k after the
rotation, q_u, p before dV, ds before dK and dQ, out before delta, and the
gradients themselves. About five such roundings meet in each gradient
element, and they are independent, so the relative L2 error should be near
5e-3; each gradient is held to 2e-2 relative L2 and to a max abs error of
3e-2 x max|plain| (its largest entries carry the same few roundings).
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

pytestmark = pytest.mark.cuda

REL_L2, MAX_ABS = 2e-2, 3e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)


def _tables(N, D, dev, per_example=0):
    pos = torch.arange(N, device=dev)
    if per_example:  # a different token order per example, as masked positions give
        pos = torch.stack([torch.randperm(4 * N, generator=torch.Generator().manual_seed(i))[:N]
                           for i in range(per_example)]).sort(1).values.to(dev)
    (cos, sin), _ = expand_rope_cache(build_rope_cache(pos, D, 16, 16), D)
    return cos, sin


def _grads_kernel(q, k, v, do, **kw):
    with torch.no_grad():
        out, lse = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
        before = fdn.LAUNCHES_BWD
        grads = fdn.flash_attention_bhdn_bwd(q, k, v, out, lse, do, **kw)
        assert fdn.LAUNCHES_BWD == before + 1
        torch.cuda.synchronize()
    return grads


def _grads_plain(q, k, v, do, **kw):
    q, k, v, do = (t.float() for t in (q, k, v, do))
    with torch.no_grad():
        out, lse = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
        return fdn.flash_attention_bhdn_bwd_plain(q, k, v, out, lse, do, **kw)


def _close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), name
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        err = (g - w).abs().max().item()
        assert rel <= REL_L2, (name, rel)
        assert err <= MAX_ABS * w.abs().max().item(), (name, err)


@pytest.mark.parametrize("D", [16, 32, 48, 64])
# 24: shorter than one 64-token tile; 100: ragged, not a multiple of 8
@pytest.mark.parametrize("N", [24, 64, 100, 200])
@pytest.mark.parametrize("feature", ["none", "rope", "rope_per_example", "kv_valid",
                                     "segments"])
def test_bwd_kernel_matches_plain(dev, D, N, feature):
    B, H = 2, 3
    q, k, v, do = (_randn((B, H, D, N), dev, s) for s in range(4))
    kw = {}
    if feature.startswith("rope"):
        kw["rope_expanded"] = _tables(N, D, dev, per_example=B if "example" in feature else 0)
    if feature == "kv_valid":
        kw["kv_valid_len"] = max(N - 37, N // 2)
    if feature == "segments":
        seg = np.sort(np.random.RandomState(1).randint(0, 6, (B, N)), axis=1)
        kw["segment_ids"] = torch.from_numpy(seg.astype(np.int32)).to(dev)
    _close(_grads_kernel(q, k, v, do, **kw), _grads_plain(q, k, v, do, **kw))


@pytest.mark.parametrize("N", [96, 100])
def test_pad_keys_past_kv_valid_get_zero_gradient(dev, N):
    q, k, v, do = (_randn((2, 3, 32, N), dev, s) for s in range(4))
    kv_valid = N - 29  # the last tile is partly, and for N 96 one row wholly, past it
    dq, dk, dv = _grads_kernel(q, k, v, do, kv_valid_len=kv_valid,
                               rope_expanded=_tables(N, 32, dev))
    assert not dk[..., kv_valid:].any() and not dv[..., kv_valid:].any()
    assert dk[..., :kv_valid].abs().amax().item() > 0 and torch.isfinite(dq.float()).all()


def test_segment_ids_at_2p24(dev):
    """Ids 2**24 and 2**24 + 1 are one fp32 value; the kernel compares the
    int32 ids exactly, so the later segment's keys get no gradient from the
    earlier segment's queries."""
    D, n = 32, 128
    q, k, v = (_randn((1, 2, D, n), dev, s) for s in range(3))
    do = torch.zeros_like(q)
    do[..., : n // 2] = _randn((1, 2, D, n // 2), dev, 5)  # cotangent on segment 2**24 only
    seg = torch.full((n,), 2**24, dtype=torch.int32, device=dev)
    seg[n // 2:] += 1
    got = _grads_kernel(q, k, v, do, segment_ids=seg)
    assert not got[1][..., n // 2:].any() and not got[2][..., n // 2:].any()
    _close(got, _grads_plain(q, k, v, do, segment_ids=seg))


def test_non_contiguous_cotangent(dev):
    """do as autograd hands it over after the output projection: [B, N, H, D]
    memory seen as [B, H, D, N] (unit stride along D, not N)."""
    B, H, D, N = 2, 4, 64, 136
    q, k, v = (_randn((B, H, D, N), dev, s) for s in range(3))
    do = _randn((B, N, H, D), dev, 7).permute(0, 2, 3, 1)
    assert do.stride(3) != 1
    rope = _tables(N, D, dev)
    got = _grads_kernel(q, k, v, do, rope_expanded=rope)
    same = _grads_kernel(q, k, v, do.contiguous(), rope_expanded=rope)
    for a, b in zip(got, same):
        assert torch.equal(a, b)
    _close(got, _grads_plain(q, k, v, do, rope_expanded=rope))


@pytest.mark.parametrize("D", [16, 32, 48, 64])
def test_bwd_is_deterministic(dev, D):
    """Two backward calls give equal bits: no atomics whose order varies."""
    B, H, N = 2, 3, 200
    q, k, v, do = (_randn((B, H, D, N), dev, s) for s in range(4))
    kw = {"rope_expanded": _tables(N, D, dev, per_example=B), "kv_valid_len": N - 11}
    first = _grads_kernel(q, k, v, do, **kw)
    for a, b in zip(first, _grads_kernel(q, k, v, do, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [1806, 100])
def test_ragged_rows_with_segments_take_the_copy_path(dev, N):
    """N % 8 != 0: a contiguous v's and do's token rows are not whole
    16-byte units, so the entry point refuses them and the wrapper calls
    again with buffers of rows rounded up to 8, into which the prologue
    copies them; frame-causal segments as the AC predictor's (7 frames)."""
    B, H, D = 1, 2, 64
    q, k, v, do = (_randn((B, H, D, N), dev, s) for s in range(4))
    assert fdn.bwd_copy_shapes(v, do) == ((B, H, D, -(-N // 8) * 8),) * 2
    frames = 7
    seg = torch.arange(frames, dtype=torch.int32, device=dev).repeat_interleave(-(-N // frames))[:N]
    kw = {"segment_ids": seg, "rope_expanded": _tables(N, D, dev)}
    _close(_grads_kernel(q, k, v, do, **kw), _grads_plain(q, k, v, do, **kw))


def test_attention_layer_grad_mode(dev):
    """A grad-mode forward and backward through the DN route of `Attention`
    (RoPE, stack-pad kv_valid) in bf16 on the card, against the same layer in
    fp32 on the CPU (the plain path): the input gradient and every parameter
    gradient."""
    B, N, dim, heads, kv_valid = 2, 136, 256, 4, 131
    gen = torch.Generator().manual_seed(0)
    cpu = tm.Attention(dim, heads, use_rope=True, use_flash=True)
    cpu.reset_parameters(gen)
    gpu = tm.Attention(dim, heads, use_rope=True, use_flash=True, dtype=torch.bfloat16,
                       device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(B, N, dim).astype(np.float32))
    w = torch.from_numpy(rng.randn(B, N, dim).astype(np.float32))
    w[:, kv_valid:] = 0.0  # pad rows are sliced off: no cotangent
    pos = torch.arange(N)
    (cos, sin), perm = expand_rope_cache(build_rope_cache(pos, dim // heads, 4, 4), dim // heads)
    perm = tm.qkv_row_perm(perm, heads, dim // heads)

    results = []
    for layer, device in ((gpu, dev), (cpu, torch.device("cpu"))):
        xi = x.to(device).requires_grad_()
        before = fdn.LAUNCHES_BWD
        y = layer(xi, rope_expanded=(cos.to(device), sin.to(device)), qkv_perm=perm.to(device),
                  kv_valid=kv_valid)
        (y.float() * w.to(device)).sum().backward()
        assert fdn.LAUNCHES_BWD == before + (device.type == "cuda")
        results.append([xi.grad] + [p.grad for p in layer.parameters()])
        layer.zero_grad(set_to_none=True)
    for got, want in zip(*results):
        got = got.float().cpu()
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= REL_L2, rel


def test_cuda_bwd_raises_on_what_it_cannot_take(dev):
    q, k, v, do = (_randn((1, 2, 64, 128), dev, s) for s in range(4))
    with torch.no_grad():
        out, lse = fdn.flash_attention_bhdn(q, k, v, return_lse=True)
    with pytest.raises(TypeError):
        fdn.flash_attention_bhdn_bwd(q, k, v, out, lse, do.float())
    with pytest.raises(TypeError):
        fdn.flash_attention_bhdn_bwd(q, k, v, out, lse.double(), do)
    with pytest.raises(ValueError):
        fdn.flash_attention_bhdn_bwd(q, k, v, out, lse[:, :, :64], do)


@pytest.mark.parametrize("N, frames, pad", [
    (516, 2, 0),   # the DROID rollout call: 2 frames of 2 + 256 tokens (copy path)
    (520, 2, 4),   # ... stack-padded, pad keys on segment int32-max, as the model runs it
    (1808, 7, 2),  # teacher forcing, 7 frames, stack-padded
])
def test_droid_step_shapes(dev, N, frames, pad):
    """B2 at the AC predictor's shapes in the DROID step, batch 8, 16 heads
    of 64; real queries give the pad keys no gradient."""
    B, H, D = 8, 16, 64
    q, k, v, do = (_randn((B, H, D, N), dev, s) for s in range(4))
    kw = {"segment_ids": tm.frame_segments(frames, (N - pad) // frames, dev, pad),
          "rope_expanded": _tables(N, D, dev)}
    got = _grads_kernel(q, k, v, do, **kw)
    _close(got, _grads_plain(q, k, v, do, **kw))
    if pad:  # only the pad queries (sliced off by the model) reach the pad keys
        do_real = do.clone()
        do_real[..., N - pad:] = 0
        _, dk, dv = _grads_kernel(q, k, v, do_real, **kw)
        assert not dk[..., N - pad:].any() and not dv[..., N - pad:].any()
