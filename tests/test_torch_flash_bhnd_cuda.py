"""The hand-written BHND flash kernels (B3 `vjepa2_tpu_torch/csrc/flash_fwd_bhnd.cu`,
the B4/B5 backward `csrc/flash_bwd_bhnd.cu`) against their plain PyTorch
versions on the card, over the feature surface and the edges the model
shapes do not reach: D 80, 88 and 104, and 32 and 64 (the fused LayerNorm
route's widths); ragged N and M; kv_valid in the first
and in the last tile; per-example RoPE tables; segment ids, also 2**24
apart; key-side segment ids with M != N (a ring hop) and a given lse;
token-causal; q, k, v as views of one qkv output and a non-contiguous
cotangent; rows with no key; an unsupported width, through the wrapper and
through `sdpa` and `attend` with ``use_flash``; a grad-mode forward and
backward through `Attention` at Dh 80 and 88. The Hopper design's own edges:
N and M at 127, 128, 129 and 255 (the 128-token tiles and the two
64-row warpgroups); kv_valid inside the last key tile; causal across the
two warpgroups' rows; RoPE at D 80, 88 and 104, whose pairs straddle the
64-feature chunks; a view with an unaligned base (copied, still launched);
backward calls bit-equal at every width; and the built library's SASS:
wgmma (HGMMA) and no mma.sync (HMMA.16816) in the BHND kernels, B1's main
kernel and B8's GEMM.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_bhnd_cuda.py -q

Tolerances: the kernels run on bf16 inputs; the plain versions run in fp32
on the same inputs (cast up). Forward, as B1's: q is rounded after the
scale and p before P.V (2**-9 relative each), so out within 1e-2 +
1e-2 |plain| and lse within 3e-2. Backward, as B2's: about five
independent 2**-9 roundings meet in each gradient element (q_s, k_rot, q_u,
p, ds, out before delta, the gradient itself), so 2e-2 relative L2 and
3e-2 x max|plain| max abs.
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops import attention as tattn
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

pytestmark = pytest.mark.cuda

OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 3e-2
REL_L2, MAX_ABS = 2e-2, 3e-2
FEATURES = ["none", "rope", "rope_per_example", "kv_valid_first", "kv_valid_last",
            "segments", "causal", "seg_kv"]


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


def _case(B, H, D, N, feature, dev, M=None):
    """(q, k, v, do, kwargs) for one feature; seg_kv gets M keys (N + 40 by
    default)."""
    M = M or N + 40 if feature == "seg_kv" else N
    q, do = _randn((B, H, N, D), dev, 0), _randn((B, H, N, D), dev, 3)
    k, v = _randn((B, H, M, D), dev, 1), _randn((B, H, M, D), dev, 2)
    kw = {}
    if feature.startswith("rope"):
        kw["rope_expanded"] = _tables(N, D, dev, per_example=B if "example" in feature else 0)
    if feature == "kv_valid_first":
        kw["kv_valid_len"] = min(5, N)
    if feature == "kv_valid_last":
        kw["kv_valid_len"] = N - 3
    if feature == "segments":
        seg = np.sort(np.random.RandomState(1).randint(0, 6, (B, N)), axis=1)
        kw["segment_ids"] = torch.from_numpy(seg.astype(np.int32)).to(dev)
    if feature == "causal":
        kw["causal"] = True
    if feature == "seg_kv":  # every query sees key 0 (id 0 <= any query id)
        rng = np.random.RandomState(2)
        seg_q = np.sort(rng.randint(1, 6, (B, N)), axis=1)
        seg_k = np.sort(rng.randint(0, 6, (B, M)), axis=1)
        seg_k[:, 0] = 0
        kw["segment_ids"] = torch.from_numpy(seg_q.astype(np.int32)).to(dev)
        kw["seg_kv"] = torch.from_numpy(seg_k.astype(np.int32)).to(dev)
    return q, k, v, do, kw


def _fwd_close(out, lse, out_p, lse_p):
    out, out_p = out.float(), out_p.float()
    assert torch.isfinite(out).all()
    assert ((out - out_p).abs() <= OUT_ATOL + OUT_RTOL * out_p.abs()).all(), \
        (out - out_p).abs().max().item()
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL


def _grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), name
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        err = (g - w).abs().max().item()
        assert rel <= REL_L2, (name, rel)
        assert err <= MAX_ABS * w.abs().max().item(), (name, err)


def _kernel_fwd(q, k, v, **kw):
    with torch.no_grad():
        before = fa.LAUNCHES
        out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
        assert fa.LAUNCHES == before + 1
        torch.cuda.synchronize()
    return out, lse


def _kernel_bwd(q, k, v, out, lse, do, **kw):
    with torch.no_grad():
        before = fa.LAUNCHES_BWD
        grads = fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)
        assert fa.LAUNCHES_BWD == before + 1
        torch.cuda.synchronize()
    return grads


def _plain(q, k, v, do, **kw):
    q, k, v, do = (t.float() for t in (q, k, v, do))
    with torch.no_grad():
        out, lse = fa.flash_attention_bhnd_plain(q, k, v, **kw)
        return out, lse, fa.flash_attention_bhnd_bwd_plain(q, k, v, out, lse, do, **kw)


@pytest.mark.parametrize("D", [32, 64, 80, 88, 104])
# 24: shorter than one tile; 100: ragged, not a multiple of 8; 200: several tiles
@pytest.mark.parametrize("N", [24, 100, 200])
@pytest.mark.parametrize("feature", FEATURES)
def test_fwd_and_bwd_kernels_match_plain(dev, D, N, feature):
    q, k, v, do, kw = _case(2, 3, D, N, feature, dev)
    out, lse = _kernel_fwd(q, k, v, **kw)
    out_p, lse_p, grads_p = _plain(q, k, v, do, **kw)
    _fwd_close(out, lse, out_p, lse_p)
    _grads_close(_kernel_bwd(q, k, v, out, lse, do, **kw), grads_p)


@pytest.mark.parametrize("D", [80, 88])
def test_ring_hop_backward_with_a_given_lse(dev, D):
    """A ring hop's backward: no RoPE, key-side ids, and the GLOBAL lse of the
    whole ring (here: this hop's plus another hop's mass), not this hop's."""
    q, k, v, do, kw = _case(2, 3, D, 136, "seg_kv", dev)
    out, lse = _kernel_fwd(q, k, v, **kw)
    lse_global = torch.logaddexp(lse, lse - 0.7)
    got = _kernel_bwd(q, k, v, out, lse_global, do, **kw)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    want = fa.flash_attention_bhnd_bwd_plain(q32, k32, v32, out.float(), lse_global, do32, **kw)
    _grads_close(got, want)


def test_segment_ids_at_2p24(dev):
    """Ids 2**24 and 2**24 + 1 are one fp32 value; the kernels compare the
    int32 ids exactly, so earlier-segment queries never see later keys."""
    D, n = 80, 128
    q, k, v = (_randn((1, 2, n, D), dev, s) for s in range(3))
    do = torch.zeros_like(q)
    do[:, :, : n // 2] = _randn((1, 2, n // 2, D), dev, 5)  # cotangent on segment 2**24 only
    seg = torch.full((n,), 2**24, dtype=torch.int32, device=dev)
    seg[n // 2:] += 1
    out, lse = _kernel_fwd(q, k, v, segment_ids=seg)
    out_p, lse_p, grads_p = _plain(q, k, v, do, segment_ids=seg)
    _fwd_close(out, lse, out_p, lse_p)
    got = _kernel_bwd(q, k, v, out, lse, do, segment_ids=seg)
    assert not got[1][:, :, n // 2:].any() and not got[2][:, :, n // 2:].any()
    _grads_close(got, grads_p)


def test_rows_without_keys(dev):
    """Queries whose segment id is below every key's get output 0, lse -inf
    and no gradient (the TPU kernel's finite mask averages v instead)."""
    B, H, N, D = 1, 2, 96, 88
    q, k, v, do = (_randn((B, H, N, D), dev, s) for s in range(4))
    seg_q = torch.ones(N, dtype=torch.int32, device=dev)
    seg_q[:10] = 0
    seg_k = torch.ones(N, dtype=torch.int32, device=dev)
    out, lse = _kernel_fwd(q, k, v, segment_ids=seg_q, seg_kv=seg_k)
    assert not out[:, :, :10].any() and torch.isneginf(lse[:, :, :10]).all()
    dq, dk, dv = _kernel_bwd(q, k, v, out, lse, do, segment_ids=seg_q, seg_kv=seg_k)
    assert all(torch.isfinite(t.float()).all() for t in (dq, dk, dv))
    assert not dq[:, :, :10].any()


@pytest.mark.parametrize("D", [64, 80, 88])
def test_qkv_views_and_non_contiguous_cotangent(dev, D):
    """q, k, v as [B, H, N, D] views of one [B, N, 3, H, D] projection output
    (token stride 3*H*D) and do as autograd hands it over after the output
    projection; the results equal those of contiguous copies bit for bit."""
    B, H, N = 2, 4, 136
    qkv = _randn((B, N, 3, H, D), dev, 0)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    assert q.stride(2) == 3 * H * D
    do = _randn((B, N, H, D), dev, 7).transpose(1, 2)
    rope = _tables(N, D, dev)
    out, lse = _kernel_fwd(q, k, v, rope_expanded=rope, kv_valid_len=N - 5)
    cq, ck, cv = (t.contiguous() for t in (q, k, v))
    out_c, lse_c = _kernel_fwd(cq, ck, cv, rope_expanded=rope, kv_valid_len=N - 5)
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    got = _kernel_bwd(q, k, v, out, lse, do, rope_expanded=rope, kv_valid_len=N - 5)
    same = _kernel_bwd(cq, ck, cv, out_c.contiguous(), lse, do.contiguous(),
                       rope_expanded=rope, kv_valid_len=N - 5)
    for a, b in zip(got, same):
        assert torch.equal(a, b)
    _grads_close(got, _plain(q, k, v, do, rope_expanded=rope, kv_valid_len=N - 5)[2])


@pytest.mark.parametrize("entry", ["flash_attention_bhnd", "sdpa", "attend"])
@pytest.mark.parametrize("D", [48, 72, 128])
def test_unsupported_width_raises(dev, D, entry):
    """The kernel's wrapper and the dispatchers that take ``use_flash`` raise
    on a CUDA tensor at a width no BHND kernel takes; none of them runs the
    plain math instead."""
    q, k, v = (_randn((1, 2, 64, D), dev, s) for s in range(3))
    calls = {"flash_attention_bhnd": lambda: fa.flash_attention_bhnd(q, k, v),
             "sdpa": lambda: tattn.sdpa(q, k, v, use_flash=True),
             "attend": lambda: tattn.attend(q, k, v, use_flash=True)}
    with pytest.raises(ValueError, match="32, 64, 80, 88, 104"):
        calls[entry]()


@pytest.mark.parametrize("dim,heads", [(320, 4), (352, 4)])  # Dh 80, 88
def test_attention_layer_grad_mode(dev, dim, heads):
    """A grad-mode forward and backward through the BHND route of
    `Attention` (RoPE, stack-pad kv_valid) in bf16 on the card, against the
    same layer in fp32 on the CPU (the plain path): the launch counters show
    the kernels ran, and the input and every parameter gradient agree."""
    B, N, kv_valid = 2, 136, 131
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
    (cos, sin), perm = expand_rope_cache(build_rope_cache(torch.arange(N), dim // heads, 4, 4),
                                         dim // heads)
    perm = tm.qkv_row_perm(perm, heads, dim // heads)

    results = []
    for layer, device in ((gpu, dev), (cpu, torch.device("cpu"))):
        xi = x.to(device).requires_grad_()
        before = (fa.LAUNCHES, fa.LAUNCHES_BWD)
        y = layer(xi, rope_expanded=(cos.to(device), sin.to(device)), qkv_perm=perm.to(device),
                  kv_valid=kv_valid)
        (y.float() * w.to(device)).sum().backward()
        on_card = int(device.type == "cuda")
        assert (fa.LAUNCHES, fa.LAUNCHES_BWD) == (before[0] + on_card, before[1] + on_card)
        results.append([xi.grad] + [p.grad for p in layer.parameters()])
    for got, want in zip(*results):
        got = got.float().cpu()
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= REL_L2, rel


EDGES = [127, 128, 129, 255]


@pytest.mark.parametrize("D", [32, 64, 80, 88, 104])
@pytest.mark.parametrize("N", EDGES)
@pytest.mark.parametrize("feature", ["rope", "causal", "kv_valid_last"])
def test_tile_edges(dev, D, N, feature):
    """Query counts at the edges of the 128-query blocks and of their two
    64-row warpgroups, forward and backward."""
    q, k, v, do, kw = _case(1, 2, D, N, feature, dev)
    out, lse = _kernel_fwd(q, k, v, **kw)
    out_p, lse_p, grads_p = _plain(q, k, v, do, **kw)
    _fwd_close(out, lse, out_p, lse_p)
    _grads_close(_kernel_bwd(q, k, v, out, lse, do, **kw), grads_p)


@pytest.mark.parametrize("D", [32, 64, 80, 88, 104])
@pytest.mark.parametrize("M", EDGES)
def test_key_edges(dev, D, M):
    """Key counts at the edges of the 128-key tiles (key-side ids, M != N)."""
    q, k, v, do, kw = _case(1, 2, D, 72, "seg_kv", dev, M=M)
    assert k.shape[2] == M
    out, lse = _kernel_fwd(q, k, v, **kw)
    out_p, lse_p, grads_p = _plain(q, k, v, do, **kw)
    _fwd_close(out, lse, out_p, lse_p)
    _grads_close(_kernel_bwd(q, k, v, out, lse, do, **kw), grads_p)


@pytest.mark.parametrize("D", [64, 88])
@pytest.mark.parametrize("kv_valid", [257, 270, 383])
def test_kv_valid_inside_the_last_key_tile(dev, D, kv_valid):
    """kv_valid inside the third 128-key tile: its keys are masked one by one."""
    q, k, v, do, kw = _case(2, 2, D, 384, "rope", dev)
    kw["kv_valid_len"] = kv_valid
    out, lse = _kernel_fwd(q, k, v, **kw)
    out_p, lse_p, grads_p = _plain(q, k, v, do, **kw)
    _fwd_close(out, lse, out_p, lse_p)
    _grads_close(_kernel_bwd(q, k, v, out, lse, do, **kw), grads_p)


@pytest.mark.parametrize("D", [32, 80, 104])
def test_causal_across_warpgroups(dev, D):
    """Token-causal over one 128-query block: rows 0-63 (the first
    warpgroup) see part of the first key tile, rows 64-127 all of it."""
    q, k, v, do, kw = _case(2, 3, D, 128, "causal", dev)
    out, lse = _kernel_fwd(q, k, v, **kw)
    out_p, lse_p, grads_p = _plain(q, k, v, do, **kw)
    _fwd_close(out, lse, out_p, lse_p)
    _grads_close(_kernel_bwd(q, k, v, out, lse, do, **kw), grads_p)


@pytest.mark.parametrize("D", [80, 88, 104])
def test_rope_pairs_straddle_chunks(dev, D):
    """Per-example RoPE at the widths whose pairs (d, d + D/2) lie in both
    64-feature chunks: the forward rotates q in shared memory across them,
    the backward's adjoint reads them back from its fp32 staging."""
    q, k, v, do, kw = _case(2, 2, D, 200, "rope_per_example", dev)
    out, lse = _kernel_fwd(q, k, v, **kw)
    out_p, lse_p, grads_p = _plain(q, k, v, do, **kw)
    _fwd_close(out, lse, out_p, lse_p)
    _grads_close(_kernel_bwd(q, k, v, out, lse, do, **kw), grads_p)


@pytest.mark.parametrize("D", [64, 80])
def test_unaligned_view_is_copied_and_launched(dev, D):
    """q, k, v, do as views whose base is 2 bytes past a 16-byte boundary: TMA
    cannot read them in place, so the wrapper copies them and still launches
    the kernels (the counters rise), with the bits of contiguous operands."""
    B, H, N = 1, 2, 136
    n = B * H * N * D
    flat = _randn((4 * n + 8,), dev, 9)
    q, k, v, do = (flat[1 + i * n: 1 + (i + 1) * n].view(B, H, N, D) for i in range(4))
    assert q.data_ptr() % 16 and not fa.tma_ready(q)
    kw = {"kv_valid_len": N - 3}
    out, lse = _kernel_fwd(q, k, v, **kw)
    grads = _kernel_bwd(q, k, v, out, lse, do, **kw)
    cq, ck, cv, cdo = (t.clone() for t in (q, k, v, do))
    out_c, lse_c = _kernel_fwd(cq, ck, cv, **kw)
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    for a, b in zip(grads, _kernel_bwd(cq, ck, cv, out_c, lse_c, cdo, **kw)):
        assert torch.equal(a, b)
    _grads_close(grads, _plain(q, k, v, do, **kw)[2])


@pytest.mark.parametrize("D", [32, 64, 80, 88, 104])
def test_backward_is_deterministic(dev, D):
    """Two backward calls give equal bits: no atomics whose order varies."""
    q, k, v, do, kw = _case(2, 4, D, 300, "rope", dev)
    kw["kv_valid_len"] = 290
    out, lse = _kernel_fwd(q, k, v, **kw)
    first = _kernel_bwd(q, k, v, out, lse, do, **kw)
    for a, b in zip(first, _kernel_bwd(q, k, v, out, lse, do, **kw)):
        assert torch.equal(a, b)


def test_sass_uses_wgmma_not_mma_sync(dev):
    """The built library's Hopper kernels run on wgmma (HGMMA in the SASS)
    and contain no mma.sync m16n8k16 (HMMA.16816): B3 and the BHND backward
    (one instantiation per head width), B1's main kernel and B2's dK/dV and
    dQ kernels (per width), and the LayerNorm GEMM of B8 and B7 (B8's tile,
    and B7's per head width and heads a tile). No function in the library
    contains HMMA.16816: no kernel of the port is left on mma.sync. The
    fp32 flash kernels (B3 and B4/B5 on fp32, and B1/B2 on fp32 through them:
    the forward, dQ and dK/dV, an unmasked and a masked instantiation per
    head width, 16 to 104) run on wgmma at TF32
    (HGMMA ... TF32) and
    contain no HMMA at all; so do the fp32 LayerNorm GEMMs of B8 and B7
    (`ln_gemm_tf32_kernel`: B8's tile and B7's per head width and heads a
    tile at fp32), whose products are not on the CUDA cores: no FFMA
    between their first and last HGMMA (GELU's erff, in B8's epilogue,
    comes after). B6's forward and backward (one instantiation per width and
    row dtype, bf16 and fp32) copy their rows with the bulk copy
    (UBLKCP)."""
    import os
    import subprocess

    from vjepa2_tpu_torch import _build
    from vjepa2_tpu_torch.ops.ln_qkv import QKV_TILE_HEADS, QKV_TILE_HEADS_FP32

    _build.load()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    bodies = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        bodies[name.strip()] = body
    b7 = sum(len(heads) for heads in QKV_TILE_HEADS.values())
    instantiations = {"flash_fwd_bhnd_kernel": 5, "flash_bwd_bhnd_dkdv_kernel": 5,
                      "flash_bwd_bhnd_dq_kernel": 5, "flash_fwd_dn_kernel": 4,
                      "flash_bwd_dn_dkdv_kernel": 4, "flash_bwd_dn_dq_kernel": 4,
                      "ln_gemm_wgmma_kernel": 1 + b7, "11QkvEpilogueI": b7}
    for kernel, count in instantiations.items():
        found = {n: b for n, b in bodies.items() if kernel in n}
        assert len(found) == count, (kernel, sorted(found))
        for name, body in found.items():
            assert "HGMMA" in body, name
    assert not [n for n, b in bodies.items() if "HMMA.16816" in b]
    # the fp32 kernels: 7 widths (BHND's 32-104 and the DN route's 16 and 48,
    # which B1/B2 on fp32 operands take), each unmasked and masked (segment
    # ids or causal); dK/dV also D-major (the DN layout) at the DN widths
    for kernel, count in (("flash_fp32_fwd_kernel", 2 * 7), ("flash_fp32_dq_kernel", 2 * 7),
                          ("flash_fp32_dkdv_kernel", 2 * 7 + 2 * 4)):
        found = {n: b for n, b in bodies.items() if kernel in n}
        assert len(found) == count, (kernel, sorted(found))
        for name, body in found.items():
            assert any("HGMMA" in line and "TF32" in line for line in body.splitlines()), name
            assert "HMMA" not in body, name
    # the fp32 LayerNorm GEMMs: B8's tile and B7's fp32 tiles, on wgmma at TF32
    b7_fp32 = sum(len(heads) for heads in QKV_TILE_HEADS_FP32.values())
    found = {n: b for n, b in bodies.items() if "ln_gemm_tf32_kernel" in n}
    assert len(found) == 1 + b7_fp32, sorted(found)
    assert len([n for n in found if "QkvEpilogueF32" in n]) == b7_fp32
    for name, body in found.items():
        lines = body.splitlines()
        gmma = [i for i, line in enumerate(lines) if "HGMMA" in line]
        assert gmma and all("TF32" in lines[i] for i in gmma), name
        assert "HMMA" not in body, name
        assert not [line for line in lines[gmma[0]:gmma[-1]] if "FFMA" in line], name
    # B6's forward and backward stream their rows by bulk copy (cp.async.bulk:
    # UBLKCP), one instantiation per width and row dtype
    for kernel, count in (("ln_fwd_kernel", 8), ("ln_bwd_kernel", 8)):
        found = {n: b for n, b in bodies.items() if kernel in n}
        assert len(found) == count, (kernel, sorted(found))
        for name, body in found.items():
            assert "UBLKCP" in body, name
