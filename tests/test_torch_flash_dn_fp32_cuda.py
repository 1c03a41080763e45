"""B1 and B2 on fp32 operands (`flash_attention_bhdn` on fp32 [B, H, D, N]
tensors: the 3xTF32 kernels of `vjepa2_tpu_torch/csrc/flash_fp32.cuh`, whose
split pre-pass reads the DN layout in place and whose epilogues store out,
dq, dk and dv D-major) against their plain PyTorch versions on the card
(TF32 off): head widths 16, 32, 48 and 64 at ragged N (64, 100, 200), RoPE
tables shared ([N, D] and [D, N]), per example and at N == D, kv_valid,
frame-causal ids with the pad keys on int32-max, ids 2**24 and 2**24 + 1
(which must stay apart), rows with no key (out 0, lse -inf, no gradient),
q, k and v as strided views of one [B, 3 * dim, N] projection output read
in place (a cotangent unit-stride along d, as autograd hands it over from
the output projection), the DN call against the same kernels on the same
data laid out [B, H, N, D] (equal bits: the layouts share the split copies
and the mainloops), and `Attention` at fp32 on the card taking the DN route
at heads of 16-64, forward and backward.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_dn_fp32_cuda.py -q

Tolerances, those of `chip_smoke.py`'s phase kernel_fp32: fp32 on both
sides, the kernel summing three TF32 products a tile with an online
rescale, the plain version whole rows through cuBLAS: out and gradients
within 2e-5 relative L2 and 1e-4 x max|plain| absolute, lse within 1e-5
absolute; dk and dv exactly zero past kv_valid.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bhnd_fp32
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

pytestmark = pytest.mark.cuda

REL_L2, MAX_ABS, LSE_ATOL = 2e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)


def _tables(N, D, dev, per_example=0):
    pos = torch.arange(N, device=dev)
    (cos, sin), _ = expand_rope_cache(build_rope_cache(pos, D, 16, 16), D)
    if per_example:  # a table per batch element
        cos, sin = (torch.cat([t, t.flip(1)][:per_example]) for t in (cos, sin))
    return cos, sin


def _close(got, want, name):
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all(), name
    rel = ((got - want).norm() / want.norm()).item()
    err = (got - want).abs().max().item()
    assert rel <= REL_L2 and err <= MAX_ABS * want.abs().max().item(), (name, rel, err)


def _lse_close(lse, want):
    empty = torch.isneginf(want)
    assert torch.equal(torch.isneginf(lse), empty)
    if (~empty).any():
        assert (lse - want)[~empty].abs().max().item() <= LSE_ATOL


def _frame_ids(B, N, frames, pad, base=0):
    """Frame-causal ids [B, N] int32: ``frames`` frames of about equal length
    (ids from ``base``), then ``pad`` tokens on int32-max (the stack pad's
    keys)."""
    real = torch.arange(N - pad) * frames // (N - pad) + base
    seg = torch.cat([real, torch.full((pad,), tm.PAD_SEGMENT)]).to(torch.int32)
    return seg[None].repeat(B, 1)


def _features(feature, B, D, N, dev):
    kw = {}
    if feature.startswith("rope"):
        cos, sin = _tables(N, D, dev, B if feature == "rope_per_example" else 0)
        if feature == "rope_dn_tables":  # [1, D, N]: the tables' other layout
            cos, sin = cos.transpose(1, 2).contiguous(), sin.transpose(1, 2).contiguous()
        kw["rope_expanded"] = (cos, sin)
    if feature == "kv_valid":
        kw["kv_valid_len"] = N - 37
    if feature == "frame_causal":
        kw["segment_ids"] = _frame_ids(B, N, 3, N % 8 or 4).to(dev)
    if feature == "ids_2p24":  # one fp32 value, two frames
        kw["segment_ids"] = _frame_ids(B, N, 2, 0, base=2**24).to(dev)
    return kw


def _run(q, k, v, do, **kw):
    """The DN wrapper's forward (out, lse) and its gradients given do, with
    the fp32 launch counters' increments."""
    before = (fdn.LAUNCHES_FP32, fdn.LAUNCHES_BWD_FP32, fa.LAUNCHES_FP32, fdn.LAUNCHES)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = fdn.flash_attention_bhdn(*leaves, return_lse=True, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = (fdn.LAUNCHES_FP32, fdn.LAUNCHES_BWD_FP32, fa.LAUNCHES_FP32, fdn.LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)
    return out.detach(), lse, grads


def _check(q, k, v, do, **kw):
    out, lse, grads = _run(q, k, v, do, **kw)
    want_out, want_lse = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
    want = fdn.flash_attention_bhdn_bwd_plain(q, k, v, out, lse, do, **kw)
    _close(out, want_out, "out")
    _lse_close(lse, want_lse)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(g, w, name)
    kv = kw.get("kv_valid_len")
    if kv is not None:  # pad keys get no gradient, exactly
        assert not grads[1][..., kv:].any() and not grads[2][..., kv:].any()
    return out, lse, grads


@pytest.mark.parametrize("D", [16, 32, 48, 64])
@pytest.mark.parametrize("N", [64, 100, 200])
@pytest.mark.parametrize("feature", ["none", "rope", "rope_dn_tables", "rope_per_example",
                                     "kv_valid", "frame_causal"])
def test_fp32_dn_matches_plain(dev, D, N, feature):
    B, H = 2, 3
    q, k, v, do = (_randn((B, H, D, N), dev, s) for s in range(4))
    _check(q, k, v, do, **_features(feature, B, D, N, dev))


@pytest.mark.parametrize("D", [16, 48])
def test_fp32_dn_tables_at_n_equal_d(dev, D):
    """N == D: the tables [N, D] are read as [N, D] (`_normalize`)."""
    q, k, v, do = (_randn((2, 2, D, D), dev, s) for s in range(4))
    _check(q, k, v, do, rope_expanded=_tables(D, D, dev))


def test_fp32_dn_ids_past_2_24_stay_apart(dev):
    """Ids 2**24 and 2**24 + 1 (one fp32 value): the second frame's keys stay
    masked for the first frame's queries."""
    q, k, v, do = (_randn((2, 2, 64, 128), dev, s) for s in range(4))
    _check(q, k, v, do, **_features("ids_2p24", 2, 64, 128, dev))


def test_fp32_dn_layout_rows_with_no_key(dev):
    """The DN wrapper's one id vector lets every query attend itself, so a
    row with no key comes only with key-side ids of their own, which the
    launch functions take: on the DN layout (D-major stores) such rows give
    out 0, lse -inf and dq 0, the others the BHND plain version's values."""
    B, H, D, N = 2, 2, 48, 150
    q, k, v, do = (_randn((B, H, D, N), dev, s) for s in range(4))
    seg_q = torch.ones(B, N, dtype=torch.int32, device=dev)
    seg_q[:, :5] = 0
    seg_k = torch.ones(B, N, dtype=torch.int32, device=dev)
    side = (None, None, (0, 0, 1), N, seg_q, seg_k, (N, N), False)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), device=dev)
    fa.fp32_forward(*(t.transpose(2, 3) for t in (q, k, v, out)), lse, None, *side)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fa.fp32_backward(*(t.transpose(2, 3) for t in (q, k, v, out)), lse, do.transpose(2, 3), dq,
                     dk, dv, True, None, *side)
    torch.cuda.synchronize()
    qb, kb, vb = (t.transpose(2, 3) for t in (q, k, v))
    kw = {"segment_ids": seg_q, "seg_kv": seg_k}
    want_out, want_lse = fa.flash_attention_bhnd_plain(qb, kb, vb, **kw)
    want = fa.flash_attention_bhnd_bwd_plain(qb, kb, vb, out.transpose(2, 3), lse,
                                             do.transpose(2, 3), **kw)
    assert not out[..., :5].any() and torch.isneginf(lse[..., :5]).all() and not dq[..., :5].any()
    _lse_close(lse, want_lse)
    _close(out, want_out.transpose(2, 3), "out")
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close(g, w.transpose(2, 3), name)


def _strided_qkv(B, H, D, N, dev, seed=5):
    """q, k, v as views of one [B, 3 * H * D, N] buffer (the DN route's qkv
    projection output): unit stride along N, d stride N (not a multiple of 4
    when N % 4)."""
    y = _randn((B, 3 * H * D, N), dev, seed)
    return y.view(B, 3, H, D, N).unbind(1)


@pytest.mark.parametrize("D", [16, 48, 64])
@pytest.mark.parametrize("N", [99, 200])
def test_fp32_dn_reads_strided_views_in_place(dev, D, N):
    """q, k, v as views of one projection output with RoPE, and a cotangent
    unit-stride along d (autograd's, from the output projection): read in
    place, no copy of them taken."""
    B, H = 2, 3
    q, k, v = _strided_qkv(B, H, D, N, dev)
    assert not q.is_contiguous()
    do = _randn((B, N, H, D), dev, 9).permute(0, 2, 3, 1)  # [B, H, D, N], unit along d
    assert do.stride(2) == 1
    for t in (q, k, v, do):
        assert fa.split_operand(t.transpose(2, 3)).data_ptr() == t.data_ptr()
    _check(q, k, v, do, rope_expanded=_tables(N, D, dev))


@pytest.mark.parametrize("D", [16, 32, 48, 64])
@pytest.mark.parametrize("feature", ["rope_per_example", "kv_valid", "frame_causal"])
def test_fp32_dn_equals_the_bhnd_kernels(dev, D, feature):
    """The DN call and the same kernels on the same data laid out [B, H, N, D]
    (`chip_smoke.bhnd_fp32`, the BHND layout's launches, which take every
    width the kernels have) give equal bits, forward and backward: both
    layouts split the same values
    into the same copies, run the same mainloops, sum delta in the same
    order and store the same values."""
    B, H, N = 2, 3, 200
    q, k, v, do = (_randn((B, H, D, N), dev, s) for s in range(4))
    kw = _features(feature, B, D, N, dev)
    out, lse, grads = _run(q, k, v, do, **kw)
    qc, kc, vc, doc, oc = (t.transpose(2, 3).contiguous() for t in (q, k, v, do, out))
    out_b, lse_b = bhnd_fp32(qc, kc, vc, kw)
    grads_b = bhnd_fp32(qc, kc, vc, kw, (oc, lse, doc))
    torch.cuda.synchronize()
    assert torch.equal(out, out_b.transpose(2, 3)) and torch.equal(lse, lse_b)
    for g, gb in zip(grads, grads_b):
        assert torch.equal(g, gb.transpose(2, 3))


def test_fp32_dn_is_deterministic(dev):
    q, k, v, do = (_randn((2, 3, 64, 250), dev, s) for s in range(4))
    kw = {"rope_expanded": _tables(250, 64, dev), "kv_valid_len": 247}
    first, second = _run(q, k, v, do, **kw), _run(q, k, v, do, **kw)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert all(torch.equal(a, b) for a, b in zip(first[2], second[2]))


@pytest.mark.parametrize("heads,D", [(8, 16), (4, 48), (12, 32), (16, 64)])
def test_fp32_attention_takes_the_dn_route(dev, heads, D):
    """An fp32 `Attention` with RoPE, per-example tables and kv_valid and
    ``use_flash`` on the card (a model that builds at heads of 16 or 48 runs
    too): the DN route's fp32 kernels, forward and backward, against the
    plain route with the interleaved tables on the same weights."""
    dim, N, kv = heads * D, 176, 173
    flash = tm.Attention(dim, heads, use_rope=True, use_flash=True, device=dev)
    flash.reset_parameters(torch.Generator(dev).manual_seed(0))
    plain = tm.Attention(dim, heads, use_rope=True, device=dev)
    plain.load_state_dict(flash.state_dict())
    rng = np.random.RandomState(D)
    pos = torch.from_numpy(np.stack([np.sort(rng.choice(2048, N, replace=False))
                                     for _ in range(2)])).to(dev)
    cache = build_rope_cache(pos, D, 16, 16)
    expanded, perm = expand_rope_cache(cache, D)
    x = _randn((2, N, dim), dev, 1)
    counts = lambda: (fdn.LAUNCHES_FP32, fdn.LAUNCHES_BWD_FP32, fa.LAUNCHES_FP32,  # noqa: E731
                      fa.LAUNCHES_BWD_FP32)
    before = counts()
    outs, grads = [], []
    for m, kw in ((flash, dict(rope_expanded=expanded,
                               qkv_perm=tm.qkv_row_perm(perm, heads, D, dev))),
                  (plain, dict(rope_cache=cache))):
        xi = x.clone().requires_grad_()
        y = m(xi, kv_valid=kv, **kw)[:, :kv]
        outs.append(y)
        grads.append(torch.autograd.grad(y, xi, torch.ones_like(y))[0])
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0, 0)
    _close(outs[0], outs[1], "out")
    _close(grads[0], grads[1], "dx")
