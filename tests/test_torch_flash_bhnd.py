"""The port's BHND flash attention forward (B3) on the CPU, where the wrapper
takes its plain version, against the JAX package's Pallas kernel in
interpret mode (as `tests/ops/test_flash_attention.py` runs it):

* out and lse against `_flash_fwd_bhnd` over {no RoPE, split-half tables
  shared and per example, RoPE + kv_valid, segments, token-causal, key-side
  segment ids with M != N (a ring hop)} at B2 H2 N128 D{80, 88};
* out against the public `flash_attention_bhnd` and the BNHD
  `flash_attention` with interleaved ``rope_tables`` (the wrapper's own
  expansion and head permutation) and with ``rope_expanded``;
* the split-half tables at Dh 80, 88 and 104: 78, 84 and 102 rotated
  features, the pass-through tail at cos 1 and sin 0, equal to the JAX
  package's;
* `attend`, `attend_bhnd` and `sdpa` with ``use_flash`` against the JAX
  package's plain dispatch of the same functions;
* integer segment ids above 2**24, segment arrays broadcast from [N] and
  [1, N], and the arguments the wrapper refuses.

Tolerance: fp32 on both sides; the kernel works in base 2 with the scale
folded into q and a streaming softmax over 64-key blocks, the plain version
in base e over the whole row, so they agree to fp32 rounding: atol 2e-5,
rtol 1e-4 (the JAX kernel tests' own).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops import attention as jattn
from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu.ops.rope import build_rope_cache as jax_rope_cache
from vjepa2_tpu_torch.ops import attention as tattn
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

B, H, N = 2, 2, 128
BLOCKS = dict(block_q=64, block_k=64, interpret=True)
CASES = ["none", "rope", "rope_per_example", "rope_kv_valid", "segments", "causal", "seg_kv"]
ATOL, RTOL = 2e-5, 1e-4


def _inputs(D, case, seed=0):
    """numpy (q, k, v, rope [B|1, N, D] pair, kv_valid, seg_q, seg_kv)."""
    rng = np.random.RandomState(seed)
    M = N + 64 if case == "seg_kv" else N
    q = rng.randn(B, H, N, D).astype(np.float32)
    k, v = (rng.randn(B, H, M, D).astype(np.float32) for _ in range(2))
    rope = None
    if case.startswith("rope"):
        tb = B if case == "rope_per_example" else 1
        rope = tuple(rng.uniform(-1, 1, (tb, N, D)).astype(np.float32) for _ in range(2))
    kv_valid = 101 if case == "rope_kv_valid" else None
    seg = seg_kv = None
    if case == "segments":
        seg = np.sort(rng.randint(0, 5, (B, N)), axis=1).astype(np.int32)
    if case == "seg_kv":  # every query sees key 0 (id 0 <= any query id)
        seg = np.sort(rng.randint(1, 6, (B, N)), axis=1).astype(np.int32)
        seg_kv = np.sort(rng.randint(0, 6, (B, M)), axis=1).astype(np.int32)
        seg_kv[:, 0] = 0
    return q, k, v, rope, kv_valid, seg, seg_kv


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("D", [80, 88])
@pytest.mark.parametrize("case", CASES)
def test_bhnd_fwd_matches_jax_kernel(case, D):
    q, k, v, rope, kv_valid, seg, seg_kv = _inputs(D, case)
    causal = case == "causal"
    cos = sin = None
    if rope is not None:
        cos, sin = map(_j, rope)
    out_j, lse_j = jfa._flash_fwd_bhnd(
        *map(_j, (q, k, v, seg)), cos, sin, cos, sin, seg_kv=_j(seg_kv), causal=causal,
        kv_valid=kv_valid, **BLOCKS)

    out_t, lse_t = fa.flash_attention_bhnd(
        *map(_t, (q, k, v)), segment_ids=_t(seg), seg_kv=_t(seg_kv), causal=causal,
        rope_expanded=None if rope is None else tuple(map(_t, rope)), kv_valid_len=kv_valid,
        return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", [80, 88])
@pytest.mark.parametrize("rope", ["tables", "expanded"])
def test_bhnd_api_matches_jax(rope, D):
    """The public wrappers: interleaved tables [B, N, rot] expanded and
    permuted inside, or split-half tables with q and k already permuted;
    kv_valid on; the BNHD `flash_attention` on the same operands."""
    q, k, v, *_ = _inputs(D, "none", seed=1)
    pos = np.stack([np.sort(np.random.RandomState(s).permutation(4 * N)[:N]) for s in range(B)])
    cache_t = build_rope_cache(torch.from_numpy(pos), D, 8, 8)
    kw_t = dict(rope_tables=cache_t)
    kw_j = dict(rope_tables=jax_rope_cache(jnp.asarray(pos), D, 8, 8))
    if rope == "expanded":
        expanded, perm = expand_rope_cache(cache_t, D)
        q, k = q[..., perm], k[..., perm]
        kw_t = dict(rope_expanded=expanded)
        kw_j = dict(rope_expanded=tuple(jnp.asarray(t.numpy()) for t in expanded))
    want = jfa.flash_attention_bhnd(*map(_j, (q, k, v)), kv_valid_len=120, **kw_j, **BLOCKS)
    got = fa.flash_attention_bhnd(*map(_t, (q, k, v)), kv_valid_len=120, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    if rope == "tables":
        bnhd = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]
        got = fa.flash_attention(*map(_t, bnhd), kv_valid_len=120, **kw_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D,rotated", [(80, 78), (88, 84), (104, 102)])
def test_split_half_tables_at_bhnd_widths(D, rotated):
    """`expand_rope_cache` at the BHND widths: the rotated features, then a
    pass-through tail at cos 1 and sin 0; tables and permutation equal the
    JAX package's."""
    pos = np.arange(64)
    (cos, sin), perm = expand_rope_cache(build_rope_cache(torch.from_numpy(pos), D, 4, 4), D)
    (cos_j, sin_j), perm_j = jfa.expand_rope_cache(jax_rope_cache(jnp.asarray(pos), D, 4, 4), D)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), atol=1e-6)
    assert [int(i) for i in perm] == [int(i) for i in perm_j]
    h = rotated // 2
    tail = np.r_[h:D // 2, D // 2 + h:D]  # the slots past each rotated half
    assert len(tail) == D - rotated
    assert (cos[..., tail] == 1).all() and (sin[..., tail] == 0).all()
    assert (sin[..., :h] != 0).any() and (sin[..., D // 2:D // 2 + h] != 0).any()


@pytest.mark.parametrize("D", [80, 88])
def test_attend_dispatch_matches_jax(D):
    """`attend` (BNHD, interleaved RoPE, frame-causal segments) and
    `attend_bhnd` (BHND, split-half tables with the head permutation,
    kv_valid) with ``use_flash`` on the CPU: the kernel's plain version,
    against the JAX functions' plain dispatch on the same inputs."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(B, N, H, D).astype(np.float32) for _ in range(3))
    pos = np.arange(N)
    seg = (pos // 64).astype(np.int32)  # two frames
    cache_j = jax_rope_cache(jnp.asarray(pos), D, 8, 8)
    cache_t = build_rope_cache(torch.from_numpy(pos), D, 8, 8)
    want = jattn.attend(*map(_j, (q, k, v)), rope_cache=cache_j, segment_ids=_j(seg))
    got = tattn.attend(*map(_t, (q, k, v)), rope_cache=cache_t, segment_ids=_t(seg),
                       use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    expanded_j, perm_j = jfa.expand_rope_cache(cache_j, D)
    expanded_t, perm = expand_rope_cache(cache_t, D)
    qb, kb, vb = (a.transpose(0, 2, 1, 3) for a in (q, k, v))
    want = jattn.attend_bhnd(*map(_j, (qb, kb, vb)), rope_expanded=expanded_j,
                             head_perm=tuple(int(i) for i in perm_j), kv_valid=100)
    got = tattn.attend_bhnd(*map(_t, (qb, kb, vb)), rope_expanded=expanded_t, head_perm=perm,
                            use_flash=True, kv_valid=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", [80, 72])
def test_sdpa_flash_route_matches_jax(D):
    """`sdpa(use_flash=True)` routes to the kernel's wrapper at any width:
    on these CPU tensors its plain version runs, which is not a launch (on a
    CUDA tensor Dh 72, which no kernel takes, raises); both widths agree
    with the JAX `sdpa`."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(B, N, H, D).astype(np.float32) for _ in range(3))
    before = fa.LAUNCHES
    got = tattn.sdpa(*map(_t, (q, k, v)), use_flash=True)
    assert fa.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.sdpa(*map(_j, (q, k, v)))),
                               atol=ATOL, rtol=RTOL)


def test_segment_ids_compare_as_integers():
    """Ids 2**24 and 2**24 + 1 are one fp32 value; the port compares the
    int32 ids exactly (the JAX package casts them to fp32,
    `flash_attention.py:291` — ROADMAP queue C), so later-frame keys stay
    masked for earlier-frame queries."""
    D, n = 80, 64
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, n, D).astype(np.float32)) for _ in range(3))
    seg = np.full(n, 2**24, np.int64)
    seg[n // 2:] += 1
    out = fa.flash_attention_bhnd(q, k, v, segment_ids=torch.from_numpy(seg).to(torch.int32))
    s = (q[0, 0] @ k[0, 0].T).numpy() / np.sqrt(D)
    s = np.where(seg[:, None] >= seg[None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v[0, 0].numpy()
    np.testing.assert_allclose(out[0, 0].numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", ["n", "1n"])
def test_shared_segment_ids_broadcast_to_the_batch(shape):
    """A [N] or [1, N] segment array is broadcast to [B, N] explicitly,
    not read through a clamped block index (ADVICE r5 on
    `flash_attention.py:1122`): every example gets the same mask."""
    q, k, v, *_ = _inputs(80, "none", seed=2)
    seg = np.sort(np.random.RandomState(3).randint(0, 4, N)).astype(np.int32)
    ids = seg if shape == "n" else seg[None]
    got = fa.flash_attention_bhnd(*map(_t, (q, k, v)), segment_ids=_t(ids))
    want = fa.flash_attention_bhnd(*map(_t, (q, k, v)),
                                   segment_ids=_t(np.broadcast_to(seg, (B, N)).copy()))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bad", ["segments_and_causal", "kv_valid_range", "table_shape",
                                 "seg_kv_alone", "cross_without_seg_kv", "float_segments",
                                 "segment_batch"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    q, k, v = (torch.zeros(2, 2, 64, 80) for _ in range(3))
    seg = torch.zeros(64, dtype=torch.int32)
    kw = {}
    if bad == "segments_and_causal":
        kw = dict(segment_ids=seg, causal=True)
    elif bad == "kv_valid_range":
        kw = dict(kv_valid_len=65)
    elif bad == "table_shape":
        kw = dict(rope_expanded=(torch.ones(1, 63, 80), torch.zeros(1, 63, 80)))
    elif bad == "seg_kv_alone":
        kw = dict(seg_kv=seg)
    elif bad == "cross_without_seg_kv":
        k, v = torch.zeros(2, 2, 96, 80), torch.zeros(2, 2, 96, 80)
        kw = dict(segment_ids=seg)
    elif bad == "float_segments":
        kw = dict(segment_ids=seg.float())
    elif bad == "segment_batch":
        kw = dict(segment_ids=torch.zeros(3, 64, dtype=torch.int32))
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention_bhnd(q, k, v, **kw)
