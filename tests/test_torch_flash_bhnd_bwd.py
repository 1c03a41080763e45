"""The port's BHND flash-attention backward on the CPU, where the wrappers
take their plain versions, against both backwards of the JAX package with the
Pallas kernels in interpret mode: the one-pass `_bwd_fused_kernel` (B4) and
the two-pass `_dq_kernel` / `_dkv_kernel` (B5). `_flash_bwd_bhnd` picks
between them by ``_FUSED_BWD`` and a scoped-VMEM gate that passes at these
shapes; the flag is set per test with ``monkeypatch`` and the jit caches
cleared around it (`_flash_bwd_bhnd` reads it at trace time), as
`tests/ops/test_flash_attention.py` does. The port has one backward for both.

* gradients of a weighted sum of the output, port autograd through
  `FlashAttentionBHND` against `jax.grad` through `flash_attention_bhnd`,
  over {interleaved RoPE tables, split-half tables + kv_valid, segments,
  token-causal} x D {80, 88} x {B4, B5} at B2 H2 N128;
* a ring hop's backward: no RoPE, key-side ids with M != N, and a given
  global lse, `flash_attention_bhnd_bwd` against `_flash_bwd_bhnd`;
* the port's `autograd.Function` against autograd through its plain
  forward, and rows with no key.

Tolerance: fp32 on both sides; the kernels recompute p in base 2 from the
forward's lse and sum per 64-wide block, the plain version in base e over
whole rows: atol 2e-5, rtol 1e-4 on gradients of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu.ops.rope import build_rope_cache as jax_rope_cache
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops.rope import build_rope_cache

B, H, N = 2, 2, 128
BLOCKS = dict(block_q=64, block_k=64, interpret=True)
CASES = ["rope_tables", "rope_kv_valid", "segments", "causal"]
ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(params=[True, False], ids=["B4_fused", "B5_two_pass"])
def fused_bwd(request, monkeypatch):
    monkeypatch.setattr(jfa, "_FUSED_BWD", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def _jax_result(fn, *arrays, **kw):
    """fn on copies of the numpy arrays, finished and fetched as numpy before
    the port's side runs: the two frameworks share no buffer and never
    compute at once."""
    out = fn(*(jnp.array(a, copy=True) for a in arrays), **kw)
    return [np.array(o) for o in jax.block_until_ready(out)]


def _inputs(D, seed=0, M=N):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, M, D).astype(np.float32) for _ in range(2))
    return q, k, v, do, rng


def _kwargs(case, D, rng):
    """(port kwargs, JAX kwargs) for one case."""
    if case == "rope_tables":
        pos = np.arange(N)
        return (dict(rope_tables=build_rope_cache(torch.from_numpy(pos), D, 8, 8)),
                dict(rope_tables=jax_rope_cache(jnp.asarray(pos), D, 8, 8)))
    if case == "rope_kv_valid":
        cos, sin = (rng.uniform(-1, 1, (B, N, D)).astype(np.float32) for _ in range(2))
        return (dict(rope_expanded=(torch.from_numpy(cos), torch.from_numpy(sin)),
                     kv_valid_len=101),
                dict(rope_expanded=(jnp.asarray(cos), jnp.asarray(sin)), kv_valid_len=101))
    if case == "segments":
        seg = np.sort(rng.randint(0, 5, (B, N)), axis=1).astype(np.int32)
        return dict(segment_ids=torch.from_numpy(seg)), dict(segment_ids=jnp.asarray(seg))
    return dict(causal=True), dict(causal=True)


@pytest.mark.parametrize("D", [80, 88])
@pytest.mark.parametrize("case", CASES)
def test_bhnd_grads_match_jax_vjp(case, D, fused_bwd):
    q, k, v, w, rng = _inputs(D)
    kw_t, kw_j = _kwargs(case, D, rng)
    if case == "rope_kv_valid":
        w[:, :, 101:] = 0.0  # pad query rows carry no cotangent

    def loss_j(q, k, v):
        out = jfa.flash_attention_bhnd(q, k, v, bwd_block_q=64, bwd_block_k=64, **kw_j,
                                       **BLOCKS)
        return jnp.sum(out * w)

    grads_j = _jax_result(jax.grad(loss_j, argnums=(0, 1, 2)), q, k, v)
    qt, kt, vt = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    (fa.flash_attention_bhnd(qt, kt, vt, **kw_t) * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("D", [80, 88])
def test_ring_hop_backward_matches_jax(D, fused_bwd):
    """A ring hop's backward (`ring_attention.py:91-104`): this hop's keys
    carry their own segment ids (M != N) and the lse is the global one of
    the whole ring, not this hop's; the out passed in is the ring's too."""
    M = N + 64
    q, k, v, do, rng = _inputs(D, seed=1, M=M)
    seg = np.sort(rng.randint(1, 6, (B, N)), axis=1).astype(np.int32)
    seg_kv = np.sort(rng.randint(0, 6, (B, M)), axis=1).astype(np.int32)
    seg_kv[:, 0] = 0  # every query sees at least one key of this hop
    out, lse = fa.flash_attention_bhnd_plain(
        *map(torch.from_numpy, (q, k, v)), segment_ids=torch.from_numpy(seg),
        seg_kv=torch.from_numpy(seg_kv))
    lse_global = torch.logaddexp(lse, torch.from_numpy(rng.randn(B, H, N).astype(np.float32)))
    out_global = out * torch.exp(lse - lse_global)[..., None]

    grads_j = _jax_result(
        lambda q, k, v, seg, out, lse, do, seg_kv: jfa._flash_bwd_bhnd(
            q, k, v, seg, None, None, None, None, out, lse, do, seg_kv=seg_kv, **BLOCKS),
        q, k, v, seg, out_global.numpy(), lse_global.numpy(), do, seg_kv)
    grads_t = fa.flash_attention_bhnd_bwd(
        *map(torch.from_numpy, (q, k, v)), out_global, lse_global, torch.from_numpy(do),
        segment_ids=torch.from_numpy(seg), seg_kv=torch.from_numpy(seg_kv))
    for name, got, want in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_autograd_function_matches_autograd_through_plain(case):
    q, k, v, do, rng = _inputs(80, seed=4)
    kw, _ = _kwargs(case, 80, rng)
    grads = []
    for fn in (fa.flash_attention_bhnd,
               lambda *a, **kw: fa.flash_attention_bhnd_plain(*a, **kw)[0]):
        qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        (fn(qt, kt, vt, **kw) * torch.from_numpy(do)).sum().backward()
        grads.append((qt.grad, kt.grad, vt.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def test_rows_without_keys_get_no_gradient():
    """A query whose segment id is below every key's has no key to attend:
    output 0, lse -inf, and p = 0 in the backward, so dq = 0 and nothing is
    NaN (the TPU kernel's finite -1e30 mask averages v instead)."""
    q, k, v, do, _ = _inputs(88, seed=6)
    seg_q = np.ones((B, N), np.int32)
    seg_q[:, :10] = 0
    seg_k = np.ones((B, N), np.int32)
    kw = dict(segment_ids=torch.from_numpy(seg_q), seg_kv=torch.from_numpy(seg_k))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_attention_bhnd(qt, kt, vt, return_lse=True, **kw)
    assert not out[:, :, :10].any() and torch.isneginf(lse[:, :, :10]).all()
    dq, dk, dv = fa.flash_attention_bhnd_bwd(qt, kt, vt, out, lse, dot, **kw)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[:, :, :10].any()
