"""The port's DN flash attention (B1) on the CPU, where the wrapper takes its
plain version, against the JAX package's Pallas kernel `_flash_fwd_bhdn` in
interpret mode (as `tests/ops/test_flash_dn.py` runs it): out and lse, over
{no RoPE, RoPE, RoPE + kv_valid, segments} at B2 H3 D{32,64} N256.

Tolerance: fp32 on both sides; the kernel works in base 2 with the scale
folded into q and a streaming softmax, the plain version in base e over the
whole row, so they agree to fp32 rounding: atol 2e-5, rtol 1e-4 (the JAX
kernel tests' own).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops.flash_attention_dn import _flash_fwd_bhdn
from vjepa2_tpu.ops.flash_attention_dn import flash_attention_bhdn as jax_flash_bhdn
from vjepa2_tpu_torch.ops import attention as tattn
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

B, H, N = 2, 3, 256
CASES = ["none", "rope", "rope_kv_valid", "segments"]


def _inputs(D, case, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, D, N).astype(np.float32) for _ in range(3))
    cos = rng.uniform(-1, 1, (1, N, D)).astype(np.float32)
    sin = rng.uniform(-1, 1, (1, N, D)).astype(np.float32)
    seg = np.sort(rng.randint(0, 5, (B, N)), axis=1).astype(np.int32)
    rope = (cos, sin) if case.startswith("rope") else None
    kv_valid = 199 if case == "rope_kv_valid" else None
    return q, k, v, rope, kv_valid, (seg if case == "segments" else None)


def _torch_kwargs(rope, kv_valid, seg):
    return dict(
        rope_expanded=None if rope is None else tuple(map(torch.from_numpy, rope)),
        kv_valid_len=kv_valid,
        segment_ids=None if seg is None else torch.from_numpy(seg))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_dn_fwd_matches_jax_kernel(case, D):
    q, k, v, rope, kv_valid, seg = _inputs(D, case)
    segq = segk = qcos = qsin = None
    if seg is not None:
        sf = jnp.asarray(seg.astype(np.float32))
        segq, segk = sf[:, None, :], sf[:, :, None]
    if rope is not None:  # the JAX kernel reads [1, D, N] tables
        qcos, qsin = (jnp.asarray(t.transpose(0, 2, 1)) for t in rope)
    out_j, lse_j = _flash_fwd_bhdn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segq, segk, qcos, qsin, qcos, qsin,
        block_q=128, block_k=64, interpret=True, kv_valid=kv_valid)

    out_t, lse_t = fdn.flash_attention_bhdn(
        *map(torch.from_numpy, (q, k, v)), return_lse=True, **_torch_kwargs(rope, kv_valid, seg))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, :, 0], atol=2e-5, rtol=1e-4)
    # the non-flash dispatch is the same plain math
    np.testing.assert_array_equal(
        tattn.attend_bhdn(*map(torch.from_numpy, (q, k, v)), use_flash=False,
                          rope_expanded=_torch_kwargs(rope, kv_valid, seg)["rope_expanded"],
                          kv_valid=kv_valid,
                          segment_ids=None if seg is None else torch.from_numpy(seg)).numpy(),
        out_t.numpy())


def test_cpu_plain_path_is_differentiable_like_the_jax_vjp():
    """The CPU route stays differentiable; its autograd gradients match the
    JAX package's custom VJP (the fused backward kernel B2, interpret mode)."""
    import jax

    q, k, v, rope, kv_valid, _ = _inputs(32, "rope_kv_valid", seed=3)
    w = np.random.RandomState(5).randn(B, H, 32, N).astype(np.float32)
    w[..., kv_valid:] = 0.0  # pad query columns carry no cotangent

    def loss_j(q, k, v):
        out = jax_flash_bhdn(q, k, v, rope_expanded=tuple(map(jnp.asarray, rope)),
                             kv_valid_len=kv_valid, block_q=128, block_k=64, interpret=True)
        return jnp.sum(out * w)

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = fdn.flash_attention_bhdn(qt, kt, vt, **_torch_kwargs(rope, kv_valid, None))
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)


def test_segment_ids_compare_as_integers():
    """Ids 2**24 and 2**24 + 1 are one fp32 value; the port compares the
    int32 ids exactly (the JAX package casts them to fp32,
    `flash_attention_dn.py:612` — ROADMAP queue C), so later-frame keys stay
    masked for earlier-frame queries."""
    D, n = 32, 64
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, D, n).astype(np.float32)) for _ in range(3))
    seg = np.full(n, 2**24, np.int64)
    seg[n // 2:] += 1
    out = fdn.flash_attention_bhdn(q, k, v, segment_ids=torch.from_numpy(seg).to(torch.int32))
    s = (q[0, 0].T @ k[0, 0]).numpy() / np.sqrt(D)
    s = np.where(seg[:, None] >= seg[None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v[0, 0].numpy().T
    np.testing.assert_allclose(out[0, 0].numpy().T, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("bad", ["head_width", "segments_and_kv_valid", "kv_valid_range",
                                 "table_shape", "mixed_devices"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    q, k, v = (torch.zeros(1, 2, 32, 64) for _ in range(3))
    kw = {}
    if bad == "head_width":
        q, k, v = (torch.zeros(1, 2, 80, 64) for _ in range(3))
    elif bad == "segments_and_kv_valid":
        kw = dict(segment_ids=torch.zeros(64, dtype=torch.int32), kv_valid_len=60)
    elif bad == "kv_valid_range":
        kw = dict(kv_valid_len=65)
    elif bad == "table_shape":
        kw = dict(rope_expanded=(torch.ones(1, 63, 32), torch.zeros(1, 63, 32)))
    elif bad == "mixed_devices":
        k = torch.zeros(1, 2, 32, 64, device="meta")
    with pytest.raises(ValueError):
        fdn.flash_attention_bhdn(q, k, v, **kw)
