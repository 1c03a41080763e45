"""The port's DN flash-attention backward (B2) on the CPU, where the wrappers
take their plain versions:

* `flash_attention_bhdn_bwd_plain` against the JAX package's backward
  `_flash_bwd_bhdn` with the Pallas kernel in interpret mode (as
  `tests/ops/test_flash_dn.py` runs it), both fed the same forward (out, lse)
  and cotangent: dq, dk and dv over {no RoPE, RoPE, RoPE + kv_valid 199,
  segments, RoPE tables per example} x D {32, 64} at B2 H3 N256;
* the port's `autograd.Function` against autograd through the plain forward.

Tolerance: fp32 on both sides; the kernel recomputes p in base 2 from the
forward's lse and sums per block, the plain version in base e over whole
rows, so they agree to fp32 rounding over a 256-long sum: atol 1e-5,
rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops.flash_attention_dn import _flash_bwd_bhdn, _flash_fwd_bhdn
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops.rope import rope_rotate

B, H, N = 2, 3, 256
CASES = ["none", "rope", "rope_kv_valid", "segments", "rope_per_example"]


def _inputs(D, case, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, D, N).astype(np.float32) for _ in range(4))
    tb = B if case == "rope_per_example" else 1
    rope = None
    if case.startswith("rope"):
        rope = tuple(rng.uniform(-1, 1, (tb, N, D)).astype(np.float32) for _ in range(2))
    kv_valid = 199 if case == "rope_kv_valid" else None
    seg = None
    if case == "segments":
        seg = np.sort(rng.randint(0, 5, (B, N)), axis=1).astype(np.int32)
    return q, k, v, do, rope, kv_valid, seg


def _torch_kwargs(rope, kv_valid, seg):
    return dict(
        rope_expanded=None if rope is None else tuple(map(torch.from_numpy, rope)),
        kv_valid_len=kv_valid,
        segment_ids=None if seg is None else torch.from_numpy(seg))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_dn_bwd_plain_matches_jax_kernel(case, D):
    q, k, v, do, rope, kv_valid, seg = _inputs(D, case)
    segq = segk = qcos = qsin = None
    if seg is not None:
        sf = jnp.asarray(seg.astype(np.float32))
        segq, segk = sf[:, None, :], sf[:, :, None]
    if rope is not None:  # the JAX kernels read [B|1, D, N] tables
        qcos, qsin = (jnp.asarray(t.transpose(0, 2, 1)) for t in rope)
    args = [jnp.asarray(t) for t in (q, k, v)] + [segq, segk, qcos, qsin, qcos, qsin]
    blocks = dict(block_q=128, block_k=64, interpret=True, kv_valid=kv_valid)
    out, lse = _flash_fwd_bhdn(*args, **blocks)
    grads_j = _flash_bwd_bhdn(*args, out, lse, jnp.asarray(do), **blocks)

    grads_t = fdn.flash_attention_bhdn_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(out), np.array(lse)[:, :, 0], do)),
        **_torch_kwargs(rope, kv_valid, seg))
    for name, got, want in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4,
                                   err_msg=f"d{name}")
    if kv_valid is not None:  # pad keys get no gradient
        assert not grads_t[1][..., kv_valid:].any() and not grads_t[2][..., kv_valid:].any()


@pytest.mark.parametrize("case", CASES)
def test_autograd_function_matches_autograd_through_plain(case):
    q, k, v, do, rope, kv_valid, seg = _inputs(32, case, seed=4)
    kw = _torch_kwargs(rope, kv_valid, seg)
    grads = []
    for fn in (fdn.flash_attention_bhdn, lambda *a, **kw: fdn.flash_attention_bhdn_plain(
            *a, **kw)[0]):
        qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        out = fn(qt, kt, vt, **kw)
        (out * torch.from_numpy(do)).sum().backward()
        grads.append((qt.grad, kt.grad, vt.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-4)


def test_fully_masked_rows_get_no_gradient():
    """A query whose lse is -inf (no key to attend) gets p = 0 and dq = 0,
    not NaN (`flash_attention_dn.py:347`)."""
    q, k, v, do, *_ = _inputs(32, "none", seed=6)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    out, lse = fdn.flash_attention_bhdn_plain(qt, kt, vt)
    lse[:, :, :5] = float("-inf")
    dq, dk, dv = fdn.flash_attention_bhdn_bwd(qt, kt, vt, out, lse, dot)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[..., :5].any()


def test_tables_with_n_equal_to_d_are_token_major():
    """With N == D a [B|1, N, D] table pair also fits [B|1, D, N]; the port
    reads it [N, D], as `expand_rope_cache` emits it, where the JAX rule
    (`flash_attention_dn.py:621`) reads it [D, N] (ROADMAP queue C). The
    flash route then matches attention on explicitly rotated q and k."""
    D = n = 32
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, D, n).astype(np.float32)) for _ in range(3))
    cos, sin = (torch.from_numpy(rng.uniform(-1, 1, (2, n, D)).astype(np.float32))
                for _ in range(2))
    out = fdn.flash_attention_bhdn(q, k, v, rope_expanded=(cos, sin))
    qr, kr = (rope_rotate(t.transpose(2, 3), cos[:, None], sin[:, None]).transpose(2, 3)
              for t in (q, k))
    want, _ = fdn.flash_attention_bhdn_plain(qr, kr, v)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=1e-4)
