"""The port's fused LayerNorm + qkv + RoPE (B7, `vjepa2_tpu_torch/ops/ln_qkv.py`)
on the CPU, where `ln_qkv` takes its plain version, against the JAX
package's `ln_qkv(..., interpret=True)`: the Pallas kernel in interpret mode
and its custom VJP `_core_bwd` (off the TPU, plain `ln_qkv` returns
`_xla_reference`, which autodiff differentiates, so only the interpret
route exercises `_core_bwd`).

Cases at B 2, N 24, C 128, H 2: no RoPE at D 32 and D 64; split-half tables
shared ([1, N, D]) and per example ([B, N, D], from masked positions), each
built by `expand_rope_cache` with the head permutation folded into the q/k
columns of W as the models fold it. Compared: q, k and v (and
`ln_qkv_plain`), and the gradients of x, gamma, beta, W and the bias for a
weighted sum of q, k and v; the RoPE tables get none (JAX returns zeros for
them).

The port's W is [3 H D, C], JAX's [C, 3 H D]: the test hands JAX the
transpose. Tolerance: fp32 on both sides, summation order only: atol 2e-5,
rtol 1e-4 on outputs and gradients of order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops import ln_qkv as jlnq
from vjepa2_tpu_torch.models.modules import qkv_row_perm
from vjepa2_tpu_torch.ops import ln_qkv as tlnq
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

B, N, C, H = 2, 24, 128, 2
ATOL, RTOL = 2e-5, 1e-4
CASES = [("none", 32), ("none", 64), ("shared", 64), ("per_example", 32), ("per_example", 64)]


def _inputs(D, rope, seed=0):
    """numpy x, gamma, beta, w [3HD, C] (q/k rows permuted under RoPE), bias,
    tables [B|1, N, D] or None, and the cotangents of q, k, v."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, C) * 1.5 + 0.3).astype(np.float32)
    gamma, beta = (rng.randn(C).astype(np.float32) for _ in range(2))
    w = (rng.randn(3 * H * D, C) / np.sqrt(C)).astype(np.float32)
    bias = rng.randn(3 * H * D).astype(np.float32)
    tables = None
    if rope != "none":
        if rope == "shared":
            pos = torch.arange(N)
        else:
            pos = torch.from_numpy(np.stack([np.sort(rng.permutation(4 * N)[:N])
                                             for _ in range(B)]))
        (cos, sin), perm = expand_rope_cache(build_rope_cache(pos, D, 4, 4), D)
        tables = (cos.numpy(), sin.numpy())
        w = w[qkv_row_perm(perm, H, D).numpy()]
        bias = bias[qkv_row_perm(perm, H, D).numpy()]
    dqkv = [rng.randn(B, H, N, D).astype(np.float32) for _ in range(3)]
    return x, gamma, beta, w, bias, tables, dqkv


@pytest.mark.parametrize("rope,D", CASES)
def test_ln_qkv_and_grads_match_jax_kernel(rope, D):
    x, gamma, beta, w, bias, tables, dqkv = _inputs(D, rope)

    def fwd_j(x, g, b, wt, bias, cos, sin):
        return jlnq.ln_qkv(x, g, b, wt, bias, rope=None if cos is None else (cos, sin),
                           num_heads=H, head_dim=D, interpret=True)

    j_args = [jnp.asarray(a) for a in (x, gamma, beta, w.T, bias)]
    cos_j, sin_j = (None, None) if tables is None else tuple(map(jnp.asarray, tables))
    outs_j, vjp = jax.vjp(lambda *a: fwd_j(*a, cos_j, sin_j), *j_args)
    outs_j = [np.asarray(o) for o in outs_j]
    grads_j = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, dqkv)))]
    if tables is not None:  # the tables' cotangents are zeros
        _, vjp_t = jax.vjp(lambda c, s: fwd_j(*j_args, c, s), cos_j, sin_j)
        assert all(not np.asarray(g).any() for g in vjp_t(tuple(map(jnp.asarray, dqkv))))

    xt, gt, bt, wt, biast = (torch.tensor(a, requires_grad=True)
                             for a in (x, gamma, beta, w, bias))
    rope_t = None
    if tables is not None:
        rope_t = tuple(torch.tensor(t, requires_grad=True) for t in tables)
    outs = tlnq.ln_qkv(xt, gt, bt, wt, biast, rope_t, num_heads=H, head_dim=D)
    sum(((o * torch.from_numpy(g)).sum() for o, g in zip(outs, dqkv))).backward()
    plain = tlnq.ln_qkv_plain(*map(torch.from_numpy, (x, gamma, beta, w, bias)),
                              None if tables is None else tuple(map(torch.from_numpy, tables)),
                              num_heads=H, head_dim=D)
    for name, got, p, want in zip("qkv", outs, plain, outs_j):
        assert got.shape == (B, H, N, D)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)
        assert torch.equal(got.detach(), p)
    got_grads = (xt.grad, gt.grad, bt.grad, wt.grad.T, biast.grad)
    for name, got, want in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got_grads, grads_j):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)
    if rope_t is not None:
        assert rope_t[0].grad is None and rope_t[1].grad is None


def test_two_dim_tables_broadcast_and_bad_shapes_raise():
    """[N, D] tables equal [1, N, D] ones; wrong shapes raise before any math."""
    x, gamma, beta, w, bias, tables, _ = _inputs(64, "shared", seed=1)
    args = [torch.from_numpy(a) for a in (x, gamma, beta, w, bias)]
    two_d = tuple(torch.from_numpy(t[0]) for t in tables)
    three_d = tuple(map(torch.from_numpy, tables))
    for a, b in zip(tlnq.ln_qkv(*args, two_d, num_heads=H, head_dim=64),
                    tlnq.ln_qkv(*args, three_d, num_heads=H, head_dim=64)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not fit"):
        tlnq.ln_qkv(*args, three_d, num_heads=H, head_dim=32)
    with pytest.raises(ValueError, match="rope tables"):
        tlnq.ln_qkv(*args, tuple(t[:, :-1] for t in three_d), num_heads=H, head_dim=64)
    with pytest.raises(ValueError, match="num_heads"):
        tlnq.ln_qkv(*args)
