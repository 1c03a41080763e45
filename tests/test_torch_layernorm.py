"""The port's LayerNorm (B6, `vjepa2_tpu_torch/ops/layernorm.py`) on the CPU,
where `layer_norm` and `ln_backward` take their plain versions, against the
JAX package's `layer_norm` with its Pallas kernels in interpret mode and its
custom VJP (`_ln_core_bwd`, the backward kernel in interpret mode):

* the forward and the gradients of x, gamma and beta for a weighted sum of
  the output, at [2, 24, 128] and [3, 40, 256], and at the kernels' widths
  with ragged rows, [1003, 384] and [37, 1408], fp32;
* the plain formulas `ln_forward_f32` / `ln_backward_f32` against the JAX
  package's own, with their saved statistics;
* bf16 rows: the output in x's dtype, the gradients of a bf16 x in bf16, the
  statistics and the gamma/beta gradients in fp32.

Tolerance: fp32 on both sides, the same formulas summed in another order:
atol 2e-5, rtol 1e-4 (the JAX kernel tests' own). The bf16 case holds the
port's bf16 result to its own fp32 result within one bf16 rounding (2**-8
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops import layernorm as jln
from vjepa2_tpu_torch.ops import layernorm as tln

ATOL, RTOL = 2e-5, 1e-4


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    gamma = rng.randn(C).astype(np.float32)
    beta = rng.randn(C).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)  # cotangent of the output
    return x, gamma, beta, w


# the last two at the port's widths, with row counts no block size divides
@pytest.mark.parametrize("shape", [(2, 24, 128), (3, 40, 256), (1003, 384), (37, 1408)])
def test_layer_norm_and_grads_match_jax_kernels(shape):
    x, gamma, beta, w = _inputs(shape)

    def loss_j(x, g, b):
        return jnp.sum(jln.layer_norm(x, g, b, interpret=True) * w)

    out_j = np.asarray(jln.layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                      interpret=True))
    grads_j = [np.asarray(g) for g in jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))]

    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, gamma, beta))
    out = tln.layer_norm(xt, gt, bt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=ATOL, rtol=RTOL)
    for name, got, want in zip(("dx", "dgamma", "dbeta"), (xt.grad, gt.grad, bt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)


def test_plain_formulas_match_jax():
    x, gamma, beta, dy = _inputs((4, 16, 128), seed=1)
    y_j, mean_j, rstd_j = jln.ln_forward_f32(*map(jnp.asarray, (x, gamma, beta)), 1e-6)
    y, mean, rstd = tln.ln_forward_f32(*map(torch.from_numpy, (x, gamma, beta)), 1e-6)
    for got, want in ((y, y_j), (mean, mean_j), (rstd, rstd_j)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    bwd_j = jln.ln_backward_f32(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gamma), mean_j,
                                rstd_j)
    bwd = tln.ln_backward_f32(torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(gamma),
                              mean, rstd)
    for got, want in zip(bwd, bwd_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the dispatching backward runs the same formula on a CPU tensor
    for got, want in zip(tln.ln_backward(torch.from_numpy(x), torch.from_numpy(dy),
                                         torch.from_numpy(gamma), mean, rstd), bwd):
        assert torch.equal(got, want)


def test_bf16_rows_keep_their_dtype():
    x, gamma, beta, w = _inputs((2, 8, 128), seed=2)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    gt, bt = (torch.tensor(a, requires_grad=True) for a in (gamma, beta))
    out = tln.layer_norm(xb, gt, bt)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and gt.grad.dtype == torch.float32
    _, mean, rstd = tln.ln_forward(xb.detach(), gt.detach(), bt.detach())
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (2, 8, 1)
    want = tln.ln_forward_f32(xb.detach().float(), gt.detach(), bt.detach(), 1e-6)[0]
    np.testing.assert_allclose(out.detach().float().numpy(), want.numpy(), rtol=2**-8,
                               atol=2**-8 * np.abs(want.numpy()).max())
