"""The port's fused LayerNorm + fc1 + exact GELU (B8,
`vjepa2_tpu_torch/ops/ln_mlp.py`) on the CPU, where `ln_mlp` takes its plain
version, against the JAX package's `ln_mlp(..., interpret=True)`: the Pallas
kernel in interpret mode (its erf a polynomial, |err| <= 1.5e-7) and its
custom VJP `_core_bwd` (off the TPU, plain `ln_mlp` returns
`_xla_reference`, which autodiff differentiates).

Cases at B 2, N 24: (C, hidden) = (128, 256), (128, 512) and (256, 512),
with hidden tiled into 128- and 512-wide blocks on the JAX side. Compared: h
(and `ln_mlp_plain`), and the gradients of x, gamma, beta, W and the bias
for a weighted sum of h; the GELU formula against `torch.nn.functional.gelu`.

The port's W is [hidden, C], JAX's [C, hidden]: the test hands JAX the
transpose. Tolerance: fp32 on both sides; summation order and the kernel's
erf polynomial (1.5e-7 absolute, scaled by |z| <= ~10): atol 2e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vjepa2_tpu.ops import ln_mlp as jlnm
from vjepa2_tpu_torch.ops import ln_mlp as tlnm

B, N = 2, 24
ATOL, RTOL = 2e-5, 1e-4


def _inputs(C, hidden, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, C) * 1.5 - 0.2).astype(np.float32)
    gamma, beta = (rng.randn(C).astype(np.float32) for _ in range(2))
    w = (rng.randn(hidden, C) / np.sqrt(C)).astype(np.float32)
    bias = rng.randn(hidden).astype(np.float32)
    dh = rng.randn(B, N, hidden).astype(np.float32)
    return x, gamma, beta, w, bias, dh


@pytest.mark.parametrize("C,hidden,block_h", [(128, 256, 128), (128, 512, 512), (256, 512, 128)])
def test_ln_mlp_and_grads_match_jax_kernel(C, hidden, block_h):
    x, gamma, beta, w, bias, dh = _inputs(C, hidden)
    h_j, vjp = jax.vjp(lambda *a: jlnm.ln_mlp(*a, block_h=block_h, interpret=True),
                       *(jnp.asarray(a) for a in (x, gamma, beta, w.T, bias)))
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(dh))]

    xt, gt, bt, wt, biast = (torch.tensor(a, requires_grad=True)
                             for a in (x, gamma, beta, w, bias))
    h = tlnm.ln_mlp(xt, gt, bt, wt, biast)
    (h * torch.from_numpy(dh)).sum().backward()
    assert h.shape == (B, N, hidden)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), atol=ATOL, rtol=RTOL)
    plain = tlnm.ln_mlp_plain(*map(torch.from_numpy, (x, gamma, beta, w, bias)))
    assert torch.equal(h.detach(), plain)
    got = (xt.grad, gt.grad, bt.grad, wt.grad.T, biast.grad)
    for name, g, want in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got, grads_j):
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)


def test_gelu_is_exact():
    z = torch.linspace(-8, 8, 4001)
    torch.testing.assert_close(tlnm.gelu_exact(z), F.gelu(z), atol=1e-6, rtol=1e-6)


def test_bad_shapes_raise():
    x, gamma, beta, w, bias, _ = _inputs(128, 256, seed=1)
    args = [torch.from_numpy(a) for a in (x, gamma, beta, w, bias)]
    with pytest.raises(ValueError, match="do not fit"):
        tlnm.ln_mlp(args[0], args[1], args[2], args[3][:, :64], args[4])
    with pytest.raises(ValueError, match="gamma/beta"):
        tlnm.ln_mlp(args[0], args[1][:64], args[2], args[3], args[4])
