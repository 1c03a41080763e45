"""The port's BHND flash attention on fp32 operands with the pretrain step's
features, RoPE and kv_valid, on the CPU, where the wrappers take their plain
versions, against the JAX package's B3/B4/B5 Pallas kernels in interpret
mode on the same fp32 inputs (JAX runs them in the operands' dtype,
`flash_attention.py:202`; its RoPE at `:208-211` and `_rope_rotate_t`, its
key mask at `:224-225`): split-half tables (``rope_expanded``) shared and
per example, ``kv_valid_len`` M - 1 and M - 5 (JAX's kernels take a
kv_valid within one key block of M), at head widths 32 and 64 (the ViT-L
predictor's and encoder's heads), B = 2, H = 2, N = 128 over JAX's 64-row
blocks: out and lse against `_flash_fwd_bhnd`, dq, dk, dv through
`torch.autograd` against `jax.vjp` of `flash_attention_bhnd`, and dk and dv
zero at and past kv_valid on both sides.

Tolerances, `tests/test_torch_flash_fp32.py`'s: fp32 on both sides, the
kernels in base 2 over 64-key blocks, the plain versions in base e over
whole rows: out and gradients within 1e-5 relative L2, lse within 1e-5
absolute. The CUDA kernels run these features in
`tests/test_torch_flash_fp32_cuda.py`; their 3xTF32 arithmetic is emulated
against the same JAX kernels in `tests/test_torch_flash_fp32_split.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu_torch.ops import flash_attention as fa

H = 2
REL_L2, LSE_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: 6 pytest workers with
    torch's default 8 threads each oversubscribe an 8-core host (see
    `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_result(fn, *arrays, **kw):
    """fn on copies of the numpy arrays, finished and fetched before the
    port's side runs (`tests/test_torch_flash_bhnd_bwd.py`)."""
    out = fn(*(jnp.array(a, copy=True) for a in arrays), **kw)
    return [np.array(o) for o in jax.block_until_ready(out)]


ROPE_B, ROPE_N = 2, 128


def _rope_inputs(D, per_example, kv_gap, seed):
    """numpy q, k, v, do [2, H, 128, D], split-half tables [B|1, 128, D]
    (uniform in [-1, 1], so the two slots of a pair differ as under the
    reference's tiled frequencies) and kv_valid = M - kv_gap."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(ROPE_B, H, ROPE_N, D).astype(np.float32) for _ in range(4))
    tb = ROPE_B if per_example else 1
    rope = tuple(rng.uniform(-1, 1, (tb, ROPE_N, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do, rope, ROPE_N - kv_gap


@pytest.mark.parametrize("kv_gap", [1, 5])
@pytest.mark.parametrize("per_example", [False, True])
@pytest.mark.parametrize("D", [32, 64])
def test_fp32_rope_kv_valid_match_jax_kernels(D, per_example, kv_gap):
    q, k, v, do, rope, kv = _rope_inputs(D, per_example, kv_gap, seed=D + kv_gap)

    def jax_side(q, k, v, do, cos, sin):
        out, lse = jfa._flash_fwd_bhnd(q, k, v, None, cos, sin, cos, sin, kv_valid=kv,
                                       block_q=64, block_k=64, interpret=True)
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bhnd(
            q, k, v, rope_expanded=(cos, sin), kv_valid_len=kv, block_q=64, block_k=64,
            interpret=True), q, k, v)
        return (out, lse, *vjp(do))

    out_j, lse_j, *grads_j = _jax_result(jax_side, q, k, v, do, *rope)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out_t, lse_t = fa.flash_attention_bhnd(*leaves, rope_expanded=tuple(map(torch.from_numpy,
                                                                             rope)),
                                           kv_valid_len=kv, return_lse=True)
    grads_t = torch.autograd.grad(out_t, leaves, torch.from_numpy(do))
    assert _rel(out_t.detach().numpy(), out_j) <= REL_L2
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=0, atol=LSE_ATOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= REL_L2, name
        if name != "dq":  # no gradient reaches the keys at or past kv_valid
            assert not g[:, :, kv:].any() and not np.asarray(w)[:, :, kv:].any(), name
