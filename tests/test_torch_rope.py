"""RoPE tables of the PyTorch port against the JAX package: the interleaved
cache (`ops/rope.py:122 build_rope_cache`), the split-half expansion and its
head permutation (`ops/flash_attention.py:919-973`), at Dh 32 and 64.

Tolerance: both sides compute the same fp32 angles; pow/sin/cos may differ
by an ulp between the two libraries, and angles reach ~60 rad here, so the
tables are held to 1e-5 absolute. The permutation must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu.ops import rope as jrope
from vjepa2_tpu_torch.ops import rope

T, HP, WP = 3, 4, 5

# one compiled program per case instead of op-by-op dispatch (quicker on the CPU)
_jax_cache = jax.jit(jrope.build_rope_cache, static_argnums=(1, 2, 3),
                     static_argnames=("grid_size",))
_jax_expand = jax.jit(jfa.expand_rope_cache, static_argnums=(1,))


def _pos(batched: bool) -> np.ndarray:
    n = T * HP * WP
    if not batched:
        return np.arange(n, dtype=np.int32)
    rng = np.random.RandomState(0)
    return np.stack([np.sort(rng.choice(n, 40, replace=False)) for _ in range(2)]).astype(np.int32)


@pytest.mark.parametrize("head_dim,batched,grid_size",
                         [(32, False, None), (64, False, None), (64, True, 16)])
def test_rope_cache_and_splithalf_match_jax(head_dim, batched, grid_size):
    pos = _pos(batched)
    assert rope.rope_3d_dims(head_dim) == jrope.rope_3d_dims(head_dim)
    cache_j = _jax_cache(jnp.asarray(pos), head_dim, HP, WP, grid_size=grid_size)
    cache_t = rope.build_rope_cache(torch.from_numpy(pos), head_dim, HP, WP, grid_size=grid_size)
    for a, b in zip(cache_t, cache_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)

    (cos_j, sin_j), perm_j = _jax_expand(cache_j, head_dim)
    (cos_t, sin_t), perm_t = rope.expand_rope_cache(cache_t, head_dim)
    np.testing.assert_array_equal(perm_t, np.asarray(perm_j))
    assert cos_t.dtype == sin_t.dtype == torch.float32
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_splithalf_rotation_is_the_permuted_interleaved_rotation(head_dim):
    """Rotating permuted features with the split-half tables equals the JAX
    interleaved rotation (`apply_rope_cache`) followed by the permutation:
    the identity the flash route relies on."""
    pos = _pos(False)
    rng = np.random.RandomState(1)
    x = rng.randn(2, pos.size, 3, head_dim).astype(np.float32)  # [B, N, H, D]
    want = np.asarray(jax.jit(jrope.apply_rope_cache)(
        jnp.asarray(x), _jax_cache(jnp.asarray(pos), head_dim, HP, WP)))
    (cos, sin), perm = rope.expand_rope_cache(
        rope.build_rope_cache(torch.from_numpy(pos), head_dim, HP, WP), head_dim)
    got = rope.rope_rotate(torch.from_numpy(x[..., perm]), cos[:, :, None], sin[:, :, None])
    np.testing.assert_allclose(got.numpy(), want[..., perm], atol=1e-5, rtol=1e-5)
