"""The port's blocks against the flax modules of the JAX package, with the
same weights (crossed by `hub.converter.state_dict_from_flax`) and the same
numpy-seeded inputs: LayerNorm, Mlp, Attention (DN, BHND and plain routes),
Block and CrossAttentionBlock. The flash routes run the JAX Pallas kernels
in interpret mode (`pltpu.force_tpu_interpret_mode()`, as
`tests/models/test_flash_integration.py` does) and the port's plain versions.

Tolerance: fp32 throughout; the routes differ only in summation order and in
base-2 against base-e softmax: atol 2e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vjepa2_tpu.models import modules as jm
from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu.ops.rope import build_rope_cache as jax_rope_cache
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

B, N, DIM = 2, 32, 64
HP = WP = 4  # N = 2 frames x 4 x 4


def _x(seed=0, n=N):
    return np.random.RandomState(seed).randn(B, n, DIM).astype(np.float32)


def _init_apply(module, *args, init_module=None, **kwargs):
    """(params, output) of a flax module, each step one jitted program
    (far quicker on the CPU than op-by-op dispatch). ``init_module``, a twin
    with the same parameter tree, initialises without running the kernel."""
    init = init_module or module
    params = jax.jit(lambda *a: init.init(jax.random.PRNGKey(0), *a))(*args)
    out = jax.jit(lambda p, *a: module.apply(p, *a, **kwargs))(params, *args)
    return params["params"], out


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(params))
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def _tables(head_dim):
    """Port tables (interleaved cache, split-half tables, qkv row order) and
    the JAX ones, each built by its own package."""
    pos = np.arange(N)
    cache_t = build_rope_cache(torch.from_numpy(pos), head_dim, HP, WP)
    expanded_t, perm = expand_rope_cache(cache_t, head_dim)
    cache_j = jax_rope_cache(jnp.asarray(pos), head_dim, HP, WP)
    expanded_j, perm_j = jfa.expand_rope_cache(cache_j, head_dim)
    return cache_t, expanded_t, perm, cache_j, expanded_j, tuple(int(i) for i in perm_j)


def test_layernorm_and_mlp_match_flax():
    x = _x()
    ln = jm.LayerNorm()
    rng = np.random.RandomState(9)  # a non-trivial affine
    p_ln = {"scale": rng.randn(DIM).astype(np.float32), "bias": rng.randn(DIM).astype(np.float32)}
    want = jax.jit(lambda p, a: ln.apply({"params": p}, a))(p_ln, jnp.asarray(x))
    _close(_port(tm.LayerNorm(DIM), p_ln)(torch.from_numpy(x)), want)

    p_mlp, want = _init_apply(jm.Mlp(hidden_dim=4 * DIM), jnp.asarray(x))
    _close(_port(tm.Mlp(DIM, 4 * DIM), p_mlp)(torch.from_numpy(x)), want)


# head width 64 on the DN route (width 32 is held by tests/test_torch_flash_dn.py),
# 64 and 32 on the plain route
@pytest.mark.parametrize("route,num_heads", [("dn", 1), ("plain", 1), ("plain", 2)])
def test_attention_matches_flax(route, num_heads):
    x = _x(1)
    head_dim = DIM // num_heads
    cache_t, expanded_t, perm, cache_j, expanded_j, perm_j = _tables(head_dim)
    flash = route == "dn"
    jattn = jm.Attention(dim=DIM, num_heads=num_heads, use_rope=True, use_flash=flash,
                         head_perm=perm_j if flash else None)
    twin = jm.Attention(dim=DIM, num_heads=num_heads)
    kwargs = dict(rope_expanded=expanded_j) if flash else dict(rope_cache=cache_j)
    with pltpu.force_tpu_interpret_mode():
        params, want = _init_apply(jattn, jnp.asarray(x), init_module=twin, **kwargs)
    tattn = _port(tm.Attention(DIM, num_heads, use_rope=True, use_flash=flash), params)
    if flash:
        got = tattn(torch.from_numpy(x), rope_expanded=expanded_t,
                    qkv_perm=tm.qkv_row_perm(perm, num_heads, head_dim))
    else:
        got = tattn(torch.from_numpy(x), rope_cache=cache_t)
    _close(got, want)


# the BHND route at the ViT-H and 16-head ViT-g head widths, with the stack-pad
# kv_valid: JAX permutes the q/k activations (`head_perm`), the port the qkv rows
@pytest.mark.parametrize("head_dim", [80, 88])
def test_attention_bhnd_route_matches_flax(head_dim):
    num_heads, kv_valid = 2, N - 3
    dim = num_heads * head_dim
    x = np.random.RandomState(5).randn(B, N, dim).astype(np.float32)
    _, expanded_t, perm, _, expanded_j, perm_j = _tables(head_dim)
    jattn = jm.Attention(dim=dim, num_heads=num_heads, use_rope=True, use_flash=True,
                         head_perm=perm_j, kv_valid=kv_valid)
    twin = jm.Attention(dim=dim, num_heads=num_heads)
    with pltpu.force_tpu_interpret_mode():
        params, want = _init_apply(jattn, jnp.asarray(x), init_module=twin,
                                   rope_expanded=expanded_j)
    tattn = _port(tm.Attention(dim, num_heads, use_rope=True, use_flash=True), params)
    got = tattn(torch.from_numpy(x), rope_expanded=expanded_t,
                qkv_perm=tm.qkv_row_perm(perm, num_heads, head_dim), kv_valid=kv_valid)
    _close(got, want)


def test_block_dn_route_matches_flax():
    x = _x(2)
    num_heads, head_dim = 1, DIM
    _, expanded_t, perm, _, expanded_j, perm_j = _tables(head_dim)
    jblk = jm.Block(dim=DIM, num_heads=num_heads, use_rope=True, use_flash=True,
                    head_perm=perm_j, layer_id=3)
    twin = jm.Block(dim=DIM, num_heads=num_heads, layer_id=3)
    with pltpu.force_tpu_interpret_mode():
        params, want = _init_apply(jblk, jnp.asarray(x), init_module=twin,
                                   rope_expanded=expanded_j)
    tblk = _port(tm.Block(DIM, num_heads, use_rope=True, use_flash=True, layer_id=3), params)
    got = tblk(torch.from_numpy(x), rope_expanded=expanded_t,
               qkv_perm=tm.qkv_row_perm(perm, num_heads, head_dim))
    _close(got, want)


def test_cross_attention_block_matches_flax():
    x = _x(3)
    q = np.random.RandomState(4).randn(B, 1, DIM).astype(np.float32)
    jblk = jm.CrossAttentionBlock(dim=DIM, num_heads=4)
    params, want = _init_apply(jblk, jnp.asarray(q), jnp.asarray(x))
    got = _port(tm.CrossAttentionBlock(DIM, 4), params)(torch.from_numpy(q), torch.from_numpy(x))
    _close(got, want)
