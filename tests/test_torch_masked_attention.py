"""The masked and causal attention of the port (`ops.attention.sdpa` with
``attn_mask`` / ``is_causal`` / ``scale``, `Attention`'s masked route,
`Block` with ``attn_mask`` and ``is_causal``), stochastic depth
(`modules.drop_path` on JAX's own uniform draws, replayed), and the AC
predictor's options (``use_silu``, ``is_frame_causal=False``) against the
JAX package. Weights cross with `hub.converter.state_dict_from_flax`; inputs,
masks and cotangents come from numpy with a seed.

Sizes: width 64, 2 heads of 32 (the plain route) or 1 head of 64 (the flash
route, which a mask or the causal flag turns into the masked route on both
sides), 32 tokens; the AC predictor at `test_torch_ac_predictor.py`'s sizes.

Tolerance: fp32: outputs and gradients atol 2e-5, rtol 1e-4; the AC
predictor at JAX's own AC tolerance, atol 3e-5, rtol 2e-4
(`tests/models/test_flash_integration.py:49`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.models import modules as jm
from vjepa2_tpu.models.ac_predictor import vit_ac_predictor as jax_ac_predictor
from vjepa2_tpu.ops import attention as jattn
from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu.ops.rope import build_rope_cache as jax_rope_cache
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor
from vjepa2_tpu_torch.ops.attention import sdpa
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

ATOL, RTOL = 2e-5, 1e-4
B, N, DIM, H = 2, 32, 64, 2


def _close(got, want, what="", atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


def _mask(kind, rng):
    """(the port's mask, JAX's mask), True = attend, every row with a key."""
    if kind is None:
        return None, None
    shape = {"2d": (N, N), "3d": (B, N, N), "4d": (B, H, N, N)}[kind]
    m = rng.rand(*shape) < 0.6
    m[..., np.arange(N), np.arange(N)] = True  # every query attends itself
    # JAX's sdpa broadcasts [B, N, N] as [1, B, N, N] (queue C): it gets
    # the per-example mask as [B, 1, N, N]
    return m, (m[:, None] if kind == "3d" else m)


@pytest.mark.parametrize("kind,causal,scale", [
    (None, True, None), ("2d", False, None), ("3d", False, None), ("4d", False, None),
    ("2d", True, None), ("4d", True, 0.3), (None, False, 0.5)])
def test_sdpa_matches_jax(kind, causal, scale):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, N, H, 32).astype(np.float32) for _ in range(3))
    mask_t, mask_j = _mask(kind, rng)
    want = jattn.sdpa(*map(jnp.asarray, (q, k, v)),
                      attn_mask=None if mask_j is None else jnp.asarray(mask_j),
                      is_causal=causal, scale=scale)
    for use_flash in (False, True):  # a mask, causal or a scale keeps the plain math
        got = sdpa(*map(torch.from_numpy, (q, k, v)),
                   attn_mask=None if mask_t is None else torch.from_numpy(mask_t),
                   is_causal=causal, scale=scale, use_flash=use_flash)
        _close(got, want)


def test_jax_broadcasts_a_per_example_mask_over_heads():
    """ROADMAP queue C, "JAX's [B, N, N] mask": JAX's `_manual_sdpa` pads a
    mask's rank on the left, so a [B, N, N] mask lands on the heads' axis
    (example b's mask on head b, with B == H); the port gives each example
    its own mask over all its heads, and gives JAX's numbers when handed
    that head-wise mask."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(B, N, H, 32).astype(np.float32) for _ in range(3))
    m = rng.rand(B, N, N) < 0.6
    m[..., np.arange(N), np.arange(N)] = True
    want = np.array(jattn.sdpa(*map(jnp.asarray, (q, k, v)), attn_mask=jnp.asarray(m)))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    headwise = torch.from_numpy(np.broadcast_to(m[None], (B, H, N, N)).copy())
    _close(sdpa(qt, kt, vt, attn_mask=headwise), want)
    per_example = sdpa(qt, kt, vt, attn_mask=torch.from_numpy(m))
    assert (per_example - torch.from_numpy(want)).abs().max() > 1e-2


def test_fully_masked_row_gives_zero_where_jax_averages():
    """ROADMAP queue C, "Fully masked rows": a query with no key to attend
    gets 0 from the port, as the flash kernels give it, where JAX's -1e30
    fill averages v; every other row agrees."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(B, N, H, 32).astype(np.float32) for _ in range(3))
    m = np.ones((N, N), bool)
    m[5] = False
    want = np.asarray(jattn.sdpa(*map(jnp.asarray, (q, k, v)), attn_mask=jnp.asarray(m)))
    got = sdpa(*map(torch.from_numpy, (q, k, v)), attn_mask=torch.from_numpy(m))
    rows = np.arange(N) != 5
    _close(got[:, rows], want[:, rows])
    assert torch.count_nonzero(got[:, 5]) == 0
    np.testing.assert_allclose(want[:, 5], v.mean(1), atol=1e-5)


def _tables(head_dim):
    pos = np.arange(N)
    cache_t = build_rope_cache(torch.from_numpy(pos), head_dim, 4, 4)
    exp_t, perm = expand_rope_cache(cache_t, head_dim)
    cache_j = jax_rope_cache(jnp.asarray(pos), head_dim, 4, 4)
    exp_j, perm_j = jfa.expand_rope_cache(cache_j, head_dim)
    return cache_t, exp_t, perm, cache_j, exp_j, tuple(int(i) for i in perm_j)


@pytest.mark.parametrize("route", ["flash", "plain"])
@pytest.mark.parametrize("kind,causal", [("2d", False), ("4d", False), (None, True),
                                         ("3d", True)])
def test_block_with_mask_or_causal_matches_flax(kind, causal, route):
    """`Block` with ``attn_mask`` and with ``is_causal``: on the flash route
    (one head of 64, split-half tables) the fused, DN and BHND routes are off
    and q, k are rotated before the plain math, as JAX's branch
    (`modules.py:604-621`); on the plain route with the interleaved cache.
    Forward and every gradient."""
    flash = route == "flash"
    heads = 1 if flash else H
    head_dim = DIM // heads
    rng = np.random.RandomState(3)
    x = rng.randn(B, N, DIM).astype(np.float32)
    cot = rng.randn(B, N, DIM).astype(np.float32)
    if kind == "4d":
        mask_t = rng.rand(B, heads, N, N) < 0.6
        mask_t[..., np.arange(N), np.arange(N)] = True
        mask_j = mask_t
    else:
        mask_t, mask_j = _mask(kind, rng)
    cache_t, exp_t, perm, cache_j, exp_j, perm_j = _tables(head_dim)
    jblk = jm.Block(dim=DIM, num_heads=heads, use_rope=True, use_flash=flash, is_causal=causal,
                    head_perm=perm_j if flash else None, layer_id=1)
    twin = jm.Block(dim=DIM, num_heads=heads, layer_id=1)
    params = jax.jit(lambda a: twin.init(jax.random.PRNGKey(0), a))(jnp.asarray(x))
    tables = dict(rope_expanded=exp_j) if flash else dict(rope_cache=cache_j)
    mj = None if mask_j is None else jnp.asarray(mask_j)

    def f(p, a):
        return jblk.apply(p, a, attn_mask=mj, **tables)

    out_j = jax.jit(f)(params, jnp.asarray(x))
    g_p, g_x = jax.jit(jax.grad(lambda p, a: jnp.sum(f(p, a) * cot), argnums=(0, 1)))(
        params, jnp.asarray(x))

    blk = tm.Block(DIM, heads, use_rope=True, use_flash=flash, layer_id=1, is_causal=causal,
                   fuse_ln_qkv=flash)
    blk.load_state_dict(state_dict_from_flax(params))
    xt = torch.tensor(x, requires_grad=True)
    kw = (dict(rope_expanded=exp_t, qkv_perm=tm.qkv_row_perm(perm, heads, head_dim)) if flash
          else dict(rope_cache=cache_t))
    out = blk(xt, attn_mask=None if mask_t is None else torch.from_numpy(mask_t), **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, out_j)
    _close(xt.grad, g_x)
    want = state_dict_from_flax(g_p)
    for key, p in blk.named_parameters():
        _close(p.grad, want[key], key)


def test_drop_path_replays_jax_draws(monkeypatch):
    """Stochastic depth on JAX's uniform draws (JAX `modules.py:748-756`,
    `maybe_drop` twice a block), recorded as JAX's `Block` makes them and
    replayed through ``rng``, as `test_torch_planning.py::test_cem_matches_jax`
    replays the CEM noise: the same examples dropped, the kept ones scaled
    by 1 / (1 - rate); forward and every gradient. Without ``rng`` the block
    is deterministic."""
    rate, batch = 0.4, 6
    rng = np.random.RandomState(4)
    x = rng.randn(batch, N, DIM).astype(np.float32)
    cot = rng.randn(batch, N, DIM).astype(np.float32)
    draws = []
    real = jm.drop_path

    def recording(y, r, deterministic, key=None):
        if not deterministic and r > 0:
            draws.append(np.asarray(jax.random.uniform(key, (y.shape[0],) + (1,) * (y.ndim - 1),
                                                       dtype=jnp.float32)))
        return real(y, r, deterministic, key)

    monkeypatch.setattr(jm, "drop_path", recording)
    jblk = jm.Block(dim=DIM, num_heads=H, drop_path_rate=rate)
    params = jax.jit(lambda a: jblk.init(jax.random.PRNGKey(0), a))(jnp.asarray(x))
    keys = {"drop_path": jax.random.PRNGKey(7)}

    def f(p, a):
        return jblk.apply(p, a, deterministic=False, rngs=keys)

    out_j = f(params, jnp.asarray(x))  # eager: the draws are concrete
    replay = list(draws[:2])
    g_p, g_x = jax.grad(lambda p, a: jnp.sum(f(p, a) * cot), argnums=(0, 1))(params,
                                                                             jnp.asarray(x))
    kept = np.floor(1.0 - rate + np.concatenate([d.ravel() for d in replay]))
    assert 0 < kept.sum() < kept.size  # some examples dropped, some kept

    blk = tm.Block(DIM, H, drop_path_rate=rate)
    blk.load_state_dict(state_dict_from_flax(params))
    it = iter(replay)
    xt = torch.tensor(x, requires_grad=True)
    out = blk(xt, rng=lambda shape: torch.from_numpy(next(it)).reshape(shape))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, out_j)
    _close(xt.grad, g_x)
    want = state_dict_from_flax(g_p)
    for key, p in blk.named_parameters():
        _close(p.grad, want[key], key)
    with torch.no_grad():  # deterministic without rng, as JAX's default
        det_j = jblk.apply(params, jnp.asarray(x))
        _close(blk(torch.from_numpy(x)), det_j)
        gen = torch.Generator().manual_seed(0)
        y = torch.ones(batch, 3)
        dropped = tm.drop_path(y, rate, gen)
        scales = torch.tensor([0.0, 1.0 / (1.0 - rate)]).tolist()  # fp32's 1 / 0.6
        assert set(dropped[:, 0].tolist()) <= set(scales)


S, GRID, E, P = 64, 4, 64, 128
AC = dict(img_size=(S, S), patch_size=16, embed_dim=E, predictor_embed_dim=P, depth=2,
          num_heads=2)


def _ac_inputs(T, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T * GRID * GRID, E).astype(np.float32)
    a = (rs.randn(B, T, 7) * 0.1).astype(np.float32)
    s = rs.randn(B, T, 7).astype(np.float32)
    cot = rs.randn(B, T * GRID * GRID, E).astype(np.float32)
    return x, a, s, cot


@functools.lru_cache(maxsize=None)
def _jax_ac(use_silu, causal):
    return jax_ac_predictor(**AC, num_frames=8, tubelet_size=2, use_silu=use_silu,
                            is_frame_causal=causal)


@pytest.mark.parametrize("route", ["dn", "plain"])
@pytest.mark.parametrize("use_silu,causal", [(True, True), (False, False), (True, False)],
                         ids=["silu", "full-attention", "silu-full-attention"])
def test_ac_predictor_options_match_jax(use_silu, causal, route):
    """The AC predictor with SwiGLU blocks and with ``is_frame_causal=False``
    (3 frames: 54 tokens, stack-padded to 56 on the DN route, the pad keys
    masked by kv_valid where there are no segment ids), JAX on its XLA
    attention (`test_torch_ac_predictor.py` says why); forward and every
    gradient."""
    x, a, s, cot = _ac_inputs(3)
    jpred = _jax_ac(use_silu, causal)
    params = jax.jit(jpred.init)(jax.random.PRNGKey(3), x, a, s)

    def f(p, *xs):
        return jpred.apply(p, *xs)

    out_j = jax.jit(f)(params, x, a, s)
    g_p, g_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(f(p, xx, a, s) * cot), argnums=(0, 1)))(
        params, x)

    pred = vit_ac_predictor(**AC, use_flash=route == "dn", use_silu=use_silu,
                            is_frame_causal=causal)
    assert isinstance(pred.predictor_blocks[0].mlp, tm.SwiGLUFFN) == use_silu
    pred.load_state_dict(state_dict_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = pred(xt, torch.from_numpy(a), torch.from_numpy(s))
    (out * torch.from_numpy(cot)).sum().backward()
    tol = dict(atol=3e-5, rtol=2e-4)
    _close(out, out_j, "out", **tol)
    _close(xt.grad, g_x, "dx", **tol)
    want = state_dict_from_flax(g_p)
    for key, p in pred.named_parameters():
        _close(p.grad, want[key], key, **tol)


def test_ac_full_attention_runs_the_dn_route_without_segments(monkeypatch):
    """``is_frame_causal=False`` hands the DN wrapper no segment ids and the
    stack pad's kv_valid (54 real tokens of 56)."""
    from vjepa2_tpu_torch.ops import attention as tattn

    calls = []
    real = tattn.attend_bhdn

    def spy(q, k, v, **kw):
        calls.append((kw.get("segment_ids"), kw.get("kv_valid"), q.shape[-1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tm, "attend_bhdn", spy)
    x, a, s, _ = _ac_inputs(3)
    pred = vit_ac_predictor(**AC, use_flash=True, is_frame_causal=False)
    with torch.no_grad():
        pred(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(s))
    assert calls == [(None, 54, 56)] * 2
