"""The port's action-conditioned predictor against the flax modules of the
JAX package: `build_ac_rope_cache`, `ACAttention`, `ACBlock` and
`VisionTransformerPredictorAC` (JAX `models/modules.py:629-909`,
`models/ac_predictor.py`). Weights cross with
`hub.converter.state_dict_from_flax`; inputs and cotangents come from numpy
with a seed.

Sizes: predictor width 128, 2 heads of 64 (the shipped predictor's head
width, so the port's flash route is the DN one), encoder width 64, depth 2,
a 4 x 4 patch grid (64 px), T 3 or 4 frames, 2 conditioning tokens (3 with
``use_extrinsics``). T 3 gives 54 tokens (57 with extrinsics), which the
flash route stack-pads to 56 (64) with the pad keys on segment int32-max;
T 4 gives 72 (76 -> 80).

JAX runs its XLA attention (``use_flash=False``): on the CPU its AC layer
would take the BHND Pallas route with interleaved tables, and
`tests/models/test_flash_integration.py` already holds that to the XLA one.
The port runs its flash route (B1/B2's plain versions through
`FlashAttentionDN`, split-half tables), which heads of 16-64 take on the
card at bf16 and at fp32, the BHND route that wider heads keep (every head
width on the BHND kernels' plain versions with the frame-causal ids and the
pad keys on int32-max: `dn_head_eligible` patched to refuse every width,
the DN entry refused) and its plain route: the same function, compared by
outputs and gradients only.

Tolerance: JAX's own AC tolerance, atol 3e-5 and rtol 2e-4 on outputs and
on every gradient (`tests/models/test_flash_integration.py:49`); the tables
within 1e-6; remat bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.models import modules as jm
from vjepa2_tpu.models.ac_predictor import vit_ac_predictor as jax_ac_predictor
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor

S, GRID, B, E, P, H = 64, 4, 2, 64, 128, 2
ATOL, RTOL = 3e-5, 2e-4
PRED = dict(img_size=(S, S), patch_size=16, embed_dim=E, predictor_embed_dim=P, depth=2,
            num_heads=H)


@pytest.fixture
def jax_fused_mlp():
    """JAX's LN + fc1 + GELU fusion on for one test, restored after it."""
    saved = (jm.FUSE_LN_QKV, jm.FUSE_LN_MLP)
    jm.set_ln_fusions("mlp")
    try:
        yield
    finally:
        jm.FUSE_LN_QKV, jm.FUSE_LN_MLP = saved


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def _grads_close(module: torch.nn.Module, jax_grads):
    want = state_dict_from_flax(jax_grads)
    got = {k: p.grad for k, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k].numpy(), want[k].numpy(), k)


def _jax_apply_and_grads(module, params, inputs, cot, **static):
    """(out, d params, d inputs) of sum(out * cot) through the flax module."""
    def f(p, *xs):
        return module.apply(p, *xs, **static)

    out = jax.jit(f)(params, *inputs)
    grads = jax.jit(jax.grad(lambda p, *xs: jnp.sum(f(p, *xs) * cot),
                             argnums=tuple(range(1 + len(inputs)))))(params, *inputs)
    return np.asarray(out), grads[0], [np.asarray(g) for g in grads[1:]]


@pytest.mark.parametrize("head_dim, T, hp, wp, cond, grid", [
    (64, 7, 16, 16, 2, 16), (64, 3, 4, 4, 3, 4), (32, 4, 4, 6, 2, 4), (88, 2, 8, 8, 2, 16)])
def test_build_ac_rope_cache_matches_jax(head_dim, T, hp, wp, cond, grid):
    want = jm.build_ac_rope_cache(head_dim, T, hp, wp, cond, grid)
    got = tm.build_ac_rope_cache(head_dim, T, hp, wp, cond, grid)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (T * (cond + hp * wp), 3 * (2 * ((head_dim // 3) // 2)))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_frame_segments_and_pad():
    seg = tm.frame_segments(3, 18, pad=2)
    assert seg.dtype == torch.int32 and seg.shape == (56,)
    assert seg[:54].tolist() == [t for t in range(3) for _ in range(18)]
    assert seg[54:].tolist() == [tm.PAD_SEGMENT] * 2


@pytest.mark.parametrize("use_flash", [True, False], ids=["dn", "plain"])
def test_ac_attention_matches_jax(use_flash):
    T, cond = 3, 2
    N = T * (cond + GRID * GRID)
    rs = np.random.RandomState(0)
    x = rs.randn(B, N, P).astype(np.float32)
    cot = rs.randn(B, N, P).astype(np.float32)
    jmod = jm.ACAttention(dim=P, num_heads=H, grid_size=GRID)
    params = jmod.init(jax.random.PRNGKey(0), x, T, GRID, GRID, cond)
    out_j, gp_j, (gx_j,) = _jax_apply_and_grads(
        jmod, params, [x], cot, T=T, h_patches=GRID, w_patches=GRID, cond_tokens=cond)

    mod = tm.ACAttention(P, H, grid_size=GRID, use_flash=use_flash)
    mod.load_state_dict(state_dict_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, T, GRID, GRID, cond)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), out_j, "out")
    _close(xt.grad, gx_j, "dx")
    _grads_close(mod, gp_j)


@pytest.mark.parametrize("use_flash", [True, False], ids=["dn", "plain"])
def test_ac_block_matches_jax(use_flash):
    _block_matches_jax(use_flash, fuse_ln_mlp=False)


def test_ac_block_fused_mlp_matches_jax(jax_fused_mlp):
    """`ACBlock(fuse_ln_mlp=True)` (B8's plain version on the CPU) against
    JAX's ACBlock under ``set_ln_fusions("mlp")``."""
    _block_matches_jax(True, fuse_ln_mlp=True)


def _block_matches_jax(use_flash, fuse_ln_mlp):
    T, cond = 4, 2
    N = T * (cond + GRID * GRID)
    rs = np.random.RandomState(1)
    x = rs.randn(B, N, P).astype(np.float32)
    cot = rs.randn(B, N, P).astype(np.float32)
    jmod = jm.ACBlock(dim=P, num_heads=H, grid_size=GRID, layer_id=1)
    params = jmod.init(jax.random.PRNGKey(1), x, T, GRID, GRID, cond)
    # a LayerNorm affine away from (1, 0), so that the fused route's use of it shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jnp.asarray(rs.randn(*v.shape), v.dtype)
        if "norm" in jax.tree_util.keystr(path) else v, params)
    out_j, gp_j, (gx_j,) = _jax_apply_and_grads(
        jmod, params, [x], cot, T=T, h_patches=GRID, w_patches=GRID, cond_tokens=cond)

    mod = tm.ACBlock(P, H, grid_size=GRID, use_flash=use_flash, layer_id=1,
                     fuse_ln_mlp=fuse_ln_mlp)
    mod.load_state_dict(state_dict_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, T, GRID, GRID, cond)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), out_j, "out")
    _close(xt.grad, gx_j, "dx")
    _grads_close(mod, gp_j)


def _pred_inputs(T, extrinsics, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T * GRID * GRID, E).astype(np.float32)
    a = (rs.randn(B, T, 7) * 0.1).astype(np.float32)
    s = rs.randn(B, T, 7).astype(np.float32)
    e = rs.randn(B, T, 6).astype(np.float32) if extrinsics else None
    cot = rs.randn(B, T * GRID * GRID, E).astype(np.float32)
    return x, a, s, e, cot


@functools.lru_cache(maxsize=None)
def _jax_predictor(extrinsics):
    return jax_ac_predictor(**PRED, num_frames=8, tubelet_size=2, use_extrinsics=extrinsics)


def bhnd_route(monkeypatch):
    """The BHND route, which heads wider than 64 take (at bf16 and fp32): no
    head width to the DN kernels, so every flash call goes to
    `flash_attention_bhnd`."""
    def refused(*args, **kwargs):
        raise AssertionError("the DN route ran")

    monkeypatch.setattr(tm, "dn_head_eligible", lambda d: False)
    monkeypatch.setattr(tm, "attend_bhdn", refused)


@pytest.mark.parametrize("T", [3, 4])
@pytest.mark.parametrize("extrinsics", [False, True], ids=["as", "ase"])
@pytest.mark.parametrize("route", ["dn", "bhnd", "plain"])
def test_predictor_matches_jax(route, extrinsics, T, monkeypatch):
    if route == "bhnd":
        bhnd_route(monkeypatch)
    use_flash = route != "plain"
    x, a, s, e, cot = _pred_inputs(T, extrinsics)
    jpred = _jax_predictor(extrinsics)
    inputs = [x, a, s] + ([e] if extrinsics else [])
    params = jax.jit(jpred.init)(jax.random.PRNGKey(3), *inputs)
    out_j, gp_j, gin_j = _jax_apply_and_grads(jpred, params, inputs, cot)

    pred = vit_ac_predictor(**PRED, use_flash=use_flash, use_extrinsics=extrinsics)
    pred.load_state_dict(state_dict_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    rest = [torch.from_numpy(v) for v in inputs[1:]]
    out = pred(xt, *rest)
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.shape == (B, T * GRID * GRID, E)
    _close(out.detach(), out_j, "out")
    _close(xt.grad, gin_j[0], "dx")
    _grads_close(pred, gp_j)


def _port_predictor(seed, **kw):
    pred = vit_ac_predictor(**PRED, **kw)
    pred.reset_parameters(torch.Generator().manual_seed(seed))
    return pred


@pytest.mark.parametrize("policy", ["full", "save_attn_qkv_h"])
def test_predictor_remat_is_bit_equal(policy):
    """Every block under `remat_call` gives the bits of no remat: output and
    every gradient."""
    x, a, s, _, cot = _pred_inputs(3, False, seed=4)
    results = []
    for remat in (False, True):
        pred = _port_predictor(0, use_flash=True, use_activation_checkpointing=remat,
                               remat_policy=policy)
        xt = torch.from_numpy(x).requires_grad_()
        out = pred(xt, torch.from_numpy(a), torch.from_numpy(s))
        (out * torch.from_numpy(cot)).sum().backward()
        results.append([out.detach(), xt.grad] + [p.grad for p in pred.parameters()])
    assert all(torch.equal(u, v) for u, v in zip(*results))


def test_stack_pad_leaves_real_tokens_unchanged():
    """The flash route (a frame-causal sequence of 54 tokens padded to 56,
    pad keys on int32-max) and the unpadded plain route give the same
    tokens and gradients."""
    x, a, s, _, cot = _pred_inputs(3, False, seed=5)
    flash = _port_predictor(1, use_flash=True)
    plain = vit_ac_predictor(**PRED, use_flash=False)
    plain.load_state_dict(flash.state_dict())
    outs = []
    for pred in (flash, plain):
        out = pred(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(s))
        (out * torch.from_numpy(cot)).sum().backward()
        outs.append((out.detach(), [p.grad for p in pred.parameters()]))
    _close(outs[0][0], outs[1][0])
    for g, w in zip(outs[0][1], outs[1][1]):
        _close(g, w)
