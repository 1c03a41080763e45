"""The port's fused LayerNorm routes (``fuse_ln_qkv`` / ``fuse_ln_mlp``: B7 and
B8 in every block, attention on the BHND kernels rope-free) against the JAX
package with both fusions on (`set_ln_fusions("qkv,mlp")`, restored by a
fixture after every test: a flag left on would change the later JAX tests
of the same worker):

* a fused `Block` (width 128, 2 heads of 64, RoPE, stack-pad kv_valid) with
  a non-trivial LayerNorm affine, forward and every gradient, JAX under
  `pltpu.force_tpu_interpret_mode()`, so its B7, B8 and B3/B4 Pallas kernels
  and their custom VJPs run in interpret mode;
* the masked, stack-padded `VisionTransformer` (width 192, 3 heads of 64,
  depth 2) unmasked and masked, and the predictor (width 64, 2 heads of 32,
  depth 2), JAX through the plain references (its kernels' `supports` gates
  refuse width 192 off the TPU);
* one whole train step (4 frames at 64 px, batch 2, the two mask configs of
  the pretrain headline from the collator): loss, grad norm, every gradient
  and the EMA target, as `test_torch_pretrain_step.py` compares the unfused
  step;
* fused and unfused models have the same state-dict keys; `parse_ln_fusions`
  reads the lists `set_ln_fusions` reads and rejects the same names with the
  same message; the unfused `Attention` keeps the DN route at Dh <= 64 now
  that the BHND kernels take 32 and 64.

Tolerance: fp32 throughout, as the unfused tests: atol 2e-5, rtol 1e-4 on
outputs; the step's gradients atol 1e-6 + 1e-4 max|leaf|, rtol 1e-4, loss and
grad norm rtol 1e-5, the EMA target atol 1e-6
(`test_torch_pretrain_step.py` gives the reasons).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vjepa2_tpu.models import modules as jm
from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu.ops.masking import apply_mask as jax_apply_mask
from vjepa2_tpu.ops.rope import build_rope_cache as jax_rope_cache
from vjepa2_tpu.train import pretrain as jpre
from vjepa2_tpu.train.state import TrainState as JaxState
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache
from vjepa2_tpu_torch.train import pretrain as tpre
from vjepa2_tpu_torch.train.state import TrainState

ATOL, RTOL = 2e-5, 1e-4
FUSED = dict(fuse_ln_qkv=True, fuse_ln_mlp=True)


@pytest.fixture
def jax_fused():
    """Both JAX fusion flags on for one test, restored after it."""
    saved = (jm.FUSE_LN_QKV, jm.FUSE_LN_MLP)
    jm.set_ln_fusions("qkv,mlp")
    try:
        yield
    finally:
        jm.FUSE_LN_QKV, jm.FUSE_LN_MLP = saved


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_fused_block_and_grads_match_flax_kernels(jax_fused):
    B, N, dim, heads, kv_valid = 2, 32, 128, 2, 29
    Dh = dim // heads
    rng = np.random.RandomState(0)
    x = rng.randn(B, N, dim).astype(np.float32)
    w = rng.randn(B, N, dim).astype(np.float32)
    w[:, kv_valid:] = 0.0  # pad rows are sliced off by the models: no cotangent
    pos = np.arange(N)
    expanded_t, perm = expand_rope_cache(build_rope_cache(torch.from_numpy(pos), Dh, 4, 4), Dh)
    expanded_j, perm_j = jfa.expand_rope_cache(jax_rope_cache(jnp.asarray(pos), Dh, 4, 4), Dh)
    jblk = jm.Block(dim=dim, num_heads=heads, use_rope=True, use_flash=True,
                    head_perm=tuple(int(i) for i in perm_j), kv_valid=kv_valid, layer_id=1)
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(lambda a: jblk.init(jax.random.PRNGKey(0), a,
                                             rope_expanded=expanded_j))(jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        for norm in ("norm1", "norm2"):  # a non-trivial affine
            params[norm] = {k: (rng.randn(*v.shape) * 0.5 + (k == "scale")).astype(np.float32)
                            for k, v in params[norm].items()}

        def loss_j(p, a):
            return jnp.sum(jblk.apply({"params": p}, a, rope_expanded=expanded_j) * w)

        out_j = jax.jit(lambda p, a: jblk.apply({"params": p}, a, rope_expanded=expanded_j))(
            params, jnp.asarray(x))
        grads_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(params, jnp.asarray(x))

    tblk = tm.Block(dim, heads, use_rope=True, use_flash=True, layer_id=1, **FUSED)
    tblk.load_state_dict(state_dict_from_flax(params))
    xt = torch.tensor(x, requires_grad=True)
    out = tblk(xt, rope_expanded=expanded_t, qkv_perm=tm.qkv_row_perm(perm, heads, Dh),
               kv_valid=kv_valid)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out[:, :kv_valid], np.asarray(out_j)[:, :kv_valid])
    _close(xt.grad, grads_j[1])
    want = state_dict_from_flax(grads_j[0])
    for key, p in tblk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[key]), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


S, T, B = 64, 8, 2
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, uniform_power=True, use_rope=True, use_flash=True)
PRED = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
            predictor_embed_dim=64, depth=2, num_heads=2, uniform_power=True, use_rope=True,
            use_flash=True, use_mask_tokens=True, num_mask_tokens=2, zero_init_mask_tokens=False)


def test_fused_encoder_and_predictor_match_jax(jax_fused):
    """21 context tokens stack-padded to 24, 43 predictor tokens to 48; the
    unmasked encoder over all 64 tokens with the shared tables."""
    rng = np.random.RandomState(2)
    perms = [rng.permutation((T // 2) * (S // 16) ** 2) for _ in range(B)]
    me = np.stack([np.sort(p[:21]) for p in perms]).astype(np.int32)
    mp = np.stack([np.sort(p[21:43]) for p in perms]).astype(np.int32)
    clips = np.random.RandomState(0).rand(B, T, S, S, 3).astype(np.float32)
    jenc, jpred = JaxViT(**ENC), JaxPredictor(**PRED)
    jc, jme, jmp = jnp.asarray(clips), jnp.asarray(me), jnp.asarray(mp)
    enc_params = jax.jit(lambda k, c, m: jenc.init(k, c, [m]))(jax.random.PRNGKey(0), jc, jme)
    full_j = jax.jit(lambda p, c: jenc.apply(p, c))(enc_params, jc)
    z_j = jax.jit(lambda p, c, m: jenc.apply(p, c, [m]))(enc_params, jc, jme)
    pred_params = jax.jit(lambda k, z, a, b: jpred.init(k, z, a, b, 1))(
        jax.random.PRNGKey(1), z_j, jme, jmp)
    out_j = jax.jit(lambda p, z, a, b: jpred.apply(p, z, a, b, 1))(pred_params, z_j, jme, jmp)

    enc = VisionTransformer(**ENC, **FUSED)
    enc.load_state_dict(state_dict_from_flax(enc_params))
    pred = VisionTransformerPredictor(**PRED, **FUSED)
    pred.load_state_dict(state_dict_from_flax(pred_params))
    with torch.no_grad():
        full = enc(torch.from_numpy(clips))
        z = enc(torch.from_numpy(clips), [torch.from_numpy(me)])
        out = pred(z, torch.from_numpy(me), torch.from_numpy(mp), mask_index=1)
    for got, want in ((full, full_j), (z, z_j), (out, out_j)):
        _close(got, want)


MASK_CFGS = [
    {"spatial_scale": (0.15, 0.15), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 8},
    {"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 2},
]
HP = dict(ipe=100, epochs=10, warmup_epochs=1)


def _flat(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def test_fused_train_step_matches_jax(jax_fused):
    T4 = 4
    enc_cfg, pred_cfg = dict(ENC, num_frames=T4), dict(PRED, num_frames=T4)
    coll = MaskCollator(MASK_CFGS, dataset_fpcs=[T4], crop_size=(S, S))
    coll.step()
    masks_enc, masks_pred = coll(T4, B)
    clips = np.random.RandomState(0).rand(B, T4, S, S, 3).astype(np.float32)
    jclips = jnp.asarray(clips)
    jme, jmp = tuple(map(jnp.asarray, masks_enc)), tuple(map(jnp.asarray, masks_pred))

    jenc, jpred = JaxViT(**enc_cfg), JaxPredictor(**pred_cfg)
    hp_j = jpre.PretrainHParams(**HP)
    enc_vars = jax.jit(lambda k, c, m: jenc.init(k, c, [m]))(jax.random.PRNGKey(0), jclips,
                                                             jme[0])
    z0 = jax.jit(lambda v, c, m: jenc.apply(v, c, [m]))(enc_vars, jclips, jme[0])
    pred_vars = jax.jit(lambda k, z, a, b: jpred.init(k, z, a, b, 0))(
        jax.random.PRNGKey(1), z0, jme[0], jmp[0])
    params = {"encoder": enc_vars["params"], "predictor": pred_vars["params"]}
    target = jax.tree_util.tree_map(jnp.copy, enc_vars["params"])

    def loss_fn(params, target):  # `make_train_step:207-230`, from the package's pieces
        h = jenc.apply({"params": target}, jclips).astype(jnp.float32)
        h = (h - h.mean(-1, keepdims=True)) / jnp.sqrt(h.var(-1, keepdims=True) + 1e-6)
        h_list = [jax_apply_mask(h, mp) for mp in jmp]
        z_list = [jpred.apply({"params": params["predictor"]},
                              jenc.apply({"params": params["encoder"]}, jclips, [me]),
                              me, mp, i)
                  for i, (me, mp) in enumerate(zip(jme, jmp))]
        return jpre.jepa_loss(z_list, h_list, hp_j.loss_exp)

    grads_j = jax.jit(jax.grad(loss_fn))(params, target)
    tx = jpre.make_optimizer(hp_j)
    state_j, metrics_j = jax.jit(jpre.make_train_step(jenc, jpred, tx, hp_j))(
        JaxState.create(params, target, tx), jclips, jme, jmp)

    enc = VisionTransformer(**enc_cfg, **FUSED)
    pred = VisionTransformerPredictor(**pred_cfg, **FUSED)
    enc.load_state_dict(state_dict_from_flax(enc_vars))
    pred.load_state_dict(state_dict_from_flax(pred_vars))
    hp = tpre.PretrainHParams(**HP)
    state = TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred))
    grads = {}

    def keep_grads(opt_step, step):  # read the gradients the update is about to use
        for prefix, m in (("encoder", enc), ("predictor", pred)):
            grads.update({f"{prefix}.{k}": p.grad.clone() for k, p in m.named_parameters()})
        opt_step(step)

    state.optimizer.step = functools.partial(keep_grads, state.optimizer.step)
    metrics = tpre.make_train_step(hp)(state, torch.from_numpy(clips),
                                       [torch.from_numpy(m) for m in masks_enc],
                                       [torch.from_numpy(m) for m in masks_pred])

    np.testing.assert_allclose(metrics["loss"].item(), float(metrics_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(metrics_j["grad_norm"]),
                               rtol=1e-5)
    want = {f"encoder.{k}": v for k, v in _flat(state_dict_from_flax(grads_j["encoder"])).items()}
    want.update({f"predictor.{k}": v
                 for k, v in _flat(state_dict_from_flax(grads_j["predictor"])).items()})
    assert sorted(grads) == sorted(want)
    for key, g in grads.items():
        tol = 1e-4 * np.abs(want[key]).max()
        np.testing.assert_allclose(g.numpy(), want[key], atol=1e-6 + tol, rtol=1e-4,
                                   err_msg=key)
    target_j = _flat(state_dict_from_flax(state_j.target_params))
    for key, t in state.target_encoder.state_dict().items():
        np.testing.assert_allclose(t.numpy(), target_j[key], atol=1e-6, err_msg=key)


def test_fused_and_unfused_state_dicts_have_the_same_keys():
    enc, pred = tpre.build_models("vit_tiny", crop_size=64, num_frames=4, pred_depth=2,
                                  pred_embed_dim=64, pred_num_heads=2, use_rope=True,
                                  dtype=torch.float32, device="cpu", fuse_ln="qkv,mlp")
    enc0, pred0 = tpre.build_models("vit_tiny", crop_size=64, num_frames=4, pred_depth=2,
                                    pred_embed_dim=64, pred_num_heads=2, use_rope=True,
                                    dtype=torch.float32, device="cpu")
    assert all(b.fuse_ln_qkv and b.fuse_ln_mlp for b in [*enc.blocks, *pred.predictor_blocks])
    assert not any(b.fuse_ln_qkv or b.fuse_ln_mlp for b in enc0.blocks)
    for fused, plain in ((enc, enc0), (pred, pred0)):
        assert list(fused.state_dict()) == list(plain.state_dict())
        assert [v.shape for v in fused.state_dict().values()] == \
            [v.shape for v in plain.state_dict().values()]


@pytest.mark.parametrize("csv,want", [("qkv,mlp", (True, True)), (" mlp ", (False, True)),
                                      ("qkv", (True, False)), ("", (False, False)),
                                      ("qkv,,qkv", (True, False))])
def test_parse_ln_fusions_reads_the_jax_lists(jax_fused, csv, want):
    assert tm.parse_ln_fusions(csv) == want
    jm.set_ln_fusions(csv)
    assert (jm.FUSE_LN_QKV, jm.FUSE_LN_MLP) == want


@pytest.mark.parametrize("csv", ["qkv,ln", "attn", "QKV"])
def test_parse_ln_fusions_rejects_what_jax_rejects(jax_fused, csv):
    with pytest.raises(ValueError) as jax_err:
        jm.set_ln_fusions(csv)
    with pytest.raises(ValueError) as port_err:
        tm.parse_ln_fusions(csv)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("fused", [False, True])
def test_unfused_attention_keeps_the_dn_route_at_dh_64(monkeypatch, fused):
    """BHND now takes Dh 64, but the unfused block still picks DN first
    (`modules.py:523-543`); the fused block goes through B7 and BHND."""
    calls = []
    for name in ("attend_bhdn", "attend_bhnd", "ln_qkv"):
        fn = getattr(tm, name)
        monkeypatch.setattr(tm, name, functools.partial(
            lambda fn, name, *a, **k: (calls.append(name), fn(*a, **k))[1], fn, name))
    blk = tm.Block(128, 2, use_rope=True, use_flash=True, fuse_ln_qkv=fused, fuse_ln_mlp=fused)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    (cos, sin), perm = expand_rope_cache(build_rope_cache(torch.arange(32), 64, 4, 4), 64)
    with torch.no_grad():
        blk(torch.randn(2, 32, 128), rope_expanded=(cos, sin),
            qkv_perm=tm.qkv_row_perm(perm, 2, 64))
    assert calls == (["ln_qkv", "attend_bhnd"] if fused else ["attend_bhdn"])
