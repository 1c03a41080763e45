"""Gradient accumulation in the port (`train/accum.py`,
`train/pretrain.make_train_step(grad_accum=)`) against the JAX package's
(`vjepa2_tpu/train/accum.py`, `make_train_step(grad_accum=)`), mirroring
`tests/train/test_grad_accum.py`.

Sizes as that test: 4 clips of 4 frames at 32 px (8 tokens), encoder and
predictor 32 wide, 2 heads of 16 (the DN route, its plain versions here),
depth 1, RoPE, fp32; one mask config from the collator; the same weights on
both sides (`hub.converter.load_pretrain_state`).

Tolerances: loss and grad norm rtol 1e-5 (fp32 sums in another order); the
averaged gradients atol 1e-6 + rtol 1e-4 of each leaf's largest entry (as
`test_torch_pretrain_step.py`), against JAX's `scan_accumulate` over the
same loss built from the package's pieces; the EMA target atol 1e-6 (it
moves by (1 - m) of an Adam update); the updated online parameters atol
1e-5, as JAX's own test holds its A = 2 against A = 1, on every entry whose
gradient exceeds 1e-3 of its leaf's largest: Adam's first step is
lr * g / (|g| + eps), so on a gradient near zero it turns fp32 noise in g
into up to lr (measured: one entry of 49152 off by 2.7e-5 against JAX),
and those entries are held through the gradients instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.masks.multiblock3d import MaskCollator
from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.ops.masking import apply_mask as jax_apply_mask
from vjepa2_tpu.train import accum as jaccum
from vjepa2_tpu.train import pretrain as jpre
from vjepa2_tpu.train.state import TrainState as JaxState
from vjepa2_tpu_torch.hub.converter import load_pretrain_state, state_dict_from_flax
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.train import pretrain as tpre
from vjepa2_tpu_torch.train.accum import validate_grad_accum
from vjepa2_tpu_torch.train.state import TrainState

B, T, S = 4, 4, 32
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=32, depth=1,
           num_heads=2, use_rope=True)
PRED = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=32,
            predictor_embed_dim=32, depth=1, num_heads=2, use_mask_tokens=True,
            num_mask_tokens=1, use_rope=True)
MASK_CFGS = [{"spatial_scale": (0.6, 0.6), "temporal_scale": (1.0, 1.0),
              "aspect_ratio": (1.0, 1.0), "num_blocks": 1}]
HP = dict(epochs=1, ipe=4, warmup_epochs=0)


@functools.lru_cache(maxsize=1)
def _setup():
    coll = MaskCollator(MASK_CFGS, dataset_fpcs=[T], crop_size=(S, S))
    coll.step()
    me, mp = coll(T, B)
    clips = np.random.RandomState(1).rand(B, T, S, S, 3).astype(np.float32)
    jenc, jpred = JaxViT(**ENC, dtype=jnp.float32), JaxPredictor(**PRED, dtype=jnp.float32)
    params, target = jpre.init_params(jenc, jpred, 0, (B, T, S, S, 3), jnp.asarray(me[0]),
                                      jnp.asarray(mp[0]))
    return jenc, jpred, params, target, clips, me, mp


def _microbatched(clips, me, mp, a):
    b = B // a
    return (clips.reshape(a, b, T, S, S, 3), [m.reshape(a, b, -1) for m in me],
            [m.reshape(a, b, -1) for m in mp])


def _jax_step(grad_accum):
    jenc, jpred, params, target, clips, me, mp = _setup()
    hp = jpre.PretrainHParams(**HP)
    tx = jpre.make_optimizer(hp)
    state = JaxState.create(params, target, tx)
    step = jax.jit(jpre.make_train_step(jenc, jpred, tx, hp, grad_accum=grad_accum))
    if grad_accum > 1:
        clips, me, mp = _microbatched(clips, me, mp, grad_accum)
    state, metrics = step(state, jnp.asarray(clips), tuple(map(jnp.asarray, me)),
                          tuple(map(jnp.asarray, mp)))
    return jax.block_until_ready(state), metrics


def _jax_accumulated_grads(grad_accum):
    """JAX's averaged gradients: `scan_accumulate` over the loss of
    `make_train_step:207-230`, built from the package's pieces."""
    jenc, jpred, params, target, clips, me, mp = _setup()
    hp = jpre.PretrainHParams(**HP)

    def loss_and_grads(params, target, clips, masks_enc, masks_pred):
        h = jenc.apply({"params": target}, clips).astype(jnp.float32)
        h = (h - h.mean(-1, keepdims=True)) / jnp.sqrt(h.var(-1, keepdims=True) + 1e-6)
        h_list = [jax_apply_mask(h, m) for m in masks_pred]

        def loss_fn(params):
            z = [jpred.apply({"params": params["predictor"]},
                             jenc.apply({"params": params["encoder"]}, clips, [a]), a, b, i)
                 for i, (a, b) in enumerate(zip(masks_enc, masks_pred))]
            return jpre.jepa_loss(z, h_list, hp.loss_exp)

        return jax.value_and_grad(loss_fn)(params)

    clips, me, mp = _microbatched(clips, me, mp, grad_accum)
    xs = (jnp.asarray(clips), tuple(map(jnp.asarray, me)), tuple(map(jnp.asarray, mp)))
    _, grads = jax.jit(lambda p, t, x: jaccum.scan_accumulate(
        loss_and_grads, p, t, x, jnp.zeros((), jnp.float32), grad_accum))(params, target, xs)
    return {k: _flat(grads[k]) for k in ("encoder", "predictor")}


def _port_step(grad_accum):
    """(state after one step, its metrics, the gradients the update used)."""
    _, _, params, target, clips, me, mp = _setup()
    enc = VisionTransformer(**ENC, use_flash=True)
    pred = VisionTransformerPredictor(**PRED, use_flash=True)
    hp = tpre.PretrainHParams(**HP)
    state = TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred))
    load_pretrain_state(state, params, target)
    grads = {}

    def keep_grads(opt_step, step):  # read the gradients the update is about to use
        for prefix in ("encoder", "predictor"):
            grads[prefix] = {k: p.grad.clone().numpy()
                             for k, p in getattr(state, prefix).named_parameters()}
        opt_step(step)

    state.optimizer.step = functools.partial(keep_grads, state.optimizer.step)
    if grad_accum > 1:
        clips, me, mp = _microbatched(clips, me, mp, grad_accum)
    metrics = tpre.make_train_step(hp, grad_accum=grad_accum)(
        state, torch.from_numpy(clips), [torch.from_numpy(m) for m in me],
        [torch.from_numpy(m) for m in mp])
    return state, metrics, grads


def _flat(tree):
    return {k: np.asarray(v) for k, v in state_dict_from_flax(tree).items()}


def _assert_states_close(state, grads, online, target, want_grads):
    """Gradients, then the online parameters where Adam's first step is not
    sensitive to fp32 noise in the gradient, then the EMA target."""
    for prefix, module in (("encoder", state.encoder), ("predictor", state.predictor)):
        for k, v in module.state_dict().items():
            g, want_g = grads[prefix][k], want_grads[prefix][k]
            tol = 1e-4 * np.abs(want_g).max()
            np.testing.assert_allclose(g, want_g, atol=1e-6 + tol, rtol=1e-4,
                                       err_msg=f"grad {prefix}.{k}")
            steady = np.abs(want_g) > 1e-3 * np.abs(want_g).max()
            np.testing.assert_allclose(v.numpy()[steady], online[prefix][k][steady], atol=1e-5,
                                       rtol=0, err_msg=f"{prefix}.{k}")
    for k, v in state.target_encoder.state_dict().items():
        np.testing.assert_allclose(v.numpy(), target[k], atol=1e-6, rtol=0, err_msg=k)


def test_accum2_matches_jax_accum2():
    state_j, metrics_j = _jax_step(2)
    state, metrics, grads = _port_step(2)
    np.testing.assert_allclose(metrics["loss"].item(), float(metrics_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(metrics_j["grad_norm"]),
                               rtol=1e-5)
    assert metrics["ema_momentum"] == pytest.approx(float(metrics_j["ema_momentum"]), rel=1e-7)
    online = {k: _flat(state_j.params[k]) for k in ("encoder", "predictor")}
    _assert_states_close(state, grads, online, _flat(state_j.target_params),
                         _jax_accumulated_grads(2))
    assert state.step == int(state_j.step) == 1


def test_accum2_matches_own_fullbatch_update():
    state1, m1, grads1 = _port_step(1)
    state2, m2, grads2 = _port_step(2)
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-5)
    online = {p: {k: v.numpy() for k, v in getattr(state1, p).state_dict().items()}
              for p in ("encoder", "predictor")}
    target = {k: v.numpy() for k, v in state1.target_encoder.state_dict().items()}
    _assert_states_close(state2, grads2, online, target, grads1)


class _Mesh:
    def __init__(self, data, fsdp):
        self.shape = {"data": data, "fsdp": fsdp}


@pytest.mark.parametrize("batch, accum", [(12, 5), (10, 4), (8, 3)])
def test_validate_grad_accum_errors_as_jax(batch, accum):
    with pytest.raises(AssertionError) as jax_err:
        jaccum.validate_grad_accum(batch, accum, _Mesh(1, 1))
    with pytest.raises(ValueError) as port_err:
        validate_grad_accum(batch, accum)
    assert str(port_err.value) == str(jax_err.value)


def test_validate_grad_accum_accepts_the_cooldown():
    validate_grad_accum(12, 6)  # `configs/train/vitl16/cooldown-256px-64f.yaml`: bs 12, A 6
    validate_grad_accum(16, 1)
