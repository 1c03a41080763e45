"""One masked-pretrain train step of the port against the JAX package's
`make_train_step`, at small widths: encoder 192, 3 heads (Dh 64, the ViT-L
route), or encoder 160, 2 heads (Dh 80, the ViT-H route), depth 2; predictor
64, 2 heads (Dh 32), depth 2; RoPE; 4 frames at 64 px,
batch 2, fp32, the two mask configs of the pretrain headline
(`bench.py:56-61`) from the collator. Weights cross with
`state_dict_from_flax`.

The port runs its flash routes (the stack pad with kv_valid, and the plain
versions of B1/B2 through `FlashAttentionDN`, of B3 and the BHND backward
through `FlashAttentionBHND`, on the CPU); the JAX step runs with
``use_flash=False``: its interpret-mode backward kernels would triple this
file's time (55 s against 18 s on one core), and `test_torch_flash_dn_bwd.py`
and `test_torch_flash_bhnd_bwd.py` already hold the plain backwards to them.

Compared: the loss and the grad norm of the step (JAX's jitted step), every
gradient (JAX's `jax.grad` of the same loss, built from the package's
modules as `make_train_step:207-230` builds it), and the EMA target after the
step. Tolerance: fp32 throughout: loss and grad norm rtol 1e-5; gradients
atol 1e-6 + rtol 1e-4 of each leaf (sums over a few hundred terms); the EMA
target atol 1e-6: it moves by (1 - m) = 2e-3 of an Adam update of at most
~2 lr, and Adam's first update can flip sign on gradients at fp32 noise, so
the online parameters themselves are not compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.ops.masking import apply_mask as jax_apply_mask
from vjepa2_tpu.train import pretrain as jpre
from vjepa2_tpu.train.state import TrainState as JaxState
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.train import pretrain as tpre
from vjepa2_tpu_torch.train.state import TrainState

S, T, B = 64, 4, 2
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, uniform_power=True, use_rope=True, use_flash=True)
PRED = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
            predictor_embed_dim=64, depth=2, num_heads=2, uniform_power=True, use_rope=True,
            use_flash=True, use_mask_tokens=True, num_mask_tokens=2, zero_init_mask_tokens=False)
MASK_CFGS = [
    {"spatial_scale": (0.15, 0.15), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 8},
    {"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 2},
]
HP = dict(ipe=100, epochs=10, warmup_epochs=1)


def _flat(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def test_train_step_matches_jax():
    _step_matches_jax(ENC)


def test_vith_shaped_train_step_matches_jax():
    """The encoder at ViT-H's head width (80) takes the BHND route."""
    _step_matches_jax(dict(ENC, embed_dim=160, num_heads=2), dict(PRED, embed_dim=160))


def _step_matches_jax(enc_cfg, pred_cfg=PRED):
    coll = MaskCollator(MASK_CFGS, dataset_fpcs=[T], crop_size=(S, S))
    coll.step()
    masks_enc, masks_pred = coll(T, B)
    clips = np.random.RandomState(0).rand(B, T, S, S, 3).astype(np.float32)
    jclips = jnp.asarray(clips)
    jme, jmp = tuple(map(jnp.asarray, masks_enc)), tuple(map(jnp.asarray, masks_pred))

    jenc = JaxViT(**dict(enc_cfg, use_flash=False))
    jpred = JaxPredictor(**dict(pred_cfg, use_flash=False))
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
    state_j = JaxState.create(params, target, tx)
    step_j = jax.jit(jpre.make_train_step(jenc, jpred, tx, hp_j))
    state_j, metrics_j = step_j(state_j, jclips, jme, jmp)

    enc, pred = VisionTransformer(**enc_cfg), VisionTransformerPredictor(**pred_cfg)
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
    np.testing.assert_allclose(metrics["ema_momentum"], float(metrics_j["ema_momentum"]),
                               rtol=1e-7)
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
    assert state.step == 1 and int(state_j.step) == 1
