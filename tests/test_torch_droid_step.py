"""The port's DROID train step (`train/droid.py`) against the JAX package's
`make_droid_train_step` (`vjepa2_tpu/train/droid.py:110`): a 2-layer
encoder of width 192 with 3 heads of 64 (RoPE) as the frozen target, the AC
predictor at width 128 with 2 heads of 64 and depth 2, 4 frames at 32 px
(4 tokens a frame), ``auto_steps`` 2, batch 2 (4 with ``grad_accum`` 2),
fp32. The same weights cross with `hub.converter.load_droid_state` from
JAX's `init_droid_params(..., train_encoder=True)`, which carries the
encoder copy the port leaves out; the same batches come from numpy with a
seed.

The port runs its flash routes (B1/B2's plain versions on the CPU: the
encoder's 4 tokens stack-padded to 8 with kv_valid, the predictor's 18 and
12 tokens to 24 and 16 with the pad keys on segment int32-max); JAX its XLA
attention, as `test_torch_pretrain_step.py` runs it.

Compared at each of 3 steps, from one state on both sides (after each step
the port's predictor and AdamW moments are set to JAX's): ``loss``,
``loss_teacher_forcing``, ``loss_rollout`` and ``grad_norm`` (rtol 1e-5);
the gradients entry by entry, through AdamW's first moment (rtol 1e-4 and
1e-6 of the leaf's largest entry, as `test_torch_pretrain_step.py` holds
gradients); the updated predictor weights, per leaf, within 1e-3 relative
L2 of the step's update (measured: at most 1.3e-4); and after the steps the
targets unchanged on both sides and JAX's encoder copy unchanged.

The weights are not held entry by entry at rtol 1e-5, nor run apart over
the steps: Adam's normalised update m / (sqrt(v) + eps) turns the fp32
rounding of a gradient near eps into a step of any size up to the lr, so
two implementations that round differently move those few entries
differently (up to 6e-5 in one step here, against weights of ~2e-2), and
the following steps amplify that (run apart, batch 4's third losses differ
by 1.3e-4 relative, though each step's gradients agree within 5e-7 of
each leaf's largest entry).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.core import schedulers as jsched
from vjepa2_tpu.models.ac_predictor import vit_ac_predictor as jax_ac_predictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.train import droid as jdroid
from vjepa2_tpu.train.state import TrainState as JaxState
from vjepa2_tpu_torch.core import schedulers
from vjepa2_tpu_torch.hub.converter import load_droid_state, state_dict_from_flax
from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.train import droid as tdroid
from vjepa2_tpu_torch.train.loop import IMAGENET_MEAN, IMAGENET_STD

S, T = 32, 4
ENC = dict(img_size=(S, S), patch_size=16, num_frames=2, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, uniform_power=True, use_rope=True)
PRED = dict(img_size=(S, S), patch_size=16, embed_dim=192, predictor_embed_dim=128, depth=2,
            num_heads=2)
HP = dict(lr=1e-3, start_lr=2e-4, final_lr=0.0, warmup_steps=2, anneal_steps=3,
          total_steps=8, auto_steps=2)
STEPS = 3
RTOL, UPDATE_REL_L2, GRAD_ATOL = 1e-5, 1e-3, 1e-6


@functools.lru_cache(maxsize=None)
def _jax_models(extrinsics):
    return (JaxViT(**ENC),
            jax_ac_predictor(**PRED, num_frames=2 * T, tubelet_size=2, use_extrinsics=extrinsics))


def _batches(batch, extrinsics, uint8=False, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        if uint8:
            clips = rs.randint(0, 255, (batch, T, S, S, 3)).astype(np.uint8)
        else:
            clips = rs.rand(batch, T, S, S, 3).astype(np.float32)
        out.append((clips, (rs.randn(batch, T - 1, 7) * 0.05).astype(np.float32),
                    rs.randn(batch, T, 7).astype(np.float32),
                    rs.randn(batch, T, 6).astype(np.float32) if extrinsics else None))
    return out


def _micro(x, a):
    return None if x is None else x.reshape(a, x.shape[0] // a, *x.shape[1:])


def _adam_moments(jstate) -> tuple[dict, dict]:
    """JAX's AdamW first and second moments of the predictor, by the port's
    parameter names."""
    adam = next(x for x in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))
    return (state_dict_from_flax(adam.mu["predictor"]),
            state_dict_from_flax(adam.nu["predictor"]))


def _steps_match_jax(batch, extrinsics=False, grad_accum=1, uint8=False):
    """3 steps of both from one state, each step's results compared, then
    the port's predictor and AdamW moments set to JAX's so that the next
    step starts from the same state on both sides."""
    jenc, jpred = _jax_models(extrinsics)
    hp = jdroid.DroidHParams(**HP, enc_lr_scale=1.0)
    params, target, tpf = jdroid.init_droid_params(jenc, jpred, 0, (batch, T, S, S, 3),
                                                   train_encoder=True)
    norm_stats = (IMAGENET_MEAN, IMAGENET_STD) if uint8 else None
    tx = jdroid.make_droid_optimizer(hp, params_like=params)
    jstate = JaxState(step=jnp.zeros([], jnp.int32), params=params, target_params=target,
                      opt_state=tx.init(params))
    jstep = jax.jit(jdroid.make_droid_train_step(
        jenc, jpred, tx, hp, tpf, norm_stats=norm_stats and tuple(
            np.asarray(v, np.float32) for v in norm_stats), grad_accum=grad_accum))

    enc = VisionTransformer(**ENC, use_flash=True).requires_grad_(False)
    pred = vit_ac_predictor(**PRED, use_flash=True, use_extrinsics=extrinsics)
    thp = tdroid.DroidHParams(**HP)
    state = tdroid.DroidState(0, pred, enc, tdroid.make_droid_optimizer(thp, pred))
    load_droid_state(state, params, target)
    assert tdroid.tokens_per_frame(enc) == tpf
    step = tdroid.make_droid_train_step(thp, tpf, norm_stats=norm_stats, grad_accum=grad_accum)

    for clips, actions, states, extr in _batches(batch, extrinsics, uint8):
        args = (clips, actions, states, extr)
        if grad_accum > 1:
            args = tuple(_micro(x, grad_accum) for x in args)
        before = {k: v.clone() for k, v in pred.state_dict().items()}
        jstate, jm = jstep(jstate, *(None if x is None else jnp.asarray(x) for x in args))
        tm = step(state, *(None if x is None else torch.from_numpy(x) for x in args))
        n = int(jstate.step)
        assert state.step == n
        for k in ("loss", "loss_teacher_forcing", "loss_rollout", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                       err_msg=f"{k} at step {n}")
        want = state_dict_from_flax(jstate.params["predictor"])
        mu, nu = _adam_moments(jstate)
        assert sorted(pred.state_dict()) == sorted(want)
        for k, p in pred.named_parameters():
            update = (want[k] - before[k]).norm()
            assert update > 0, k
            assert (p.detach() - want[k]).norm() <= UPDATE_REL_L2 * update, f"{k} at step {n}"
            # the gradients themselves, entry by entry, through the first moment
            m = state.optimizer.opt.state[p]
            np.testing.assert_allclose(m["exp_avg"].numpy(), mu[k].numpy(), rtol=1e-4,
                                       atol=GRAD_ATOL * mu[k].abs().max().item(),
                                       err_msg=f"{k} exp_avg at step {n}")
            with torch.no_grad():
                p.copy_(want[k])
                m["exp_avg"].copy_(mu[k])
                m["exp_avg_sq"].copy_(nu[k])
    # the frozen target on both sides, and JAX's encoder copy, unchanged
    for k, v in state_dict_from_flax(target).items():
        assert np.array_equal(enc.state_dict()[k].numpy(), v.numpy()), k
    for tree in (jstate.target_params, jstate.params["encoder"]):
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(target)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert state.step == STEPS


@pytest.mark.parametrize("extrinsics", [False, True], ids=["as", "ase"])
def test_droid_step_matches_jax(extrinsics):
    _steps_match_jax(2, extrinsics)


def test_droid_step_with_grad_accum_matches_jax():
    """``grad_accum`` 2: two microbatches of 2, one update."""
    _steps_match_jax(4, grad_accum=2)


def test_uint8_clips_match_jax():
    """uint8 clips normalised on the device with ``norm_stats``, as JAX's."""
    _steps_match_jax(2, uint8=True)


def test_feature_layernorm_matches_jax():
    h = np.random.RandomState(3).randn(2, 5, 48).astype(np.float32) * 3 + 1
    want = np.asarray(jdroid.feature_layernorm(jnp.asarray(h)))
    got = tdroid.feature_layernorm(torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jdroid.feature_layernorm(
        jnp.asarray(h, jnp.bfloat16))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tdroid.feature_layernorm(torch.from_numpy(h)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_the_rollout_gradient_reaches_the_teacher_forcing_call():
    """The rollout's first input frame is the teacher-forced prediction: its
    loss alone gives the predictor a gradient through both calls, which a
    detach at the concatenation would lose."""
    enc = VisionTransformer(**ENC, use_flash=True).requires_grad_(False)
    pred = vit_ac_predictor(**PRED, use_flash=True)
    gen = torch.Generator().manual_seed(0)
    enc.reset_parameters(gen)
    pred.reset_parameters(gen)
    clips, actions, states, _ = _batches(2, False)[0]
    hp = tdroid.DroidHParams(**HP)
    args = (pred, enc, hp, 4, torch.from_numpy(clips), torch.from_numpy(actions),
            torch.from_numpy(states))
    _, _, sloss = tdroid.droid_losses(*args)
    g_full = torch.autograd.grad(sloss, list(pred.parameters()))

    calls = []
    forward = pred.forward

    def detach_first(*a, **k):  # the teacher-forcing call's output, cut from the graph
        out = forward(*a, **k)
        calls.append(1)
        return out.detach() if len(calls) == 1 else out

    pred.forward = detach_first
    _, _, sloss_cut = tdroid.droid_losses(*args)
    g_cut = torch.autograd.grad(sloss_cut, list(pred.parameters()), allow_unused=True)
    assert sloss_cut.item() == sloss.item()
    diff = sum(((a - (0 if b is None else b)) ** 2).sum() for a, b in zip(g_full, g_cut))
    assert diff.sqrt() > 1e-3 * torch.sqrt(sum((a ** 2).sum() for a in g_full))


@pytest.mark.parametrize("step", [0, 1, 298, 299, 300, 301, 2998, 2999, 3000, 3001, 3598, 3599])
def test_wsd_lr_and_cosine_wd_at_the_shipped_config(step):
    """The schedules at the shipped DROID config's boundaries (ipe 300,
    warmup 1 -> 300 steps, anneal 2 -> 600, 12 epochs -> 3600 steps). JAX
    computes the lr in fp32 and the port in Python floats: near the end of
    the anneal the fp32 value rounds at ~2**-23 of the reference lr."""
    kw = dict(warmup_steps=300, anneal_steps=600, t_max=3600, start_lr=2e-5, ref_lr=4.25e-5,
              final_lr=0.0)
    assert schedulers.wsd_lr(step, **kw) == pytest.approx(float(jsched.wsd_lr(step, **kw)),
                                                          rel=1e-6, abs=1e-6 * kw["ref_lr"])
    wd = dict(ref_wd=0.04, t_max=3600, final_wd=0.4)
    assert schedulers.cosine_wd(step, **wd) == pytest.approx(float(jsched.cosine_wd(step, **wd)),
                                                             rel=1e-6)
