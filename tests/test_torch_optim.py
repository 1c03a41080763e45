"""The port's schedules, AdamW and EMA against the JAX package's
(`core/schedulers.py`, `core/optim.py`).

* The schedules over a sweep of steps across warmup, the cosine and the
  clamps: JAX evaluates them in fp32, the port in fp64, so they agree to a
  few fp32 roundings at the schedule's scale: rtol 1e-6 plus an atol of
  2**-21 times the largest value of the sweep (cancellation near final_lr).
* Three AdamW updates on a small parameter tree (a matrix, a bias, a
  [1, 1, P] mask token and a conv-shaped kernel) from identical given
  gradients, against `make_adamw`: weight decay only where ndim >= 2, lr and
  wd scheduled by the update count. Both are fp32 and differ only in the
  order of roundings: rtol 1e-6, atol 1e-7.
* `ema_update` against the JAX one: rtol 1e-6, atol 1e-7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vjepa2_tpu.core import optim as jopt
from vjepa2_tpu.core import schedulers as jsched
from vjepa2_tpu_torch.core import optim as topt
from vjepa2_tpu_torch.core import schedulers as tsched

STEPS = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150, 199, 200, 250]
SCHEDULES = {
    "warmup_cosine_lr": dict(warmup_steps=10, start_lr=2e-4, ref_lr=6.25e-4, t_max=200,
                             final_lr=1e-6),
    "cosine_wd": dict(ref_wd=0.04, t_max=200, final_wd=0.4),
    "cosine_wd_down": dict(ref_wd=0.4, t_max=200, final_wd=0.04),
    "wsd_lr": dict(warmup_steps=10, anneal_steps=50, t_max=200, start_lr=1e-4, ref_lr=1e-3,
                   final_lr=1e-6),
    "ema_momentum": dict(ema_start=0.998, ema_end=1.0, t_max=200),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    fn = name.removesuffix("_down")
    want = np.array([float(getattr(jsched, fn)(s, **SCHEDULES[name])) for s in STEPS])
    got = np.array([getattr(tsched, fn)(s, **SCHEDULES[name]) for s in STEPS])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2.0**-21 * np.abs(want).max(),
                               err_msg=name)


def _tree(rng):
    return {"w": rng.randn(4, 3), "b": rng.randn(3), "mask_token": rng.randn(1, 1, 5),
            "kernel": rng.randn(2, 3, 1, 2, 2)}


def test_adamw_matches_optax_on_given_gradients():
    rng = np.random.RandomState(0)
    params = {k: v.astype(np.float32) for k, v in _tree(rng).items()}
    grads = [{k: v.astype(np.float32) for k, v in _tree(rng).items()} for _ in range(3)]
    lr_fn = functools.partial(tsched.warmup_cosine_lr, **SCHEDULES["warmup_cosine_lr"])
    wd_fn = functools.partial(tsched.cosine_wd, **SCHEDULES["cosine_wd"])
    jlr = functools.partial(jsched.warmup_cosine_lr, **SCHEDULES["warmup_cosine_lr"])
    jwd = functools.partial(jsched.cosine_wd, **SCHEDULES["cosine_wd"])

    tx = jopt.make_adamw(jlr, jwd)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = topt.ScheduledAdamW(tparams.values(), lr_fn, wd_fn)
    assert topt.wd_mask(tparams.values()) == [True, False, True, True]
    for step, g in enumerate(grads):
        updates, opt_state = update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step(step)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    # the bias was not decayed: moving it by hand-applied decay would break the match
    assert not np.allclose(np.asarray(jparams["b"]), params["b"])


def test_ema_update_matches_jax():
    rng = np.random.RandomState(1)
    target = {k: v.astype(np.float32) for k, v in _tree(rng).items()}
    online = {k: v.astype(np.float32) for k, v in _tree(rng).items()}
    want = jopt.ema_update(jax.tree_util.tree_map(jnp.asarray, target),
                           jax.tree_util.tree_map(jnp.asarray, online), 0.9985)
    got = {k: torch.from_numpy(v.copy()) for k, v in target.items()}
    topt.ema_update(got.values(), [torch.from_numpy(online[k]) for k in got], 0.9985)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_global_norm_matches_optax():
    rng = np.random.RandomState(2)
    tree = {k: v.astype(np.float32) for k, v in _tree(rng).items()}
    want = float(optax.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = topt.global_norm([torch.from_numpy(v) for v in tree.values()]).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
