"""The port's probe grid (`vjepa2_tpu_torch/evals/probes.py`) against the JAX
package's (`vjepa2_tpu/evals/probes.py:39 ProbeGrid`): 3 `AttentiveClassifier`
probes of depth 2 (one self-attention block, then the cross-attention
block) at `vit_tiny`'s width (192, 3 heads), 10 classes, on numpy-seeded
features [4, 32, 192] (the token count of 4 frames at 64 px). The probes
differ in lr, start_lr, warmup, weight decay and final weight decay, over a
6-step schedule, so the warmup, the cosine lr and the cosine weight decay
all move. JAX's [P]-stacked params and optax Adam state cross with
`hub.converter.probe_grid_from_flax` and `adam_state_from_optax`.

Three steps, each started on the port from JAX's state: losses and
accuracies within rtol 1e-5; the Adam moments, which carry the gradients,
entry by entry within rtol 1e-4 plus 1e-6 of the leaf's largest entry (as
`tests/test_torch_droid_step.py` holds gradients), the counts equal; each
updated parameter leaf within 1e-3 relative L2 of the step's update
(measured: at most 9.4e-5), leaving out the key biases (the k third of a
self-attention ``qkv.bias``, the k half of a cross-attention ``kv.bias``):
softmax ignores a shift of every score of a row, so their gradient is 0 but
for rounding, and Adam turns that rounding into a step of ±lr on either
side; their gradients are held with the moments. The parameters are not
held entry by entry there: Adam's normalised update m / (sqrt(v) + eps)
turns two roundings of a gradient near 0 (one that cancels to about 0)
into steps of any size up to the lr (a few entries a step). The update rule itself is held entry by entry within rtol 1e-5
(atol 1e-9) given the same gradients: the port's Adam and decay against
optax's ``scale_by_adam`` and JAX's ``p - lr * (u + wd * p)`` with JAX's
schedules, from a state with non-zero moments. `eval_logits` within atol
2e-5 / rtol 1e-4 (the fp32 feature tolerance of
`tests/test_torch_slice.py`), `eval_correct` equal.
Config builders: equal to JAX's.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.cli import eval as jcli
from vjepa2_tpu.evals import probes as jprobes
from vjepa2_tpu_torch.cli import eval as tcli
from vjepa2_tpu_torch.evals import probes
from vjepa2_tpu_torch.hub.converter import adam_state_from_optax, probe_grid_from_flax

ROOT = Path(__file__).resolve().parents[1]
B, N, D, HEADS, CLASSES, STEPS = 4, 32, 192, 3, 10, 6
CONFIGS = [
    dict(lr=5e-3, weight_decay=0.01, final_wd=0.01),
    dict(lr=2e-3, start_lr=5e-4, warmup_steps=2, final_lr=1e-4, weight_decay=0.05,
         final_wd=0.2),
    dict(lr=1e-3, start_lr=1e-3, weight_decay=0.1, final_wd=None),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: 6 pytest workers with
    torch's default 8 threads each oversubscribe an 8-core host (see
    `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return rs.randn(B, N, D).astype(dtype), rs.randint(0, CLASSES, size=B)


@pytest.fixture(scope="module")
def grids():
    jgrid = jprobes.ProbeGrid([jprobes.ProbeConfig(**c) for c in CONFIGS], embed_dim=D,
                              num_classes=CLASSES, num_heads=HEADS, depth=2,
                              total_steps=STEPS, seed=0)
    tgrid = probes.ProbeGrid([probes.ProbeConfig(**c) for c in CONFIGS], embed_dim=D,
                             num_classes=CLASSES, num_heads=HEADS, depth=2,
                             total_steps=STEPS, seed=0)
    return jgrid, tgrid


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _to_port(params, opt):
    return probe_grid_from_flax(params), adam_state_from_optax(opt)


def key_bias(name: str, leaf: torch.Tensor, dim: int) -> torch.Tensor:
    """True on the key-bias entries of a [P, ...] leaf: the k third of a
    self-attention ``qkv.bias``, the k half of a cross-attention
    ``kv.bias`` (their gradient is 0 in exact arithmetic)."""
    mask = torch.zeros_like(leaf, dtype=torch.bool)
    if name.endswith("attn.qkv.bias"):
        mask[..., dim:2 * dim] = True
    elif name.endswith("xattn.kv.bias"):
        mask[..., :dim] = True
    return mask


def _close_moments(port: dict, want: dict) -> None:
    assert port.keys() == want.keys()
    for k in port:
        p, w = port[k].numpy(), want[k].numpy()
        np.testing.assert_allclose(p, w, rtol=1e-4, atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_train_steps_match_jax(grids):
    jgrid, tgrid = grids
    jparams, jopt, jstep = jgrid.init((N, D))
    jparams, jopt = _numpy(jparams), _numpy(jopt)
    for step in range(3):
        feats, labels = _features(step)
        params, opt = _to_port(jparams, jopt)
        before = {k: v.clone() for k, v in params.items()}
        params, opt, new_step, metrics = tgrid.train_step(
            params, opt, step, torch.from_numpy(feats), torch.from_numpy(labels))
        jparams, jopt, jstep, jm = jgrid.train_step(
            jparams, jopt, jstep, jnp.asarray(feats), jnp.asarray(labels))
        jparams, jopt = _numpy(jparams), _numpy(jopt)
        assert new_step == int(jstep) == step + 1
        np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(metrics["acc"].numpy(), np.asarray(jm["acc"]), rtol=1e-5)
        want_params, want_opt = _to_port(jparams, jopt)
        _close_moments(opt["mu"], want_opt["mu"])
        _close_moments(opt["nu"], want_opt["nu"])
        assert torch.equal(opt["count"], want_opt["count"])
        for k in params:
            keep = ~key_bias(k, params[k], D)
            update = (want_params[k] - before[k])[keep].norm()
            assert (params[k] - want_params[k])[keep].norm() <= 1e-3 * update, k


def test_update_rule_matches_jax_given_the_gradients(grids):
    """The port's `_adam` (bias-corrected Adam, then decay on every leaf with
    the probe's lr and cosine weight decay) against optax's and JAX's update
    expression, each probe from the same non-zero state and gradients."""
    from vjepa2_tpu.core import schedulers as jsched

    jgrid, tgrid = grids
    rs = np.random.RandomState(3)
    jparams, jopt, _ = jgrid.init((N, D))
    jparams = _numpy(jparams)
    noise = lambda tree, scale: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (rs.randn(*a.shape) * scale).astype(np.float32), tree)
    jopt = jopt._replace(mu=noise(jparams, 1e-3),
                         nu=jax.tree_util.tree_map(np.abs, noise(jparams, 1e-6)),
                         count=np.full(3, 4, np.int32))
    grads = noise(jparams, 1e-2)
    step = 4
    params, opt = _to_port(jparams, jopt)
    tgrads = probe_grid_from_flax(grads)
    for i in range(3):
        tgrid._adam(params, opt, i, {k: v[i] for k, v in tgrads.items()}, tgrid.lr(i, step),
                    tgrid.wd(i, step))
    slice_i = lambda tree, i: jax.tree_util.tree_map(lambda a: a[i], tree)  # noqa: E731
    for i in range(3):
        updates, _ = jgrid._adam.update(slice_i(grads, i), slice_i(jopt, i))
        lr = jsched.warmup_cosine_lr(step, warmup_steps=jgrid.warmups[i],
                                     start_lr=jgrid.start_lrs[i], ref_lr=jgrid.lrs[i],
                                     t_max=STEPS, final_lr=jgrid.final_lrs[i])
        wd = jsched.cosine_wd(step, ref_wd=jgrid.wds[i], t_max=STEPS,
                              final_wd=jgrid.final_wds[i])
        new = jax.tree_util.tree_map(lambda pp, u: pp - lr * (u + wd * pp),
                                     slice_i(jparams, i), updates)
        want = probe_grid_from_flax(jax.tree_util.tree_map(lambda a: np.asarray(a)[None], new))
        for k in want:
            np.testing.assert_allclose(params[k][i].numpy(), want[k][0].numpy(), rtol=1e-5,
                                       atol=1e-9, err_msg=f"probe {i} {k}")
    assert opt["count"].tolist() == [5, 5, 5]


def test_schedules_are_jax_per_probe(grids):
    """Each probe's lr and weight decay at every step of the schedule equal
    JAX's (`core/schedulers.py`, traced per probe under vmap)."""
    from vjepa2_tpu.core import schedulers as jsched

    jgrid, tgrid = grids
    for step in range(STEPS):
        lr = jsched.warmup_cosine_lr(step, warmup_steps=jgrid.warmups, start_lr=jgrid.start_lrs,
                                     ref_lr=jgrid.lrs, t_max=STEPS, final_lr=jgrid.final_lrs)
        wd = jsched.cosine_wd(step, ref_wd=jgrid.wds, t_max=STEPS, final_wd=jgrid.final_wds)
        np.testing.assert_allclose([tgrid.lr(i, step) for i in range(3)], np.asarray(lr),
                                   rtol=1e-6)
        np.testing.assert_allclose([tgrid.wd(i, step) for i in range(3)], np.asarray(wd),
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_eval_logits_and_correct_match_jax(grids, dtype):
    jgrid, tgrid = grids
    jparams, _, _ = jgrid.init((N, D))
    params = probe_grid_from_flax(_numpy(jparams))
    feats, labels = _features(7)
    jfeats = jnp.asarray(feats).astype(dtype)
    tfeats = torch.from_numpy(np.array(jfeats.astype(jnp.float32)))
    if dtype is jnp.bfloat16:
        tfeats = tfeats.to(torch.bfloat16)
    logits = tgrid.eval_logits(params, tfeats)
    want = np.asarray(jgrid.eval_logits(jparams, jfeats))
    assert logits.shape == (3, B, CLASSES) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(tgrid.eval_correct(params, tfeats, labels),
                                  jgrid.eval_correct(jparams, jfeats, jnp.asarray(labels)))


def test_init_layout_matches_jax(grids):
    """The port's own draws: JAX's tree, shapes and dtypes (its values
    cannot be drawn by torch), a zero Adam state and step 0."""
    jgrid, tgrid = grids
    jparams, jopt, _ = jgrid.init((N, D))
    params, opt, step = tgrid.init()
    want = probe_grid_from_flax(_numpy(jparams))
    assert step == 0 and params.keys() == want.keys()
    for k in params:
        assert params[k].shape == want[k].shape and params[k].dtype == torch.float32, k
        assert opt["mu"][k].abs().sum() == 0 and opt["nu"][k].abs().sum() == 0
    assert opt["count"].tolist() == [0, 0, 0]
    # each probe its own draw
    assert not torch.equal(params["pooler.query_tokens"][0], params["pooler.query_tokens"][1])


def test_warmup_cosine_probe_configs_match_jax():
    grid = [{"ref_lr": 1e-3, "final_lr": 1e-5, "ref_wd": 0.04},
            {"lr": 3e-4, "weight_decay": 0.1, "final_weight_decay": 0.3},
            {"ref_lr": 2e-3, "final_wd": 0.01}, {}]
    got = probes.warmup_cosine_probe_configs(grid)
    want = jprobes.warmup_cosine_probe_configs(grid)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]


@pytest.mark.parametrize("ipe", [1, 300])
def test_probe_configs_from_multihead_match_jax(ipe):
    import yaml

    with open(ROOT / "configs/eval/vitl/ssv2.yaml") as f:
        grid = yaml.safe_load(f)["experiment"]["optimization"]["multihead_kwargs"]
    grid = grid + [{"ref_lr": 1e-3, "warmup": 0.5, "final_wd": 0.2}, {}]
    got = tcli.probe_configs_from_multihead(grid, ipe)
    want = jcli.probe_configs_from_multihead(grid, ipe)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
