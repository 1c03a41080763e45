"""The port's EK100 anticipation eval (`vjepa2_tpu_torch/evals/action_anticipation.py`)
against the JAX package's (`vjepa2_tpu/evals/action_anticipation.py`): the
focal loss, `ClassMeanRecall`, `MultiHeadAttentiveClassifier`,
`anticipative_features` and `AnticipationEval`'s grid step, at `vit_tiny`
widths: an encoder of depth 2 (192, 3 heads of 64, RoPE), 4 frames at 64 px
(32 tokens, a 4 x 4 grid), and a predictor of depth 2 at width 64 (2 heads
of 32, RoPE, 1 mask token). Weights cross with
`hub.converter.state_dict_from_flax` and `probe_grid_from_flax`; inputs
come from numpy with a seed.

`anticipative_features` runs the DN route on both sides (JAX: the Pallas
kernel in interpret mode; the port: B1's plain version on the CPU), with a
different anticipation time per example (1 s and 2 s at 2 fps: targets at
positions 48-63 and 64-79, beyond the clip's 32 tokens, so each example has
its own RoPE tables), at ``num_steps`` 1 and 2.

Tolerances: features and logits atol 2e-5 / rtol 1e-4 (fp32; the encoder
tolerance of `tests/models/test_flash_integration.py:27`); the focal loss
rtol 1e-6; recall exact (the same numpy); the grid step's losses rtol 1e-5,
its Adam moments and updates (the key biases left out of the update) as
`tests/test_torch_probes.py` holds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vjepa2_tpu.evals import action_anticipation as jant
from vjepa2_tpu.evals import probes as jprobes
from vjepa2_tpu.models.predictor import vit_predictor as jax_vit_predictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.ops import flash_attention_dn as jfdn
from vjepa2_tpu_torch.evals import action_anticipation as ant
from vjepa2_tpu_torch.evals import probes
from vjepa2_tpu_torch.hub.converter import (adam_state_from_optax, probe_grid_from_flax,
                                            state_dict_from_flax)
from vjepa2_tpu_torch.models.predictor import vit_predictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

S, T, FPS, GRID = 64, 4, 2.0, 4
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, use_rope=True, uniform_power=True)
PRED = dict(img_size=(S, S), num_frames=T, tubelet_size=2, embed_dim=192,
            predictor_embed_dim=64, depth=2, num_heads=2, use_mask_tokens=True,
            num_mask_tokens=1, use_rope=True)
HEADS = dict(num_verbs=5, num_nouns=7, num_actions=9)
TIMES = np.asarray([1.0, 2.0], np.float32)
ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: 6 pytest workers with
    torch's default 8 threads each oversubscribe an 8-core host (see
    `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params():
    clips = jnp.zeros((2, T, S, S, 3))
    enc_params = jax.jit(JaxViT(**ENC).init)(jax.random.PRNGKey(0), clips)["params"]
    x = JaxViT(**ENC).apply({"params": enc_params}, clips)
    pred_params = jax.jit(lambda k: jax_vit_predictor(**PRED).init(
        k, x, jnp.zeros((2, 32), jnp.int32), jnp.zeros((2, 16), jnp.int32), 0))(
        jax.random.PRNGKey(1))["params"]
    return enc_params, pred_params


def _models(use_flash: bool):
    enc_params, pred_params = _jax_params()
    jenc, jpred = JaxViT(**ENC, use_flash=use_flash), jax_vit_predictor(**PRED,
                                                                          use_flash=use_flash)
    enc = VisionTransformer(**ENC, use_flash=use_flash)
    enc.load_state_dict(state_dict_from_flax(enc_params))
    pred = vit_predictor(**PRED, use_flash=use_flash)
    pred.load_state_dict(state_dict_from_flax(pred_params))
    return (jenc, enc_params, jpred, pred_params), (enc.eval().requires_grad_(False),
                                                    pred.eval().requires_grad_(False))


def test_sigmoid_focal_loss_matches_jax():
    rs = np.random.RandomState(0)
    logits = (rs.randn(6, 9) * 3).astype(np.float32)
    labels = rs.randint(0, 9, size=6)
    for alpha in (0.25, -1.0):
        got = ant.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(labels), alpha)
        want = jant.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(labels), alpha)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("valid", [None, {0, 2, 3, 5}], ids=["all", "valid_classes"])
def test_class_mean_recall_matches_jax(valid):
    rs = np.random.RandomState(1)
    got, want = ant.ClassMeanRecall(8, k=3), jant.ClassMeanRecall(8, k=3)
    for _ in range(3):
        logits = rs.randn(5, 8).astype(np.float32)
        labels = rs.randint(0, 8, size=5)
        got.update(logits, labels, valid_classes=valid)
        want.update(logits, labels, valid_classes=valid)
    np.testing.assert_array_equal(got.TP, want.TP)
    np.testing.assert_array_equal(got.FN, want.FN)
    assert got.compute() == want.compute()


def test_multihead_classifier_matches_jax():
    jm = jant.MultiHeadAttentiveClassifier(embed_dim=192, num_heads=3, depth=2, **HEADS)
    x = np.random.RandomState(2).randn(2, 24, 192).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    m = ant.MultiHeadAttentiveClassifier(192, 3, depth=2, **HEADS)
    sd = state_dict_from_flax(params)
    assert {k.split(".")[0] for k in sd} == {"pooler", "verb_head", "noun_head", "action_head"}
    m.load_state_dict(sd)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    for g, w, n in zip(got, jm.apply(params, jnp.asarray(x)), HEADS.values()):
        assert g.shape == (2, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def _count_calls(monkeypatch, module):
    calls = []
    orig = module.flash_attention_bhdn
    monkeypatch.setattr(module, "flash_attention_bhdn",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


@pytest.mark.parametrize("num_steps", [1, 2])
def test_anticipative_features_match_jax_on_the_dn_route(num_steps, monkeypatch):
    (jenc, enc_params, jpred, pred_params), (enc, pred) = _models(use_flash=True)
    jax_calls, port_calls = _count_calls(monkeypatch, jfdn), _count_calls(monkeypatch, fdn)
    clips = np.random.RandomState(4).rand(2, T, S, S, 3).astype(np.float32)
    kw = dict(frames_per_second=FPS, grid_size=GRID, num_steps=num_steps, h_patches=GRID,
              w_patches=GRID)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda ep, pp, c, t: jant.anticipative_features(
            jenc, ep, jpred, pp, c, t, **kw))(enc_params, pred_params, jnp.asarray(clips),
                                              jnp.asarray(TIMES))
    with torch.inference_mode():
        got = ant.anticipative_features(enc, pred, torch.from_numpy(clips),
                                        torch.from_numpy(TIMES), **kw)
    # both took the DN route: once an encoder layer, once a predictor layer a step
    assert len(jax_calls) == len(port_calls) == 2 + 2 * num_steps
    assert got.shape == (2, 32 + num_steps * 16, 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # each example's targets at its own positions: the predicted tokens differ
    with torch.inference_mode():
        same = ant.anticipative_features(enc, pred, torch.from_numpy(clips),
                                         torch.ones(2), **kw)
    assert torch.equal(same[0, 32:48], got[0, 32:48])
    assert not torch.allclose(same[1, 32:48], got[1, 32:48])


def _anticipation_evals(configs):
    (jenc, enc_params, jpred, pred_params), (enc, pred) = _models(use_flash=False)
    kw = dict(frames_per_second=FPS, total_steps=6, num_heads=3, grid_size=GRID,
              h_patches=GRID, w_patches=GRID, **HEADS)
    jev = jant.AnticipationEval(jenc, enc_params, jpred, pred_params,
                                probe_configs=[jprobes.ProbeConfig(**c) for c in configs], **kw)
    ev = ant.AnticipationEval(enc, pred, probe_configs=[probes.ProbeConfig(**c)
                                                        for c in configs], **kw)
    return jev, ev


def _batch(seed, B=2):
    rs = np.random.RandomState(seed)
    clips = rs.rand(B, T, S, S, 3).astype(np.float32)
    v = rs.randint(0, 5, size=B)
    return clips, TIMES[:B], v, v % 7, v % 9


# cosine weight decay would move between steps here (final_wd far from the
# weight decay): the anticipation grid ignores it, as JAX's
CONFIGS = [dict(lr=5e-3, weight_decay=0.05, final_wd=0.5),
           dict(lr=1e-3, start_lr=2e-4, warmup_steps=2, weight_decay=0.2, final_wd=0.0)]


def test_anticipation_grid_decays_matrices_at_a_constant_rate():
    _, ev = _anticipation_evals(CONFIGS)
    grid = ev.grid
    assert [grid.wd(i, s) for i in range(2) for s in (0, 3, 5)] == [0.05] * 3 + [0.2] * 3
    params, _, _ = grid.init()
    decayed = {k for k, v in params.items() if grid.decays(v[0])}
    assert "verb_head.weight" in decayed and "pooler.query_tokens" in decayed
    assert not any(k.endswith("bias") or "norm" in k for k in decayed)


def test_anticipation_steps_match_jax():
    """Two steps of the grid (each from JAX's state) and an evaluation from
    the state after them."""
    jev, ev = _anticipation_evals(CONFIGS)
    for step in range(2):
        batch = _batch(10 + step)
        jev._ensure_state(jev.features_for(batch[0], batch[1]))
        params, opt, jstep = jax.tree_util.tree_map(np.array, jev._state)
        ev._probe_state = (probe_grid_from_flax(params), adam_state_from_optax(opt), int(jstep))
        before = {k: v.clone() for k, v in ev._probe_state[0].items()}
        loss = ev.train_batch(*batch)
        want_loss = jev.train_batch(*batch)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        params, opt, jstep = jax.tree_util.tree_map(np.array, jev._state)
        want_p, want_o = probe_grid_from_flax(params), adam_state_from_optax(opt)
        assert ev._probe_state[2] == int(jstep) == step + 1
        for k, v in ev._probe_state[0].items():
            for mom in ("mu", "nu"):
                w = want_o[mom][k].numpy()
                np.testing.assert_allclose(ev._probe_state[1][mom][k].numpy(), w, rtol=1e-4,
                                           atol=1e-6 * np.abs(w).max(), err_msg=k)
            keep = torch.ones_like(v, dtype=torch.bool)
            if k.endswith("xattn.kv.bias"):  # the key bias: gradient 0 but for rounding
                keep[..., :192] = False
            assert (v - want_p[k])[keep].norm() <= 1e-3 * (want_p[k] - before[k])[keep].norm(), k
    ev._probe_state = (want_p, want_o, int(jstep))
    val = [_batch(20), _batch(21)]
    got, want = ev.evaluate(val, k=2), jev.evaluate(val, k=2)
    assert got["best_probe"] == want["best_probe"]
    for head in ("verb", "noun", "action"):
        assert got[head] == want[head]
        assert got["per_probe"][head] == want["per_probe"][head]


def test_anticipation_probes_save_and_restore_bit_equal(tmp_path):
    _, ev = _anticipation_evals(CONFIGS)
    ev.train_batch(*_batch(30))
    path = str(tmp_path / "probes.pt")
    ev.save_probes(path)
    _, ev2 = _anticipation_evals(CONFIGS)
    ev2.restore_probes(path)
    (p, o, s), (p2, o2, s2) = ev._probe_state, ev2._probe_state
    assert s == s2 == 1 and torch.equal(o["count"], o2["count"])
    for k in p:
        assert torch.equal(p[k], p2[k]) and torch.equal(o["mu"][k], o2["mu"][k]), k
        assert torch.equal(o["nu"][k], o2["nu"][k]), k
