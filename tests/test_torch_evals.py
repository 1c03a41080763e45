"""The port's frozen-eval feature extractors and runners against the JAX
package's (`vjepa2_tpu/evals/wrappers.py`, `video_classification.py`,
`image_classification.py`): a video ViT at `vit_tiny` widths (192, 3 heads
of 64, RoPE; depth 2, built directly since the factory fixes depth), 4
frames at 64 px, on the plain route on both sides (the DN route's kernels
are held to JAX by `tests/test_torch_slice.py`); probes of depth 2 with 3
heads. Weights cross with `hub.converter.state_dict_from_flax` (encoder)
and `probe_grid_from_flax` / `adam_state_from_optax` (the grid); inputs
come from numpy with a seed.

Tolerances: fp32 end to end, the encoder tolerance of
`tests/models/test_flash_integration.py:27` (atol 2e-5, rtol 1e-4) for
features and logits; a train step's losses and accuracies within rtol 1e-5
(as `tests/test_torch_probes.py`); per-probe counts of correct answers
equal; a probe save and restore bit-equal.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.evals import image_classification as jimage
from vjepa2_tpu.evals import probes as jprobes
from vjepa2_tpu.evals import video_classification as jvideo
from vjepa2_tpu.evals import wrappers as jwrappers
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu_torch.evals import image_classification, probes, video_classification, wrappers
from vjepa2_tpu_torch.hub.converter import (adam_state_from_optax, probe_grid_from_flax,
                                            state_dict_from_flax)
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

S, T, CLASSES = 64, 4, 5
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, use_rope=True, uniform_power=True)
PROBES = [dict(lr=5e-3, weight_decay=0.01, final_wd=0.01),
          dict(lr=1e-3, start_lr=2e-4, warmup_steps=2, weight_decay=0.1, final_wd=0.3)]
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
def _jax_encoder_params(frames: int = T):
    init = jax.jit(JaxViT(**dict(ENC, num_frames=frames)).init)
    return init(jax.random.PRNGKey(0), jnp.zeros((1, frames, S, S, 3)))["params"]


def _encoders(out_layers=None, frames: int = T):
    params = _jax_encoder_params(frames)
    cfg = dict(ENC, num_frames=frames, out_layers=out_layers)
    jenc = JaxViT(**cfg)
    enc = VisionTransformer(**cfg)
    enc.load_state_dict(state_dict_from_flax(params))
    return jenc, params, enc.eval().requires_grad_(False)


def _clips(seed, B=2, nc=2):
    rs = np.random.RandomState(seed)
    clips = rs.rand(B, nc, T, S, S, 3).astype(np.float32)
    labels = rs.randint(0, CLASSES, size=B)
    # absolute frame indices, a different start per example and clip
    ci = (rs.randint(0, 40, size=(B, nc, 1)) + 3 * np.arange(T)).astype(np.int64)
    return clips, labels, ci


@pytest.mark.parametrize("use_pos_embed", [False, True])
def test_encode_clips_matches_jax(use_pos_embed):
    jenc, params, enc = _encoders()
    clips, _, ci = _clips(0)
    want = jwrappers.encode_clips(jenc, params, jnp.asarray(clips), jnp.asarray(ci),
                                  use_pos_embed=use_pos_embed)
    with torch.inference_mode():
        got = wrappers.encode_clips(enc, torch.from_numpy(clips), torch.from_numpy(ci),
                                    use_pos_embed=use_pos_embed)
    assert got.shape == (2, 2 * 32, 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_use_pos_embed_adds_the_table_per_tubelet():
    """The temporal table: row clip_indices[..., ::2] of the 1D sincos
    table, on each of that tubelet's 16 spatial tokens."""
    _, _, enc = _encoders()
    clips, _, ci = _clips(1)
    with torch.inference_mode():
        plain = wrappers.encode_clips(enc, torch.from_numpy(clips))
        embedded = wrappers.encode_clips(enc, torch.from_numpy(clips), torch.from_numpy(ci),
                                         use_pos_embed=True)
    from vjepa2_tpu_torch.models.pos_embs import get_1d_sincos_pos_embed

    table = get_1d_sincos_pos_embed(192, 10000).astype(np.float32)
    delta = (embedded - plain).reshape(2, 2, 2, 16, 192).numpy()  # [B, nc, T', S, D]
    want = table[ci[:, :, ::2]][:, :, :, None, :]
    np.testing.assert_allclose(delta, np.broadcast_to(want, delta.shape), atol=1e-5)


def test_out_layers_and_encode_multilevel_match_jax():
    jenc, params, enc = _encoders(out_layers=(0, 1))
    clips, _, _ = _clips(2)
    flat = clips[:, 0]
    want_taps = jenc.apply({"params": params}, jnp.asarray(flat))
    want = jwrappers.encode_multilevel(jenc, params, jnp.asarray(clips), (0, 1))
    with torch.inference_mode():
        taps = enc(torch.from_numpy(flat))
        got = wrappers.encode_multilevel(enc, torch.from_numpy(clips))
    assert isinstance(taps, list) and len(taps) == 2
    for t, w in zip(taps, want_taps):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    assert got.shape == (2, 2 * 2 * 32, 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the last tap is the plain forward's output
    _, _, plain = _encoders()
    with torch.inference_mode():
        np.testing.assert_array_equal(taps[1].numpy(), plain(torch.from_numpy(flat)).numpy())


@pytest.mark.parametrize("frames", [2, 3])
def test_image_as_video_matches_jax(frames):
    images = np.random.RandomState(3).rand(2, S, S, 3).astype(np.float32)
    got = wrappers.image_as_video(torch.from_numpy(images), frames)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwrappers.image_as_video(
        jnp.asarray(images), frames)))


VIDEO_KW = dict(num_classes=CLASSES, num_heads=3, probe_depth=2, total_steps=6)


@functools.lru_cache(maxsize=None)
def _jax_video_eval():
    """One JAX eval for the module: its jitted programs compile once (each
    test sets its probe state)."""
    jenc, params, _ = _encoders()
    return jvideo.VideoClassificationEval(
        encoder=jenc, enc_params=params,
        probe_configs=[jprobes.ProbeConfig(**c) for c in PROBES], **VIDEO_KW)


def _video_evals():
    _, _, enc = _encoders()
    ev = video_classification.VideoClassificationEval(
        encoder=enc, probe_configs=[probes.ProbeConfig(**c) for c in PROBES], **VIDEO_KW)
    return _jax_video_eval(), ev


def _sync_probes(jev, ev):
    """The port's probe state set to JAX's (its init draws cannot be
    reproduced)."""
    params, opt, step = jax.tree_util.tree_map(np.array, jev._probe_state)
    ev._probe_state = (probe_grid_from_flax(params), adam_state_from_optax(opt), int(step))


@pytest.mark.parametrize("feature_dtype", ["fp32", "bf16"])
def test_video_eval_train_and_eval_batches_match_jax(feature_dtype, monkeypatch):
    """A train step, then multi-view eval batches (1 and 3 views), from one
    probe state. With bf16, the frozen features are rounded to bf16 on both
    sides before an fp32 probe (JAX's same mix: bf16 in, fp32 LayerNorm and
    residual)."""
    jev, ev = _video_evals()
    if feature_dtype == "bf16":
        jfeat, feat = jev.features, ev.features
        monkeypatch.setattr(jev, "features", lambda *a: jfeat(*a).astype(jnp.bfloat16))
        monkeypatch.setattr(ev, "features", lambda *a: feat(*a).to(torch.bfloat16))
    clips, labels, ci = _clips(4)
    jev.init_probes(jev.features(clips, ci).shape[1:])
    _sync_probes(jev, ev)
    jm = jev.train_batch(clips, labels, ci)
    m = ev.train_batch(clips, labels, ci)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["acc"], jm["acc"], rtol=1e-5)
    _sync_probes(jev, ev)  # the eval from one state
    views = np.concatenate([_clips(5 + v)[0] for v in range(3)], axis=1)  # [B, 3*nc, ...]
    for num_views, batch in ((1, clips), (3, views)):
        got = ev.eval_batch(batch, labels, ci, num_views=num_views)
        want = jev.eval_batch(batch, labels, ci, num_views=num_views)
        np.testing.assert_array_equal(got, want)
    params = ev._probe_state[0]
    feats_t = ev.features(clips, ci)
    feats_j = jev.features(clips, ci)
    np.testing.assert_allclose(ev.grid.eval_logits(params, feats_t).numpy(),
                               np.asarray(jev.grid.eval_logits(jev._probe_state[0], feats_j)),
                               atol=ATOL, rtol=RTOL)


def test_video_eval_runs_and_restores_bit_equal(tmp_path):
    """`run` over a train and a val loader, then `save_probes` and
    `restore_probes` into a new eval: the params bit-equal and the same
    per-probe top-1."""
    _, ev = _video_evals()
    train = [_clips(10 + i) for i in range(2)]
    val = [_clips(20)]
    path = str(tmp_path / "probes.pt")
    out = ev.run(train, val, epochs=1, probe_ckpt=path)
    assert set(out) == {"top1_per_probe", "best_probe", "top1"}
    assert out["top1_per_probe"].shape == (2,) and 0.0 <= out["top1"] <= 1.0
    _, ev2 = _video_evals()
    ev2.restore_probes(path)
    for k, v in ev._probe_state[0].items():
        assert torch.equal(ev2._probe_state[0][k], v), k
    assert ev2._probe_state[2] == ev._probe_state[2] == 2
    out2 = ev2.run([], val, epochs=0)
    np.testing.assert_array_equal(out2["top1_per_probe"], out["top1_per_probe"])


def test_video_restore_keeps_the_adam_state_it_has(tmp_path):
    """`restore_probes` reads the params and the step; the Adam state is not
    saved, so an eval that has trained keeps its own moments and count, and
    one that has not starts them at zero (JAX's rule)."""
    _, ev = _video_evals()
    path = str(tmp_path / "probes.pt")
    ev.train_batch(*_clips(10))
    ev.save_probes(path)
    saved = {k: v.clone() for k, v in ev._probe_state[0].items()}
    ev.train_batch(*_clips(11))
    live = copy.deepcopy(ev._probe_state[1])
    ev.restore_probes(path)
    params, opt, step = ev._probe_state
    assert step == 1 and opt["count"].tolist() == [2, 2]
    for k, v in saved.items():
        assert torch.equal(params[k], v), k
        for moment in ("mu", "nu"):
            assert torch.equal(opt[moment][k], live[moment][k]), (moment, k)
    _, fresh = _video_evals()
    fresh.restore_probes(path)
    params, opt, step = fresh._probe_state
    assert step == 1 and not opt["count"].any()
    assert all(torch.equal(params[k], v) for k, v in saved.items())
    assert not any(v.any() for moment in ("mu", "nu") for v in opt[moment].values())


def test_image_eval_matches_jax():
    frames = 2
    jenc, params, enc = _encoders(frames=frames)
    kw = dict(num_classes=CLASSES, num_heads=3, probe_depth=2, total_steps=6,
              img_as_video_nframes=frames)
    jev = jimage.ImageClassificationEval(
        encoder=jenc, enc_params=params,
        probe_configs=[jprobes.ProbeConfig(**c) for c in PROBES], **kw)
    ev = image_classification.ImageClassificationEval(
        encoder=enc, probe_configs=[probes.ProbeConfig(**c) for c in PROBES], **kw)
    rs = np.random.RandomState(6)
    images = rs.rand(3, S, S, 3).astype(np.float32)
    labels = rs.randint(0, CLASSES, size=3)
    np.testing.assert_allclose(ev.features(images).numpy(), np.asarray(jev.features(images)),
                               atol=ATOL, rtol=RTOL)
    jev._probe_state = jev.grid.init((32, 192))
    _sync_probes(jev, ev)
    jm = jev.train_batch(images, labels)
    m = ev.train_batch(images, labels)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["acc"], jm["acc"], rtol=1e-5)
    _sync_probes(jev, ev)
    out = ev.run([], [(images, labels)], epochs=0)
    want = jev.run([], [(images, labels)], epochs=0)
    np.testing.assert_array_equal(out["top1_per_probe"], want["top1_per_probe"])
    assert out["best_probe"] == want["best_probe"]
