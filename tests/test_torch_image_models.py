"""The image (2D patch) encoder and predictor of the port, the sincos tables
resized off their grid, ``handle_nonsquare_inputs``, the predictor's
``chop_last_n_tokens`` / ``return_all_tokens``, ``vit_synthetic`` and
``VIT_EMBED_DIMS``, against the JAX package's modules: encoder width 192, 3
heads (Dh 64), depth 2; predictor width 64, 2 heads (Dh 32), depth 2; images
of 64 px (a 4 x 4 grid), or 80 and 48 px off it. Weights cross with
`hub.converter.state_dict_from_flax` (the image tokenizer's [p, p, C, D]
kernel into the Conv2d layout [D, C, p, p]), loaded strictly.

RoPE runs with ``use_flash`` (JAX's DN kernels in interpret mode under
`pltpu.force_tpu_interpret_mode()`; the port's plain versions through the
flash wrappers, the stack pad's kv_valid where the sequence is not a
multiple of 8), sincos without.

Tolerance: fp32 end to end, atol 2e-5, rtol 1e-4 (as
`test_torch_predictor.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vjepa2_tpu.models import vision_transformer as jvt
from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu_torch import models as tmodels
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models.patch_embed import PatchEmbed
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

ATOL, RTOL = 2e-5, 1e-4
S, B = 64, 2
ENC = dict(img_size=(S, S), patch_size=16, num_frames=1, embed_dim=192, depth=2, num_heads=3)
PRED = dict(img_size=(S, S), patch_size=16, num_frames=1, embed_dim=192,
            predictor_embed_dim=64, depth=2, num_heads=2, use_mask_tokens=True,
            num_mask_tokens=2, zero_init_mask_tokens=False)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def _images(h=S, w=S, seed=0, frames=None):
    shape = (B, h, w, 3) if frames is None else (B, frames, h, w, 3)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _masks(n_tokens, n_ctx, n_tgt, seed=2):
    rng = np.random.RandomState(seed)
    perms = [rng.permutation(n_tokens) for _ in range(B)]
    me = np.stack([np.sort(p[:n_ctx]) for p in perms]).astype(np.int32)
    mp = np.stack([np.sort(p[n_ctx:n_ctx + n_tgt]) for p in perms]).astype(np.int32)
    return me, mp


def _encoders(cfg, x, masks=None):
    """(JAX's output, the port's encoder with JAX's weights); JAX runs its
    flash route in interpret mode."""
    jenc = JaxViT(**cfg)
    args = (jnp.asarray(x),) + (() if masks is None else ([jnp.asarray(masks)],))
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(lambda *a: jenc.init(jax.random.PRNGKey(0), *a))(*args)
        want = jax.jit(lambda p, *a: jenc.apply(p, *a))(params, *args)
    enc = VisionTransformer(**cfg)
    enc.load_state_dict(state_dict_from_flax(params))
    return want, enc.eval()


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("pos", ["rope", "sincos"])
def test_image_encoder_matches_jax(pos, masked):
    """16 tokens; masked, 7 kept (stack-padded to 8 on the flash route)."""
    cfg = dict(ENC, use_rope=pos == "rope", use_flash=pos == "rope")
    x = _images()
    me = _masks(16, 7, 0)[0] if masked else None
    want, enc = _encoders(cfg, x, me)
    assert isinstance(enc.patch_embed, PatchEmbed) and not enc.is_video
    assert enc.patch_embed.proj.weight.shape == (192, 3, 16, 16)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), None if me is None else [torch.from_numpy(me)])
    assert got.shape == (B, 7 if masked else 16, 192)
    _close(got, want)


@pytest.mark.parametrize("size", [(80, 80), (48, 48), (80, 48)], ids=["grow", "shrink", "mixed"])
def test_image_sincos_table_off_grid_matches_jax(size):
    """An image off the 4 x 4 init grid: the 2D table resized bicubically
    (`vision_transformer.py:94-97`) to 5 x 5, 3 x 3 or 5 x 3."""
    x = _images(*size, seed=1)
    want, enc = _encoders(ENC, x)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got.shape == (B, (size[0] // 16) * (size[1] // 16), 192)
    _close(got, want)


@pytest.mark.parametrize("frames,size", [(8, 80), (2, 48), (4, 96)],
                         ids=["grow", "shrink", "space-only"])
def test_video_sincos_table_off_grid_matches_jax(frames, size):
    """A video off a 4-frame 64-px grid: the 3D table resized trilinearly
    (`vision_transformer.py:86-89`)."""
    cfg = dict(ENC, num_frames=4, tubelet_size=2, uniform_power=True)
    x = _images(size, size, seed=3, frames=frames)
    want, enc = _encoders(cfg, x)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("square", [True, False], ids=["nonsquare-handled", "square-grid"])
def test_handle_nonsquare_inputs_matches_jax(square):
    """A 64 x 96 image (4 x 6 patches) through RoPE: with
    ``handle_nonsquare_inputs=False`` the ids factor on the 4 x 4 init grid
    (`vision_transformer.py:178-179`), which changes the features."""
    cfg = dict(ENC, use_rope=True, use_flash=True, handle_nonsquare_inputs=square)
    x = _images(64, 96, seed=4)
    want, enc = _encoders(cfg, x)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    _close(got, want)
    enc.handle_nonsquare_inputs = not square
    with torch.no_grad():
        other = enc(torch.from_numpy(x))
    assert (other - got).abs().max() > 1e-3


def _predictors(cfg, z, me, mp):
    jpred = JaxPredictor(**cfg)
    args = tuple(map(jnp.asarray, (z, me, mp)))
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(lambda *a: jpred.init(jax.random.PRNGKey(1), *a, 1))(*args)
        want = jax.jit(lambda p, *a: jpred.apply(p, *a, 1))(params, *args)
    pred = VisionTransformerPredictor(**cfg)
    pred.load_state_dict(state_dict_from_flax(params))
    return want, pred.eval()


@pytest.mark.parametrize("pos", ["rope", "sincos"])
def test_image_predictor_matches_jax(pos):
    """7 context and 6 target tokens of a 4 x 4 grid: 13 stack-padded to 16
    on the flash route; the sincos table 2D (`predictor.py:61-68`)."""
    cfg = dict(PRED, use_rope=pos == "rope", use_flash=pos == "rope")
    me, mp = _masks(16, 7, 6)
    z = np.random.RandomState(5).randn(B, 7, 192).astype(np.float32)
    want, pred = _predictors(cfg, z, me, mp)
    with torch.no_grad():
        got = pred(torch.from_numpy(z), torch.from_numpy(me), torch.from_numpy(mp), 1)
    assert got.shape == (B, 6, 192)
    _close(got, want)


@pytest.mark.parametrize("chop", [0, 3])
@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
def test_return_all_tokens_and_chop_match_jax(video, chop):
    """``return_all_tokens`` gives every token the blocks saw in sorted
    order, ``chop_last_n_tokens`` dropping the last of them first
    (`predictor.py:133-135,202-206`)."""
    cfg = dict(PRED, use_rope=True, use_flash=True, return_all_tokens=True,
               chop_last_n_tokens=chop)
    n = 16
    if video:
        cfg.update(num_frames=4, tubelet_size=2)
        n = 32
    me, mp = _masks(n, 7, 6, seed=6)
    z = np.random.RandomState(7).randn(B, 7, 192).astype(np.float32)
    want, pred = _predictors(cfg, z, me, mp)
    with torch.no_grad():
        got = pred(torch.from_numpy(z), torch.from_numpy(me), torch.from_numpy(mp), 1)
    assert got.shape == (B, 13 - chop, 192)
    _close(got, want)


def test_chop_without_return_all_tokens_is_refused():
    """ROADMAP queue C, "The predictor's chop gather": with
    ``chop_last_n_tokens`` > 0 and ``return_all_tokens=False``, JAX's inverse
    gather reads past the chopped sequence and `take_along_axis` fills those
    rows with NaN (here the targets at the last two positions); the port
    refuses the combination."""
    cfg = dict(PRED, num_heads=1, chop_last_n_tokens=2)
    me = np.array([[0, 1, 2, 3, 4]] * B, dtype=np.int32)
    mp = np.array([[5, 6, 7]] * B, dtype=np.int32)  # sorted last: the chopped ones
    z = np.random.RandomState(8).randn(B, 5, 192).astype(np.float32)
    jpred = JaxPredictor(**cfg)
    args = tuple(map(jnp.asarray, (z, me, mp)))
    params = jax.jit(lambda *a: jpred.init(jax.random.PRNGKey(1), *a))(*args)
    out = np.asarray(jax.jit(jpred.apply)(params, *args))
    assert out.shape == (B, 3, 192)
    np.testing.assert_array_equal(np.isnan(out).all(-1), [[False, True, True]] * B)
    with pytest.raises(ValueError, match="return_all_tokens"):
        VisionTransformerPredictor(**cfg)


def test_vit_synthetic_and_embed_dims_match_jax():
    """``vit_synthetic`` (width 1, one head of 1) with RoPE and the plain
    route against JAX's; ``VIT_EMBED_DIMS`` as JAX's, exported from
    `vjepa2_tpu_torch.models` as JAX's `models/__init__.py` exports it."""
    assert tmodels.VIT_EMBED_DIMS == jvt.VIT_EMBED_DIMS
    assert set(jvt.MODEL_REGISTRY) <= set(tmodels.MODEL_REGISTRY) | {"vit_factory"}
    kw = dict(use_rope=True, num_frames=4, img_size=(32, 32))
    x = _images(32, 32, seed=9, frames=4)
    jenc = jvt.vit_synthetic(**kw)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(jenc.apply)(params, jnp.asarray(x))
    enc = tmodels.vit_synthetic(**kw)
    enc.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got.shape == (B, 8, 1)
    _close(got, want)
    with pytest.raises(NotImplementedError, match="head width 1"):
        tmodels.vit_synthetic(use_flash=True, **kw)


def test_image_patch_weight_placement_matches_jax():
    """The image tokenizer's Conv2d-layout weight takes the FSDP cut JAX's
    `param_spec` gives its [p, p, C, D] kernel (the largest dim: D)."""
    from jax.sharding import PartitionSpec

    from vjepa2_tpu.core.mesh import param_spec
    from vjepa2_tpu_torch.core.mesh import param_placement

    kernel = np.zeros((16, 16, 3, 192), np.float32)
    want = param_spec((jax.tree_util.DictKey("patch_embed"), jax.tree_util.DictKey("proj"),
                       jax.tree_util.DictKey("kernel")), kernel)
    assert want == PartitionSpec(None, None, None, "fsdp")
    assert param_placement("patch_embed.proj.weight", (192, 3, 16, 16)) == ("fsdp", None, None,
                                                                          None)
