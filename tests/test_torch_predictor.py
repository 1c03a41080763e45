"""The masked `VisionTransformer` and the `VisionTransformerPredictor` of the
port against the flax modules of the JAX package: encoder width 192, 3
heads, depth 2; predictor width 64, 2 heads (Dh 32), depth 2. Weights cross
with `hub.converter.state_dict_from_flax`, inputs and masks come from numpy
with a seed.

Cases: RoPE with ``use_flash`` (JAX: the DN Pallas kernel in interpret mode
under `pltpu.force_tpu_interpret_mode()`, as `tests/test_torch_slice.py`
runs it; the port: the plain versions on the CPU) and sincos without flash.
8 frames at 64 px give 64 tokens. The masks keep 21 context and 22 target
tokens, so the port stack-pads the encoder's 21 tokens to 24 and the
predictor's 43 to 48 and masks the pad keys with kv_valid (no padded length
equals a head width: see `test_torch_flash_dn_bwd.py::
test_tables_with_n_equal_to_d_are_token_major`); one config draws its masks
from the collator instead.

Tolerance: fp32 end to end, atol 2e-5, rtol 1e-4 (the encoder tolerance of
`tests/models/test_flash_integration.py:27`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

S, T, B = 64, 8, 2
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, uniform_power=True)
PRED = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
            predictor_embed_dim=64, depth=2, num_heads=2, uniform_power=True,
            use_mask_tokens=True, num_mask_tokens=2, zero_init_mask_tokens=False)
N_TOKENS = (T // 2) * (S // 16) ** 2


def _masks(source):
    """([B, Nc], [B, Np]) int32: disjoint context and target ids per example."""
    if source == "collator":
        coll = MaskCollator([{"spatial_scale": (0.3, 0.3), "num_blocks": 2}],
                            dataset_fpcs=[T], crop_size=(S, S), seed=1)
        coll.step()
        (me,), (mp,) = coll(T, B)
        return me, mp
    rng = np.random.RandomState(2)
    perms = [rng.permutation(N_TOKENS) for _ in range(B)]
    me = np.stack([np.sort(p[:21]) for p in perms]).astype(np.int32)
    mp = np.stack([np.sort(p[21:43]) for p in perms]).astype(np.int32)
    return me, mp


@functools.lru_cache(maxsize=None)
def _jax_models(use_rope, use_flash):
    return (JaxViT(**ENC, use_rope=use_rope, use_flash=use_flash),
            JaxPredictor(**PRED, use_rope=use_rope, use_flash=use_flash))


@pytest.mark.parametrize("route,source", [("rope_flash", "fixed"), ("rope_flash", "collator"),
                                          ("sincos", "fixed")])
def test_masked_encoder_and_predictor_match_jax(route, source):
    use_rope = use_flash = route == "rope_flash"
    me, mp = _masks(source)
    clips = np.random.RandomState(0).rand(B, T, S, S, 3).astype(np.float32)
    jenc, jpred = _jax_models(use_rope, use_flash)
    with pltpu.force_tpu_interpret_mode():
        enc_params = jax.jit(lambda k, c, m: jenc.init(k, c, [m]))(
            jax.random.PRNGKey(0), jnp.asarray(clips), jnp.asarray(me))
        z_j = jax.jit(lambda p, c, m: jenc.apply(p, c, [m]))(enc_params, jnp.asarray(clips),
                                                              jnp.asarray(me))
        pred_params = jax.jit(lambda k, z, a, b: jpred.init(k, z, a, b, 1))(
            jax.random.PRNGKey(1), z_j, jnp.asarray(me), jnp.asarray(mp))
        out_j = jax.jit(lambda p, z, a, b: jpred.apply(p, z, a, b, 1))(
            pred_params, z_j, jnp.asarray(me), jnp.asarray(mp))

    enc = VisionTransformer(**ENC, use_rope=use_rope, use_flash=use_flash)
    enc.load_state_dict(state_dict_from_flax(enc_params))
    pred = VisionTransformerPredictor(**PRED, use_rope=use_rope, use_flash=use_flash)
    pred.load_state_dict(state_dict_from_flax(pred_params))
    with torch.no_grad():
        z = enc(torch.from_numpy(clips), [torch.from_numpy(me)])
        out = pred(z, torch.from_numpy(me), torch.from_numpy(mp), mask_index=1)
    assert z.shape == (B, me.shape[1], 192) and out.shape == (B, mp.shape[1], 192)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5, rtol=1e-4)


def test_stack_pad_leaves_real_tokens_unchanged():
    """The padded flash route and the unpadded plain route give the same
    tokens: pad keys are masked, pad rows sliced off."""
    me, mp = _masks("fixed")
    clips = torch.from_numpy(np.random.RandomState(4).rand(B, T, S, S, 3).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    flash = VisionTransformer(**ENC, use_rope=True, use_flash=True)
    flash.reset_parameters(gen)
    plain = VisionTransformer(**ENC, use_rope=True, use_flash=False)
    plain.load_state_dict(flash.state_dict())
    pf = VisionTransformerPredictor(**PRED, use_rope=True, use_flash=True)
    pf.reset_parameters(gen)
    pp = VisionTransformerPredictor(**PRED, use_rope=True, use_flash=False)
    pp.load_state_dict(pf.state_dict())
    with torch.no_grad():
        outs = [p(e(clips, [torch.from_numpy(me)]), torch.from_numpy(me), torch.from_numpy(mp))
                for e, p in ((flash, pf), (plain, pp))]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=2e-5, rtol=1e-4)
