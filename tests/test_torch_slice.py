"""The port's serving slice against the JAX package end to end: a video ViT
at `vit_tiny` widths (192, 3 heads, Dh 64; depth 2, built directly since the
factory fixes depth), 4 frames at 64 px, through `encode_clips`, then an
`AttentiveClassifier` of depth 2. Weights cross with
`hub.converter.state_dict_from_flax`; inputs come from numpy with a seed.

With RoPE and ``use_flash`` both sides take the DN route (JAX: the Pallas
kernel in interpret mode; the port: the wrapper's plain version on the CPU);
the RoPE plain route and the sincos encoder are held to the same standard.

Tolerance: fp32 end to end, the encoder tolerance of
`tests/models/test_flash_integration.py:27` (atol 2e-5, rtol 1e-4) for both
features and logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vjepa2_tpu.evals.wrappers import encode_clips as jax_encode_clips
from vjepa2_tpu.models.attentive_pooler import AttentiveClassifier as JaxClassifier
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.ops import flash_attention_dn as jfdn
from vjepa2_tpu_torch.evals.wrappers import encode_clips
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models.attentive_pooler import AttentiveClassifier
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

S, T, CLASSES = 64, 4, 10
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3)


# jitted JAX programs, built once and shared by the cases (compiles dominate here)
_jclf = JaxClassifier(embed_dim=192, num_heads=3, depth=2, num_classes=CLASSES)
_jclf_init = jax.jit(_jclf.init)
_jclf_apply = jax.jit(_jclf.apply)


@functools.lru_cache(maxsize=None)
def _jax_encoder_init(use_rope):
    return jax.jit(JaxViT(**ENC, use_rope=use_rope, uniform_power=True).init)


def _count_calls(monkeypatch, module):
    calls = []
    orig = module.flash_attention_bhdn
    monkeypatch.setattr(module, "flash_attention_bhdn",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


@pytest.mark.parametrize("encoder", ["rope_flash", "rope_plain", "sincos"])
def test_slice_matches_jax(encoder, monkeypatch):
    use_rope = encoder != "sincos"
    use_flash = encoder == "rope_flash"
    cfg = dict(ENC, use_rope=use_rope, uniform_power=True)
    clips = np.random.RandomState(0).rand(2, 1, T, S, S, 3).astype(np.float32)

    jenc = JaxViT(**cfg, use_flash=use_flash)
    enc_params = _jax_encoder_init(use_rope)(jax.random.PRNGKey(0), jnp.asarray(clips[:, 0]))
    jax_calls = _count_calls(monkeypatch, jfdn)
    with pltpu.force_tpu_interpret_mode():
        feats_j = jax.jit(lambda p, c: jax_encode_clips(jenc, p, c))(
            enc_params["params"], jnp.asarray(clips))
    clf_params = _jclf_init(jax.random.PRNGKey(1), feats_j)
    logits_j = _jclf_apply(clf_params, feats_j)

    enc = VisionTransformer(**cfg, use_flash=use_flash)
    enc.load_state_dict(state_dict_from_flax(enc_params))
    clf = AttentiveClassifier(embed_dim=192, num_heads=3, depth=2, num_classes=CLASSES)
    clf.load_state_dict(state_dict_from_flax(clf_params))
    port_calls = _count_calls(monkeypatch, fdn)
    with torch.inference_mode():
        feats = encode_clips(enc.eval(), torch.from_numpy(clips))
        logits = clf.eval()(feats)

    # both took the route under test: the DN kernel once per layer, or never
    want_calls = ENC["depth"] if use_flash else 0
    assert len(jax_calls) == len(port_calls) == want_calls
    assert logits.shape == (2, CLASSES) and logits.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_j), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), atol=2e-5, rtol=1e-4)

