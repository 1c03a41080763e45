"""`vjepa2_tpu_torch.hub.converter.state_dict_from_flax` against the JAX
package's converters: a port state dict taken through the JAX package's
`convert_encoder` / `convert_predictor` / `convert_attentive_classifier` and
back is the identical set of tensors (the predictor's ``mask_tokens.{j}``
[1, 1, P] included); a checkpoint in the released layout loads into the port
by key.
"""

import pytest
import torch

from vjepa2_tpu.hub.converter import (convert_attentive_classifier, convert_encoder,
                                      convert_predictor)
from vjepa2_tpu_torch.hub.backbones import load_encoder_checkpoint
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models.attentive_pooler import AttentiveClassifier
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

ENC = dict(img_size=(32, 32), num_frames=4, embed_dim=48, depth=2, num_heads=2, use_rope=True)


def _encoder(seed):
    enc = VisionTransformer(**ENC)
    enc.reset_parameters(torch.Generator().manual_seed(seed))
    return enc


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_encoder_round_trip():
    sd = _encoder(0).state_dict()
    _assert_same(state_dict_from_flax(convert_encoder(sd)), sd)


def test_encoder_round_trip_at_vith_head_width():
    """Dh 80 (ViT-H's head width): the weights keep one layout whatever the
    attention route; the BHND flash route applies its q/k row permutation at
    use time, so the converted weights give the plain route's forward."""
    enc = VisionTransformer(**dict(ENC, embed_dim=160, use_flash=True))
    enc.reset_parameters(torch.Generator().manual_seed(5))
    sd = enc.state_dict()
    _assert_same(state_dict_from_flax(convert_encoder(sd)), sd)
    plain = VisionTransformer(**dict(ENC, embed_dim=160))
    plain.load_state_dict(state_dict_from_flax(convert_encoder(sd)))
    x = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        torch.testing.assert_close(enc(x), plain(x), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("complete_block", [True, False])
def test_classifier_round_trip(complete_block):
    clf = AttentiveClassifier(embed_dim=48, num_heads=2, depth=3, num_classes=7,
                              complete_block=complete_block)
    clf.reset_parameters(torch.Generator().manual_seed(1))
    sd = clf.state_dict()
    _assert_same(state_dict_from_flax(convert_attentive_classifier(sd)), sd)


@pytest.mark.parametrize("num_mask_tokens", [2, 4])
def test_predictor_round_trip(num_mask_tokens):
    pred = VisionTransformerPredictor(img_size=(32, 32), num_frames=4, embed_dim=48,
                                      predictor_embed_dim=32, depth=2, num_heads=2,
                                      use_rope=True, use_mask_tokens=True,
                                      num_mask_tokens=num_mask_tokens,
                                      zero_init_mask_tokens=False)
    pred.reset_parameters(torch.Generator().manual_seed(4))
    sd = pred.state_dict()
    assert sd["mask_tokens.1"].shape == (1, 1, 32)
    _assert_same(state_dict_from_flax(convert_predictor(sd)), sd)


def test_released_checkpoint_loads_by_key(tmp_path):
    src = _encoder(2).state_dict()
    path = tmp_path / "vitl.pt"
    torch.save({"encoder": {f"module.backbone.{k}": v for k, v in src.items()}}, path)
    enc = _encoder(3)
    load_encoder_checkpoint(enc, str(path))
    _assert_same(enc.state_dict(), src)
