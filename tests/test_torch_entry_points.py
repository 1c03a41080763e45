"""Where the port's entry points build: `train.pretrain.build_models` and the
hub factories (`hub.backbones.vjepa2_vit_*`, each returning its encoder and
predictor) default to the card with the flash kernels on. With no CUDA device and no ``device=`` they raise, before
allocating anything, and never hand back a CPU model; ``device="cpu"``
builds a CPU model whose flash routes run the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.hub import backbones
from vjepa2_tpu_torch.models import vision_transformer as vt
from vjepa2_tpu_torch.train import pretrain as tp


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("factory", ["vjepa2_vit_large", "vjepa2_vit_huge", "vjepa2_vit_giant",
                                     "vjepa2_vit_giant_384", "vjepa2_ac_vit_giant"])
def test_hub_factories_raise_without_cuda(no_cuda, factory):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(backbones, factory)()


def test_hub_dtype_none_is_bf16_on_the_card_and_fp32_on_the_cpu(monkeypatch):
    """A documented difference: JAX's factories build in fp32 when ``dtype``
    is not given (`vjepa2_tpu/hub/backbones.py:46`, `:92`); the port's build
    in bf16 on the card, which its bf16 kernels serve fastest, and in fp32 on
    the CPU. ``dtype=torch.float32`` on the card is taken as given (the fp32
    flash kernels)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert backbones._placement("cuda", None) == (torch.device("cuda"), torch.bfloat16)
    assert backbones._placement("cuda", torch.float32) == (torch.device("cuda"), torch.float32)
    assert backbones._placement("cpu", None) == (torch.device("cpu"), torch.float32)


def test_build_models_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.build_models("vit_huge", crop_size=256, num_frames=16, pred_num_heads=12)


def test_build_models_on_the_cpu_when_asked():
    enc, pred = tp.build_models("vit_tiny", crop_size=32, num_frames=4, pred_depth=1,
                                pred_embed_dim=64, pred_num_heads=2, use_rope=True,
                                device="cpu")
    params = list(enc.parameters()) + list(pred.parameters())
    assert all(p.device.type == "cpu" for p in params)
    assert enc.use_flash and all(blk.attn.use_flash for blk in enc.blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("factory,route", [("vjepa2_vit_huge", "bhnd"),
                                           ("vjepa2_vit_large", "dn")])
def test_hub_factories_run_on_the_card_by_default(factory, route):
    """A factory called with no argument builds the full encoder and its
    predictor on the card in bf16, and a clip goes through the encoder: one
    flash launch per layer (B3 at ViT-H's Dh 80, B1 at ViT-L's Dh 64),
    finite bf16 features."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    from vjepa2_tpu_torch.ops import flash_attention as fa
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

    counter = {"bhnd": (fa, "LAUNCHES"), "dn": (fdn, "LAUNCHES")}[route]
    enc, pred = getattr(backbones, factory)()
    assert enc.dtype == pred.dtype == torch.bfloat16
    assert all(p.device.type == "cuda" for p in [*enc.parameters(), *pred.parameters()])
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 16, 256, 256, 3).astype(np.float32))
    before = getattr(*counter)
    with torch.inference_mode():
        out = enc(x.cuda())
    assert getattr(*counter) - before == len(enc.blocks)
    assert out.shape == (1, 2048, enc.embed_dim) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def test_hub_factory_on_the_cpu_when_asked(monkeypatch):
    """`vjepa2_vit_huge` (its architecture cut to one narrow layer at
    ViT-H's head width, 80) with ``device="cpu"``: a CPU encoder on the
    BHND flash route whose plain version runs, equal to the plain route."""
    monkeypatch.setitem(vt.MODEL_REGISTRY, "vit_huge", vt._factory(160, 1, 2, 4))
    enc, _ = backbones.vjepa2_vit_huge(num_frames=2, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    assert enc.blocks[0].attn.use_flash and enc.blocks[0].attn.head_dim == 80
    assert all(p.device.type == "cpu" for p in enc.parameters())
    plain, _ = backbones.vjepa2_vit_huge(num_frames=2, device="cpu", use_flash=False)
    plain.load_state_dict(enc.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 2, 256, 256, 3).astype(np.float32))
    with torch.no_grad():
        out, want = enc(x), plain(x)
    assert out.shape == (1, 256, 160)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-4)
