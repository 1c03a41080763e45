"""Public encoder factories (counterpart of the encoder half of
`vjepa2_tpu/hub/backbones.py:39 _make_vjepa2_model`, `:122-135`).

``vjepa2_vit_large/huge/giant/giant_384`` build the released encoder
architecture (RoPE on) on the card, in bf16, with the flash kernels on
(``device="cuda"``, ``use_flash=True``); without a CUDA device they raise
unless the caller passes ``device="cpu"`` (fp32 unless ``dtype`` says).
``checkpoint=<torch .pt>`` loads released weights by key, with no
conversion; otherwise the weights are drawn from ``generator``.
A factory returns the encoder alone: the predictor module is ported
(`models/predictor.py`), the factories' predictor half is not yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.models.vision_transformer import MODEL_REGISTRY, VisionTransformer

ARCH_NAME_MAP = {
    "vit_large": ("vit_large", "vitl"),
    "vit_huge": ("vit_huge", "vith"),
    "vit_giant": ("vit_giant_xformers", "vitg"),
    "vit_giant_384": ("vit_giant_xformers", "vitg-384"),
}


def encoder_state_dict(path: str, keys=("encoder", "target_encoder")) -> dict:
    """A torch checkpoint's encoder state dict: the entry of the first of
    ``keys`` it holds, else the whole file; ``module.`` and ``backbone.``
    prefixes dropped, the sincos ``pos_embed`` left out (recomputed)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = next((ckpt[k] for k in keys if k in ckpt), ckpt)
    sd = {k.replace("module.", "").replace("backbone.", ""): v for k, v in sd.items()}
    sd.pop("pos_embed", None)
    return sd


def load_encoder_checkpoint(encoder: VisionTransformer, path: str) -> None:
    """Load a released torch checkpoint's encoder into ``encoder`` by key
    ("encoder", else "target_encoder", else the whole file)."""
    encoder.load_state_dict(encoder_state_dict(path))


def _make_vjepa2_model(model_name: str = "vit_large", img_size: int = 256,
                       patch_size: int = 16, tubelet_size: int = 2, num_frames: int = 64,
                       checkpoint: Optional[str] = None, dtype=None, device="cuda",
                       generator: Optional[torch.Generator] = None, **kwargs):
    """``dtype`` None computes in bf16 on the card, which the flash kernels
    take, and in fp32 on the CPU."""
    arch = ARCH_NAME_MAP[model_name][0]
    device = entry_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    kwargs.setdefault("uniform_power", False)
    kwargs.setdefault("use_rope", True)
    kwargs.setdefault("use_flash", True)
    encoder = MODEL_REGISTRY[arch](patch_size=patch_size, img_size=(img_size, img_size),
                                   num_frames=num_frames, tubelet_size=tubelet_size,
                                   dtype=dtype, device=device, **kwargs)
    if checkpoint is None:
        encoder.reset_parameters(generator)
    else:
        load_encoder_checkpoint(encoder, checkpoint)
    return encoder


def vjepa2_vit_large(**kwargs):
    return _make_vjepa2_model(model_name="vit_large", img_size=256, **kwargs)


def vjepa2_vit_huge(**kwargs):
    return _make_vjepa2_model(model_name="vit_huge", img_size=256, **kwargs)


def vjepa2_vit_giant(**kwargs):
    return _make_vjepa2_model(model_name="vit_giant", img_size=256, **kwargs)


def vjepa2_vit_giant_384(**kwargs):
    return _make_vjepa2_model(model_name="vit_giant_384", img_size=384, **kwargs)
