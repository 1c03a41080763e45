"""Public model factories (counterpart of `vjepa2_tpu/hub/backbones.py`;
reference `src/hub/backbones.py`).

``vjepa2_vit_large/huge/giant/giant_384`` build the (encoder, predictor)
pair of the released checkpoints: the encoder with RoPE, the predictor 12
deep, 384 wide, 12 heads, 10 mask tokens, RoPE. ``vjepa2_ac_vit_giant``
builds the V-JEPA 2-AC pair that planning runs on: the 22-head ViT-g and the
24 x 1024 action-conditioned predictor (`planning.WorldModel` takes both).

Each factory builds on the card, in bf16, with the flash kernels on
(``device="cuda"``, ``use_flash=True``); without a CUDA device it raises
unless the caller passes ``device="cpu"`` (fp32 there unless ``dtype``
says). ``dtype=torch.float32`` on the card computes in fp32 on the fp32
flash kernels, as JAX's factories do by default (`vjepa2_tpu/hub/
backbones.py:46`, `:92`): ``vjepa2_ac_vit_giant(dtype=torch.float32)`` plans
at fp32, the AC predictor's frame-causal attention included.
``checkpoint=<torch .pt>`` loads released weights by key, with no
conversion: ``module.`` / ``backbone.`` prefixes dropped, as JAX's
``clean_prefixes`` does (`vjepa2_tpu/hub/converter.py:31-36`). Otherwise the
weights are drawn from ``generator``. The modules hold their weights, so
where JAX returns ((encoder, params), (predictor, params)) the port returns
(encoder, predictor), as the reference's torch hub does.
"""

from __future__ import annotations

from typing import Optional

import torch

from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.models.ac_predictor import VisionTransformerPredictorAC, vit_ac_predictor
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor, vit_predictor
from vjepa2_tpu_torch.models.vision_transformer import MODEL_REGISTRY, VisionTransformer

ARCH_NAME_MAP = {
    "vit_large": ("vit_large", "vitl"),
    "vit_huge": ("vit_huge", "vith"),
    "vit_giant": ("vit_giant_xformers", "vitg"),
    "vit_ac_giant": ("vit_giant_xformers", "vjepa2-ac-vitg"),
    "vit_giant_384": ("vit_giant_xformers", "vitg-384"),
}


def module_state_dict(state_dict: dict) -> dict:
    """A checkpoint entry as the port's modules name it: ``module.`` and
    ``backbone.`` dropped from every key, the sincos tables (``pos_embed``,
    ``predictor_pos_embed``) left out, as the modules recompute them."""
    sd = {k.replace("module.", "").replace("backbone.", ""): v for k, v in state_dict.items()}
    for key in ("pos_embed", "predictor_pos_embed"):
        sd.pop(key, None)
    return sd


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def encoder_state_dict(path: str, keys=("encoder", "target_encoder")) -> dict:
    """A torch checkpoint's encoder state dict: the entry of the first of
    ``keys`` it holds, else the whole file (`module_state_dict`)."""
    ckpt = load_checkpoint(path)
    return module_state_dict(next((ckpt[k] for k in keys if k in ckpt), ckpt))


def load_encoder_checkpoint(encoder: VisionTransformer, path: str) -> None:
    """Load a released torch checkpoint's encoder into ``encoder`` by key
    ("encoder", else "target_encoder", else the whole file)."""
    encoder.load_state_dict(encoder_state_dict(path))


def _encoder(model_name: str, img_size: int, patch_size: int, tubelet_size: int,
             num_frames: int, dtype, device, **kwargs) -> VisionTransformer:
    """The released encoder architecture: RoPE, no uniform power, flash on
    unless ``kwargs`` say otherwise."""
    kwargs.setdefault("uniform_power", False)
    kwargs.setdefault("use_rope", True)
    kwargs.setdefault("use_flash", True)
    return MODEL_REGISTRY[ARCH_NAME_MAP[model_name][0]](
        patch_size=patch_size, img_size=(img_size, img_size), num_frames=num_frames,
        tubelet_size=tubelet_size, dtype=dtype, device=device, **kwargs)


def _placement(device, dtype):
    """(device, dtype): ``dtype`` None computes in bf16 on the card, which
    the flash kernels take, and in fp32 on the CPU."""
    device = entry_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return device, dtype


def _make_vjepa2_model(model_name: str = "vit_large", img_size: int = 256,
                       patch_size: int = 16, tubelet_size: int = 2, num_frames: int = 64,
                       checkpoint: Optional[str] = None, dtype=None, device="cuda",
                       generator: Optional[torch.Generator] = None, **kwargs
                       ) -> tuple[VisionTransformer, VisionTransformerPredictor]:
    """(encoder, predictor); ``kwargs`` go to the encoder (JAX `:39-82`).
    The checkpoint's "encoder" (else "target_encoder", else the whole file)
    loads into the encoder and its "predictor", where present, into the
    predictor; a predictor the file lacks is drawn from ``generator``."""
    device, dtype = _placement(device, dtype)
    encoder = _encoder(model_name, img_size, patch_size, tubelet_size, num_frames, dtype,
                       device, **kwargs)
    predictor = vit_predictor(
        img_size=(img_size, img_size), patch_size=patch_size, num_frames=num_frames,
        tubelet_size=tubelet_size, embed_dim=encoder.embed_dim, predictor_embed_dim=384,
        depth=12, num_heads=12, num_mask_tokens=10, use_mask_tokens=True, use_rope=True,
        uniform_power=False, use_flash=encoder.use_flash, dtype=dtype, device=device)
    if checkpoint is None:
        encoder.reset_parameters(generator)
        predictor.reset_parameters(generator)
        return encoder, predictor
    ckpt = load_checkpoint(checkpoint)
    enc_sd = next((ckpt[k] for k in ("encoder", "target_encoder") if k in ckpt), ckpt)
    encoder.load_state_dict(module_state_dict(enc_sd))
    if "predictor" in ckpt:
        predictor.load_state_dict(module_state_dict(ckpt["predictor"]))
    else:
        predictor.reset_parameters(generator)
    return encoder, predictor


def _make_vjepa2_ac_model(model_name: str = "vit_ac_giant", img_size: int = 256,
                          patch_size: int = 16, tubelet_size: int = 2, num_frames: int = 64,
                          checkpoint: Optional[str] = None, dtype=None, device="cuda",
                          generator: Optional[torch.Generator] = None, **kwargs
                          ) -> tuple[VisionTransformer, VisionTransformerPredictorAC]:
    """(encoder, AC predictor) with JAX's defaults (`:85-119`): the AC
    predictor 24 deep, 1024 wide, 16 heads, no extrinsics, at the encoder's
    width. It takes its frame count at call time, so ``num_frames`` and
    ``tubelet_size`` shape the encoder only (JAX's module stores both and
    reads neither). The checkpoint's "encoder" and "predictor" load by
    key."""
    device, dtype = _placement(device, dtype)
    encoder = _encoder(model_name, img_size, patch_size, tubelet_size, num_frames, dtype,
                       device, **kwargs)
    predictor = vit_ac_predictor(img_size=(img_size, img_size), patch_size=patch_size,
                                 embed_dim=encoder.embed_dim, use_flash=encoder.use_flash,
                                 dtype=dtype, device=device)
    if checkpoint is None:
        encoder.reset_parameters(generator)
        predictor.reset_parameters(generator)
    else:
        ckpt = load_checkpoint(checkpoint)
        encoder.load_state_dict(module_state_dict(ckpt["encoder"]))
        predictor.load_state_dict(module_state_dict(ckpt["predictor"]))
    return encoder, predictor


def vjepa2_vit_large(**kwargs):
    return _make_vjepa2_model(model_name="vit_large", img_size=256, **kwargs)


def vjepa2_vit_huge(**kwargs):
    return _make_vjepa2_model(model_name="vit_huge", img_size=256, **kwargs)


def vjepa2_vit_giant(**kwargs):
    return _make_vjepa2_model(model_name="vit_giant", img_size=256, **kwargs)


def vjepa2_vit_giant_384(**kwargs):
    return _make_vjepa2_model(model_name="vit_giant_384", img_size=384, **kwargs)


def vjepa2_ac_vit_giant(**kwargs):
    return _make_vjepa2_ac_model(model_name="vit_ac_giant", img_size=256, **kwargs)
