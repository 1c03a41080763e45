"""The port's hub (counterpart of `vjepa2_tpu/hub`): the model factories,
each returning (encoder, predictor) on the card by default, the converter
that carries the JAX package's parameter trees into the port's modules, the
serving export (`export`: `torch.export` programs that a serving process
loads with no model code) and the preprocessor. ``vjepa2_ac_vit_giant`` is
the planning entry: its pair goes into `planning.WorldModel`.

Each name is imported from its module on first use, so that loading an
exported program (`hub.export.load_encoder`) imports no model module."""

import importlib

_MODULE_OF = {
    "ARCH_NAME_MAP": "backbones",
    "vjepa2_vit_large": "backbones",
    "vjepa2_vit_huge": "backbones",
    "vjepa2_vit_giant": "backbones",
    "vjepa2_vit_giant_384": "backbones",
    "vjepa2_ac_vit_giant": "backbones",
    "state_dict_from_flax": "converter",
    "load_world_model_state": "converter",
    "export_encoder": "export",
    "load_encoder": "export",
    "export_world_model": "export",
    "load_world_model": "export",
    "ServingWorldModel": "export",
    "export_preprocessor_stats": "export",
    "Preprocessor": "preprocessor",
    "vjepa2_preprocessor": "preprocessor",
    "IMAGENET_MEAN": "transforms",
    "IMAGENET_STD": "transforms",
    "EvalVideoTransform": "transforms",
    "VideoTransform": "transforms",
    "ImageTransform": "transforms",
}

__all__ = list(_MODULE_OF)


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    package = "vjepa2_tpu_torch.data" if module == "transforms" else __name__
    return getattr(importlib.import_module(f"{package}.{module}"), name)
