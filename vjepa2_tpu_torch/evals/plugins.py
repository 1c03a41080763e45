"""Model-wrapper plugin loading (counterpart of `vjepa2_tpu/evals/plugins.py`;
reference `evals/video_classification_frozen/models.py:14-44`).

Evals resolve their frozen-feature extractor by dotted module path from the
config (``model_kwargs.module_name``); the module must expose
``init_module(**kwargs) -> callable``. The built-in wrappers are registered
under the reference's names so its configs resolve without edits.

Contract: the returned callable is ``extract(clips, clip_indices=None)``
(the anticipation wrapper: ``extract(clips, anticipation_times)``) and
closes over the encoder (and predictor) modules. JAX's callables take the
parameter trees as their first argument, so that its jitted programs do not
embed them as constants; the port's modules hold their weights, so that
argument goes away.
"""

from __future__ import annotations

import importlib
from typing import Callable

_BUILTIN = {}


def register(name: str):
    def deco(fn):
        _BUILTIN[name] = fn
        return fn

    return deco


def init_module(module_name: str, **kwargs) -> Callable:
    """Resolve a wrapper factory by builtin name or dotted import path."""
    if module_name in _BUILTIN:
        return _BUILTIN[module_name](**kwargs)
    mod = importlib.import_module(module_name)
    if not hasattr(mod, "init_module"):
        raise AttributeError(f"{module_name} does not define init_module(...)")
    return mod.init_module(**kwargs)


@register("evals.video_classification_frozen.modelcustom.vit_encoder_multiclip")
def _multiclip(encoder=None, use_pos_embed: bool = False, **_):
    from vjepa2_tpu_torch.evals.wrappers import encode_clips

    def extract(clips, clip_indices=None):
        return encode_clips(encoder, clips, clip_indices, use_pos_embed=use_pos_embed)

    return extract


@register("evals.video_classification_frozen.modelcustom.vit_encoder_multiclip_multilevel")
def _multiclip_multilevel(encoder=None, out_layers=(), **_):
    """``out_layers`` must be the ones the encoder was built with (its
    forward returns the taps; `cli.eval.build_encoder` reads them from the
    same ``wrapper_kwargs``)."""
    from vjepa2_tpu_torch.evals.wrappers import encode_multilevel

    if tuple(out_layers) != tuple(encoder.out_layers or ()):
        raise ValueError(f"the encoder taps {encoder.out_layers}, the wrapper wants "
                         f"{tuple(out_layers)}")

    def extract(clips, clip_indices=None):
        return encode_multilevel(encoder, clips)

    return extract


@register("evals.image_classification_frozen.modelcustom.vit_encoder")
def _image_encoder(encoder=None, img_as_video_nframes: int = 2, **_):
    from vjepa2_tpu_torch.evals.wrappers import image_as_video

    def extract(images, clip_indices=None):
        return encoder(image_as_video(images, img_as_video_nframes))

    return extract


@register("evals.action_anticipation_frozen.modelcustom.vit_encoder_predictor_concat_ar")
def _anticipative(encoder=None, predictor=None, **kw):
    from vjepa2_tpu_torch.evals.action_anticipation import anticipative_features

    def extract(clips, anticipation_times):
        return anticipative_features(encoder, predictor, clips, anticipation_times, **kw)

    return extract
