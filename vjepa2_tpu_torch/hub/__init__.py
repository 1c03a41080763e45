"""The port's hub (counterpart of `vjepa2_tpu/hub`): the model factories,
each returning (encoder, predictor) on the card by default, and the
converter that carries the JAX package's parameter trees into the port's
modules. ``vjepa2_ac_vit_giant`` is the planning entry: its pair goes into
`planning.WorldModel`."""

from vjepa2_tpu_torch.hub.backbones import (
    ARCH_NAME_MAP,
    vjepa2_ac_vit_giant,
    vjepa2_vit_giant,
    vjepa2_vit_giant_384,
    vjepa2_vit_huge,
    vjepa2_vit_large,
)
from vjepa2_tpu_torch.hub.converter import load_world_model_state, state_dict_from_flax

__all__ = [
    "ARCH_NAME_MAP",
    "vjepa2_vit_large",
    "vjepa2_vit_huge",
    "vjepa2_vit_giant",
    "vjepa2_vit_giant_384",
    "vjepa2_ac_vit_giant",
    "state_dict_from_flax",
    "load_world_model_state",
]
