"""The port's models (counterpart of `vjepa2_tpu/models/__init__.py`); see the
package docstring of vjepa2_tpu_torch."""

from vjepa2_tpu_torch.models.ac_predictor import VisionTransformerPredictorAC, vit_ac_predictor
from vjepa2_tpu_torch.models.attentive_pooler import AttentiveClassifier, AttentivePooler
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor, vit_predictor
from vjepa2_tpu_torch.models.vision_transformer import (
    MODEL_REGISTRY,
    VIT_EMBED_DIMS,
    VisionTransformer,
    vit_base,
    vit_giant,
    vit_giant_rope,
    vit_giant_xformers,
    vit_giant_xformers_rope,
    vit_gigantic,
    vit_gigantic_xformers,
    vit_huge,
    vit_huge_rope,
    vit_large,
    vit_large_rope,
    vit_small,
    vit_synthetic,
    vit_tiny,
)

__all__ = [
    "MODEL_REGISTRY",
    "VIT_EMBED_DIMS",
    "VisionTransformer",
    "VisionTransformerPredictor",
    "VisionTransformerPredictorAC",
    "AttentiveClassifier",
    "AttentivePooler",
    "vit_predictor",
    "vit_ac_predictor",
]
