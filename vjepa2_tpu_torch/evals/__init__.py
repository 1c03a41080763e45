"""Frozen evals (counterpart of `vjepa2_tpu/evals`): attentive-probe grids on
frozen features for video and image classification and EK100 action
anticipation, and the in-process evals during pretraining
(`evals/online.py`)."""

from vjepa2_tpu_torch.evals.action_anticipation import (
    AnticipationEval,
    ClassMeanRecall,
    MultiHeadAttentiveClassifier,
    anticipative_features,
    sigmoid_focal_loss,
)
from vjepa2_tpu_torch.evals.image_classification import ImageClassificationEval
from vjepa2_tpu_torch.evals.plugins import init_module
from vjepa2_tpu_torch.evals.probes import ProbeConfig, ProbeGrid, warmup_cosine_probe_configs
from vjepa2_tpu_torch.evals.video_classification import VideoClassificationEval
from vjepa2_tpu_torch.evals.wrappers import encode_clips, encode_multilevel, image_as_video

__all__ = [
    "AnticipationEval",
    "ClassMeanRecall",
    "MultiHeadAttentiveClassifier",
    "anticipative_features",
    "sigmoid_focal_loss",
    "ImageClassificationEval",
    "init_module",
    "ProbeConfig",
    "ProbeGrid",
    "warmup_cosine_probe_configs",
    "VideoClassificationEval",
    "encode_clips",
    "encode_multilevel",
    "image_as_video",
]
