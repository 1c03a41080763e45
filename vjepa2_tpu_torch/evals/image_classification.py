"""Frozen image-classification eval, IN1K-style (counterpart of
`vjepa2_tpu/evals/image_classification.py`; reference
`evals/image_classification_frozen/eval.py`).

Images are replicated into a fake clip so the *video* encoder tokenizes
them (the reference does this with a forward pre-hook,
`modelcustom/vit_encoder.py:56-66`), then the probe grid of
`evals.probes` trains on the frozen features. A val batch is one
`eval_batch` call; the probe state saves and restores as the video eval's
(`video_classification.ProbeCheckpoint`; JAX's image eval has neither).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from vjepa2_tpu_torch.core.logging import AverageMeter, get_logger
from vjepa2_tpu_torch.evals.probes import ProbeConfig, ProbeGrid
from vjepa2_tpu_torch.evals.video_classification import (
    ProbeCheckpoint,
    frozen_features,
    top1_result,
)
from vjepa2_tpu_torch.evals.wrappers import image_as_video

logger = get_logger(__name__)


@dataclass
class ImageClassificationEval(ProbeCheckpoint):
    encoder: torch.nn.Module
    num_classes: int = 1000
    probe_configs: Sequence[ProbeConfig] = ()
    num_heads: int = 12
    probe_depth: int = 1
    total_steps: int = 1000
    img_as_video_nframes: int = 2  # fake-frame count fed to the video encoder
    seed: int = 0
    extract_fn: Optional[Callable] = None  # plugin wrapper: (images, None) -> feats

    def __post_init__(self):
        self.device = next(self.encoder.parameters()).device
        self.grid = ProbeGrid(list(self.probe_configs), embed_dim=self.encoder.embed_dim,
                              num_classes=self.num_classes, num_heads=self.num_heads,
                              depth=self.probe_depth, total_steps=self.total_steps,
                              seed=self.seed, device=self.device)
        self._probe_state = None
        self._extract = self.extract_fn or (
            lambda imgs, _ci: self.encoder(image_as_video(imgs, self.img_as_video_nframes)))

    def features(self, images) -> torch.Tensor:
        return frozen_features(self._extract, self.device, images, None)

    def train_batch(self, images, labels) -> dict:
        feats = self.features(images)
        if self._probe_state is None:
            self._probe_state = self.grid.init()
        params, opt, step = self._probe_state
        params, opt, step, metrics = self.grid.train_step(
            params, opt, step, feats, torch.as_tensor(labels, device=self.device))
        self._probe_state = (params, opt, step)
        return {k: v.cpu().numpy() for k, v in metrics.items()}

    def eval_batch(self, images, labels):
        """Per-probe #correct on a batch."""
        return self.grid.eval_correct(self._probe_state[0], self.features(images), labels)

    def run(self, train_loader, val_loader, epochs: int = 1) -> dict:
        for epoch in range(epochs):
            meter = AverageMeter()
            for images, labels in train_loader:
                m = self.train_batch(images, labels)
                meter.update(float(m["acc"].max()))
            logger.info("epoch %d train acc(max probe) %.4f", epoch, meter.avg)
        total, correct = 0, None
        for images, labels in val_loader:
            c = self.eval_batch(images, labels)
            correct = c if correct is None else correct + c
            total += len(labels)
        return top1_result(correct, total)
