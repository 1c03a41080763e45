"""Frozen video-classification eval (counterpart of
`vjepa2_tpu/evals/video_classification.py`; reference
`evals/video_classification_frozen/eval.py`).

The frozen encoder's features (`wrappers.encode_clips`, or a plugin's
``extract``) train a `ProbeGrid`; ``run`` reports each probe's top-1 and the
best. Multi-view eval averages logits over spatial views. One process on one
card: JAX's cross-host ``global_sum`` (`core/distributed.py:105`) is the
identity here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vjepa2_tpu_torch.core.checkpoint import load_params, save_params
from vjepa2_tpu_torch.core.distributed import global_sum
from vjepa2_tpu_torch.core.logging import AverageMeter, get_logger
from vjepa2_tpu_torch.evals.probes import ProbeConfig, ProbeGrid, count_correct
from vjepa2_tpu_torch.evals.wrappers import encode_clips

logger = get_logger(__name__)


def frozen_features(extract: Callable, device, *batch) -> torch.Tensor:
    """``extract(*batch)`` on the card's copies of ``batch`` under
    `torch.inference_mode` (JAX's ``stop_gradient``), returned as an ordinary
    tensor, which the probes' autograd may save."""
    batch = [None if b is None else torch.as_tensor(b, device=device) for b in batch]
    with torch.inference_mode():
        feats = extract(*batch)
    return feats.clone()


def top1_result(correct: np.ndarray, total: int) -> dict:
    """Per-probe top-1 over every process's val shard: the counts are summed
    over the processes first (JAX `video_classification.py:135-140`,
    `image_classification.py:91-96`)."""
    correct = global_sum(correct)
    total = int(global_sum(np.int64(total)))
    top1 = correct / max(1, total)
    best = int(np.argmax(top1))
    return {"top1_per_probe": top1, "best_probe": best, "top1": float(top1[best])}


class ProbeCheckpoint:
    """`save_probes` / `restore_probes` of an eval's ``_probe_state`` (the
    video eval's, JAX's `video_classification.py:101-117`; the image eval
    takes the same)."""

    def save_probes(self, path: str) -> None:
        """Checkpoint the probe grid's params and step (reference checkpoints
        probes, `evals/video_classification_frozen/eval.py:225-238`)."""
        assert self._probe_state is not None, "no probe state to save"
        params, _, step = self._probe_state
        save_params(path, {"params": params, "step": step})

    def restore_probes(self, path: str) -> None:
        """Restore `save_probes`' params and step onto the grid's device.
        The Adam state is not saved: the eval's current moments and count
        are kept where it has trained, and are fresh only on a restore into
        an eval that has not (JAX's rule)."""
        if self._probe_state is None:
            self._probe_state = self.grid.init()
        _, opt, _ = self._probe_state
        saved = load_params(path)
        params = {k: v.to(self.device) for k, v in saved["params"].items()}
        self._probe_state = (params, opt, int(saved["step"]))


@dataclass
class VideoClassificationEval(ProbeCheckpoint):
    """Trains a probe grid on frozen features and evaluates top-1. The
    encoder holds its weights (JAX's ``enc_params`` goes away); the grid
    lives on the encoder's device."""

    encoder: torch.nn.Module
    num_classes: int
    probe_configs: Sequence[ProbeConfig]
    num_heads: int = 12
    probe_depth: int = 1
    total_steps: int = 1000
    use_pos_embed: bool = False
    seed: int = 0
    extract_fn: Optional[Callable] = None  # plugin wrapper: (clips, clip_indices) -> feats

    def __post_init__(self):
        self.device = next(self.encoder.parameters()).device
        self.grid = ProbeGrid(self.probe_configs, embed_dim=self.encoder.embed_dim,
                              num_classes=self.num_classes, num_heads=self.num_heads,
                              depth=self.probe_depth, total_steps=self.total_steps,
                              seed=self.seed, device=self.device)
        self._probe_state = None
        self._extract = self.extract_fn or (
            lambda clips, ci: encode_clips(self.encoder, clips, ci,
                                           use_pos_embed=self.use_pos_embed))

    def features(self, clips, clip_indices=None) -> torch.Tensor:
        """clips [B, nc, T, H, W, C] float32 -> frozen features (no grad)."""
        return frozen_features(self._extract, self.device, clips, clip_indices)

    def init_probes(self) -> None:
        self._probe_state = self.grid.init()

    def train_batch(self, clips, labels, clip_indices=None) -> dict:
        feats = self.features(clips, clip_indices)
        if self._probe_state is None:
            self.init_probes()
        params, opt, step = self._probe_state
        params, opt, step, metrics = self.grid.train_step(
            params, opt, step, feats, torch.as_tensor(labels, device=self.device))
        self._probe_state = (params, opt, step)
        return {k: v.cpu().numpy() for k, v in metrics.items()}

    def eval_batch(self, clips, labels, clip_indices=None, num_views: int = 1) -> np.ndarray:
        """Multi-view eval: clips [B, views*nc, T, H, W, C]; logits summed
        over views (reference `eval.py:317-331`). Returns per-probe #correct."""
        params = self._probe_state[0]
        logits = sum(self.grid.eval_logits(params, self.features(view, clip_indices))
                     for view in np.split(np.asarray(clips), num_views, axis=1))  # [P, B, C]
        return count_correct(logits, labels)

    def run(self, train_loader, val_loader, epochs: int = 1, num_views: int = 1,
            probe_ckpt: str | None = None) -> dict:
        """Full loop. Loaders yield (clips [B, nc, T, H, W, C], labels, clip_indices)."""
        for epoch in range(epochs):
            meter = AverageMeter()
            for clips, labels, ci in train_loader:
                m = self.train_batch(clips, labels, ci)
                meter.update(float(m["acc"].max()))
            logger.info("epoch %d train acc(max probe) %.4f", epoch, meter.avg)
            if probe_ckpt is not None:
                self.save_probes(probe_ckpt)
        total, correct = 0, None
        for clips, labels, ci in val_loader:
            c = self.eval_batch(clips, labels, ci, num_views=num_views)
            correct = c if correct is None else correct + c
            total += len(labels)
        return top1_result(correct, total)
