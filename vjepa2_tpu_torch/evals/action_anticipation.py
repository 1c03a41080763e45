"""EK100 action-anticipation frozen eval (counterpart of
`vjepa2_tpu/evals/action_anticipation.py`; reference
`evals/action_anticipation_frozen/`).

* `sigmoid_focal_loss` (reference `losses.py:9`);
* `ClassMeanRecall`: mean-class recall@k, accumulated in numpy (reference
  `metrics.py:12-59`; one process, so no cross-host reduction);
* `anticipative_features`: the encoder's tokens plus the predictor's at
  future positions given by each example's anticipation time, accumulated
  autoregressively (reference
  `modelcustom/vit_encoder_predictor_concat_ar.py:151-189`);
* `MultiHeadAttentiveClassifier`: a 3-query attentive probe emitting verb,
  noun and action logits (reference `models.py:19-68`);
* `AnticipationEval` with its own probe grid, `AnticipationGrid`: weight
  decay only on leaves of ndim >= 2 and constant (JAX
  `action_anticipation.py:224,284`), focal loss summed over the three heads.

JAX's ``use_focal=False`` (cross-entropy) and the ``lr`` / ``weight_decay``
fallback for a missing ``probe_configs`` have no caller and are not ported:
the launcher always passes the grid, and the loss is always the focal loss.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vjepa2_tpu_torch.core.checkpoint import load_params, save_params
from vjepa2_tpu_torch.core.distributed import global_sum
from vjepa2_tpu_torch.evals.probes import ProbeConfig, ProbeGrid, probe_flash
from vjepa2_tpu_torch.evals.video_classification import frozen_features
from vjepa2_tpu_torch.models.attentive_pooler import AttentivePooler
from vjepa2_tpu_torch.models.modules import init_linear_


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Focal BCE summed over classes, averaged over the batch.
    logits [B, K]; labels [B] int."""
    targets = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.sum() / logits.shape[0]


class ClassMeanRecall:
    def __init__(self, num_classes: int, k: int = 5):
        self.num_classes = num_classes
        self.k = k
        self.TP = np.zeros(num_classes)
        self.FN = np.zeros(num_classes)

    def update(self, logits, labels, valid_classes: Optional[set] = None) -> None:
        logits = np.asarray(logits)
        if valid_classes is not None:
            masked = np.zeros_like(logits)
            idx = np.asarray(sorted(valid_classes))
            masked[:, idx] = logits[:, idx]
            logits = masked
        preds = np.argsort(-logits, axis=1)[:, : self.k]
        labels = np.asarray(labels)
        hits = (preds == labels[:, None]).any(axis=1)
        np.add.at(self.TP, labels[hits], 1)
        np.add.at(self.FN, labels[~hits], 1)

    def compute(self, eps: float = 1e-8) -> dict:
        """Class-mean recall@k and accuracy over every process's counts (the
        TP / FN vectors summed over the processes, JAX
        `action_anticipation.py:71-76`)."""
        TP, FN = global_sum(self.TP), global_sum(self.FN)
        nch = max(1, int(((TP + FN) > 0).sum()))
        recall = 100.0 * float((TP / (TP + FN + eps)).sum()) / nch
        total = max(1, int((TP + FN).sum()))
        return {"recall": recall, "accuracy": 100.0 * float(TP.sum()) / total}


class MultiHeadAttentiveClassifier(nn.Module):
    """3 queries -> (verb, noun, action) heads, fp32. State-dict keys:
    ``pooler.*``, ``verb_head.*``, ``noun_head.*``, ``action_head.*``."""

    def __init__(self, embed_dim: int, num_heads: int, num_verbs: int, num_nouns: int,
                 num_actions: int, depth: int = 1, device=None, init_std: float = 0.02,
                 use_flash: bool = False):
        super().__init__()
        self.num_verbs, self.num_nouns, self.num_actions = num_verbs, num_nouns, num_actions
        self.init_std = init_std
        self.pooler = AttentivePooler(num_queries=3, embed_dim=embed_dim, num_heads=num_heads,
                                      depth=depth, device=device, init_std=init_std,
                                      use_flash=use_flash)
        self.verb_head = nn.Linear(embed_dim, num_verbs, device=device)
        self.noun_head = nn.Linear(embed_dim, num_nouns, device=device)
        self.action_head = nn.Linear(embed_dim, num_actions, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.pooler.reset_parameters(generator)
        for head in (self.verb_head, self.noun_head, self.action_head):
            init_linear_(head, self.init_std, 1.0, generator)

    def forward(self, x: torch.Tensor):
        q = self.pooler(x).float()  # [B, 3, D]
        return self.verb_head(q[:, 0]), self.noun_head(q[:, 1]), self.action_head(q[:, 2])


def anticipative_features(encoder, predictor, clips: torch.Tensor,
                          anticipation_times: torch.Tensor, frames_per_second: float,
                          tubelet_size: int = 2, grid_size: int = 16,
                          num_output_frames: int = 2, num_steps: int = 1,
                          h_patches: Optional[int] = None,
                          w_patches: Optional[int] = None) -> torch.Tensor:
    """Frozen features at future positions.

    clips [B, T, H, W, C]; anticipation_times [B] seconds. Returns
    [B, N + num_steps * N_pred, D]: the encoder's tokens, then each step's
    predicted tokens. The targets sit at ``N + tokens_per_frame * steps``
    onward, steps = int(time * fps / tubelet), so each example has its own
    positions (and the predictor its own RoPE tables). With ``num_steps >
    1`` the context slides forward while its positions stay ``arange(N)``,
    as in JAX and the reference.
    """
    x = encoder(clips)
    B, N, _ = x.shape
    hp = h_patches or grid_size
    wp = w_patches or grid_size
    tokens_per_frame = hp * wp
    dev = x.device
    ctxt_positions = torch.arange(N, device=dev).expand(B, N)
    times = torch.as_tensor(anticipation_times, dtype=torch.float32, device=dev)
    anticipation_steps = (times * frames_per_second / tubelet_size).to(torch.int32)
    skip = N + tokens_per_frame * anticipation_steps.long()  # [B]
    n_pred = tokens_per_frame * (max(num_output_frames, tubelet_size) // tubelet_size)
    tgt_positions = torch.arange(n_pred, device=dev)[None, :] + skip[:, None]

    accum, cur = [x], x
    for _ in range(num_steps):
        x_pred = predictor(cur, ctxt_positions, tgt_positions, 0, h_patches=hp, w_patches=wp)
        accum.append(x_pred)
        cur = torch.cat([cur[:, n_pred:], x_pred], dim=1)
    return torch.cat(accum, dim=1)


class AnticipationGrid(ProbeGrid):
    """The anticipation eval's grid of `MultiHeadAttentiveClassifier`
    probes: JAX's rules (`action_anticipation.py:270-290`), which differ from
    `ProbeGrid`'s in two ways: weight decay applies only to leaves of ndim
    >= 2, and it is each probe's constant ``weight_decay`` (no ``final_wd``).
    The loss is the focal loss summed over the heads. The route is
    `ProbeGrid`'s (the shipped probes have depth 1: no self-attention block,
    so no flash launch)."""

    def __init__(self, probe_configs, embed_dim: int, num_heads: int, num_verbs: int,
                 num_nouns: int, num_actions: int, total_steps: int = 1000, seed: int = 0,
                 device=None):
        model = MultiHeadAttentiveClassifier(embed_dim, num_heads, num_verbs, num_nouns,
                                             num_actions, device=device,
                                             use_flash=probe_flash(device))
        self._setup(model, probe_configs, total_steps, seed)

    def wd(self, i: int, step: int) -> float:
        return self.configs[i].weight_decay

    def decays(self, leaf: torch.Tensor) -> bool:
        return leaf.ndim >= 2

    def objective(self, logits, verbs, nouns, actions):
        return sum(sigmoid_focal_loss(lg, y) for lg, y in zip(logits, (verbs, nouns, actions))), None


class AnticipationEval:
    """EK100 anticipation runner (reference
    `evals/action_anticipation_frozen/eval.py`): a grid of 3-head probes, one
    per ``multihead_kwargs`` entry (reference `eval.py:125,230`), trained
    with focal loss on frozen anticipative features. Reports each head's
    best mean-class recall@k over probes (reference `eval.py:705-725`);
    the probe state checkpoints and restores (`eval.py:292-308`). The
    encoder and predictor hold their weights; the grid lives on the
    encoder's device."""

    def __init__(self, encoder, predictor, num_verbs: int, num_nouns: int, num_actions: int,
                 frames_per_second: float, probe_configs: Sequence[ProbeConfig],
                 total_steps: int = 1000, num_heads: int = 12, grid_size: int = 16,
                 h_patches: int | None = None, w_patches: int | None = None,
                 num_output_frames: int = 2, num_steps: int = 1, seed: int = 0):
        self.encoder, self.predictor = encoder, predictor
        self.device = next(encoder.parameters()).device
        self.grid = AnticipationGrid(probe_configs, encoder.embed_dim, num_heads, num_verbs,
                                     num_nouns, num_actions, total_steps, seed, self.device)
        self.model = self.grid.model
        self.n = self.grid.n
        self._probe_state = None  # (params [P, ...], opt, step)

        def extract(clips, times):
            return anticipative_features(
                encoder, predictor, clips, times, frames_per_second=frames_per_second,
                grid_size=grid_size, h_patches=h_patches, w_patches=w_patches,
                num_output_frames=num_output_frames, num_steps=num_steps)

        self._extract = extract

    def features(self, clips, anticipation_times) -> torch.Tensor:
        """Frozen anticipative features for a raw batch (no grad)."""
        return frozen_features(self._extract, self.device,
                               np.asarray(clips, np.float32), anticipation_times)

    def init_probes(self) -> None:
        self._probe_state = self.grid.init()

    def train_batch(self, clips, anticipation_times, verbs, nouns, actions) -> float:
        feats = self.features(clips, anticipation_times)
        if self._probe_state is None:
            self.init_probes()
        params, opt, step = self._probe_state
        targets = [torch.as_tensor(t, device=self.device) for t in (verbs, nouns, actions)]
        params, opt, step, metrics = self.grid.train_step(params, opt, step, feats, *targets)
        self._probe_state = (params, opt, step)
        return float(metrics["loss"].mean())

    def save_probes(self, path: str) -> None:
        """Checkpoint the probe grid: params, Adam state and step (reference
        `eval.py:305-308`)."""
        assert self._probe_state is not None, "no probe state to save"
        params, opt, step = self._probe_state
        save_params(path, {"params": params, "opt": opt, "step": step})

    def restore_probes(self, path: str) -> None:
        """Restore `save_probes`' state onto the grid's device."""
        saved = load_params(path)
        move = lambda d: {k: v.to(self.device) for k, v in d.items()}  # noqa: E731
        opt = {"mu": move(saved["opt"]["mu"]), "nu": move(saved["opt"]["nu"]),
               "count": saved["opt"]["count"].to(self.device)}
        self._probe_state = (move(saved["params"]), opt, int(saved["step"]))

    def evaluate(self, loader, k: int = 5, valid_action_classes=None) -> dict:
        assert self._probe_state is not None, (
            "evaluate() needs probe state: train first or restore_probes()")
        params = self._probe_state[0]
        heads = {"verb": self.model.num_verbs, "noun": self.model.num_nouns,
                 "action": self.model.num_actions}
        # one recall meter per (head, probe), reference `eval.py:618-621`
        metrics = {name: [ClassMeanRecall(n_cls, k=k) for _ in range(self.n)]
                   for name, n_cls in heads.items()}
        for clips, at, verbs, nouns, actions in loader:
            logits = self.grid.eval_logits(params, self.features(clips, at))
            for name, lg, labels in zip(heads, logits, (verbs, nouns, actions)):
                lg = lg.float().cpu().numpy()  # [P, B, n_cls]
                valid = valid_action_classes if name == "action" else None
                for pi in range(self.n):
                    metrics[name][pi].update(lg[pi], labels, valid_classes=valid)
        per_probe = {name: [m.compute() for m in meters] for name, meters in metrics.items()}
        out = {name: max(vals, key=lambda d: d["recall"]) for name, vals in per_probe.items()}
        out["per_probe"] = per_probe
        out["best_probe"] = {name: int(np.argmax([d["recall"] for d in vals]))
                             for name, vals in per_probe.items()}
        return out
