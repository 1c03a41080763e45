"""Attentive-probe training over a hyperparameter grid (counterpart of
`vjepa2_tpu/evals/probes.py`).

The reference trains its ~10-20 `AttentiveClassifier` probes, one per (lr,
wd) pair, as a Python loop of separate modules
(`evals/video_classification_frozen/eval.py:151-161,320-341`); JAX vmaps the
whole grid into one program. The port keeps JAX's layout, every parameter
and Adam moment stacked on a leading [P] axis (one tree for checkpoints and
the converter), and trains the probes one at a time, as the reference does:
a grid vmapped at full width would not fit on one card. On the card the
probes' fp32 self-attention runs the fp32 flash kernels (``use_flash``:
heads of 64 on the DN route, `ops.flash_attention_dn`, heads of 88 on the
BHND one, `ops.flash_attention`), which keep O(N) state a row: the plain route's
[B, H, N, N] probabilities (4.3 GB a block at the SSv2 eval's N = 4096,
batch 4, 16 heads; 87 GB at ViT-g/384 K400's N = 36,864) would not fit.

The function is JAX's: per-probe lr (`core.schedulers.warmup_cosine_lr`
from start_lr over warmup steps to lr, cosine to final_lr) and weight decay
(`cosine_wd` from weight_decay to final_wd), optax's ``scale_by_adam`` (b1
0.9, b2 0.999, eps 1e-8, bias-corrected) and the update
``p <- p - lr * (u + wd * p)`` on every leaf, biases, LayerNorms and the
query included (reference `eval.py:468-487`). The probe computes in fp32
whatever the features' dtype, as JAX's `AttentiveClassifier` default.
Subclasses change the objective, the decay rule or the weight-decay
schedule (`evals.action_anticipation.AnticipationGrid`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from vjepa2_tpu_torch.core.schedulers import cosine_wd, warmup_cosine_lr
from vjepa2_tpu_torch.models.attentive_pooler import AttentiveClassifier

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class ProbeConfig:
    lr: float
    weight_decay: float
    final_lr: float = 0.0
    start_lr: float | None = None  # defaults to lr (reference probes warm up from ref lr)
    warmup_steps: int = 0
    # cosine WD schedule endpoint (reference `CosineWDSchedule`,
    # `evals/video_classification_frozen/eval.py:518-535`); None = constant
    final_wd: float | None = None


class ProbeGrid:
    """A grid of `AttentiveClassifier` probes trained on frozen features.

    State is ``(params, opt, step)``: ``params`` maps each state-dict name of
    the probe to its [P, ...] stack, ``opt`` holds the stacked Adam moments
    ``mu`` and ``nu`` (same names) and ``count`` [P] int32, as optax's
    ``ScaleByAdamState``; ``step`` is the grid's 0-based step. On a card the
    probes' self-attention blocks take the flash route (`probe_flash`)."""

    def __init__(self, probe_configs: Sequence[ProbeConfig], embed_dim: int, num_classes: int,
                 num_heads: int = 12, depth: int = 1, total_steps: int = 1000, seed: int = 0,
                 device=None):
        model = AttentiveClassifier(embed_dim=embed_dim, num_heads=num_heads, depth=depth,
                                    num_classes=num_classes, device=device,
                                    use_flash=probe_flash(device))
        self._setup(model, probe_configs, total_steps, seed)

    def _setup(self, model: nn.Module, probe_configs, total_steps: int, seed: int) -> None:
        self.model = model.requires_grad_(False)
        self.configs = list(probe_configs)
        self.n = len(self.configs)
        self.total_steps = total_steps
        self.seed = seed
        self.device = next(model.parameters()).device

    # -- the rules a subclass may change ------------------------------------

    def lr(self, i: int, step: int) -> float:
        c = self.configs[i]
        return warmup_cosine_lr(step, warmup_steps=c.warmup_steps,
                                start_lr=c.lr if c.start_lr is None else c.start_lr,
                                ref_lr=c.lr, t_max=self.total_steps, final_lr=c.final_lr)

    def wd(self, i: int, step: int) -> float:
        c = self.configs[i]
        final = c.weight_decay if c.final_wd is None else c.final_wd
        return cosine_wd(step, ref_wd=c.weight_decay, t_max=self.total_steps, final_wd=final)

    def decays(self, leaf: torch.Tensor) -> bool:
        """Whether weight decay applies to one probe's ``leaf``: every leaf."""
        return True

    def objective(self, logits: torch.Tensor, labels: torch.Tensor):
        """(mean cross-entropy, accuracy) of one probe's logits."""
        loss = F.cross_entropy(logits.float(), labels)
        return loss, (logits.argmax(-1) == labels).float().mean()

    # -- state -----------------------------------------------------------------

    def init(self):
        """(params, opt, step): P probes drawn in turn from one
        ``torch.Generator`` seeded ``seed`` on the grid's device (JAX's
        vmapped init over split keys cannot be reproduced; weights cross
        from JAX with `hub.converter.probe_grid_from_flax`)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        draws = []
        for _ in range(self.n):
            self.model.reset_parameters(gen)
            draws.append({k: v.detach().clone() for k, v in self.model.state_dict().items()})
        params = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
        opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
               "nu": {k: torch.zeros_like(v) for k, v in params.items()},
               "count": torch.zeros(self.n, dtype=torch.int32, device=self.device)}
        return params, opt, 0

    def _probe(self, params, i: int, requires_grad: bool = False) -> dict:
        return {k: v[i].detach().requires_grad_(requires_grad) for k, v in params.items()}

    # -- steps -----------------------------------------------------------------

    def train_step(self, params, opt, step: int, feats: torch.Tensor, *targets):
        """One step of every probe on shared features [B, N, D]; ``targets``
        are what `objective` takes after the logits (labels [B]). Updates
        ``params`` and ``opt`` in place and returns (params, opt, step + 1,
        {"loss": [P], "acc": [P]}), the metrics fp32 on the grid's device."""
        losses, accs = [], []
        for i in range(self.n):
            p = self._probe(params, i, requires_grad=True)
            with torch.enable_grad():
                out = functional_call(self.model, p, (feats,))
                loss, acc = self.objective(out, *targets)
                grads = torch.autograd.grad(loss, list(p.values()))
            self._adam(params, opt, i, dict(zip(p, grads)), self.lr(i, step), self.wd(i, step))
            losses.append(loss.detach())
            if acc is not None:
                accs.append(acc.detach())
        metrics = {"loss": torch.stack(losses)}
        if accs:
            metrics["acc"] = torch.stack(accs)
        return params, opt, step + 1, metrics

    @torch.no_grad()
    def _adam(self, params, opt, i: int, grads: dict, lr: float, wd: float) -> None:
        """optax's ``scale_by_adam`` update of probe ``i``, then
        p <- p - lr * (u + wd * p) where `decays`."""
        opt["count"][i] += 1  # on the device: no host sync between probes
        count = opt["count"][i].float()
        bc1, bc2 = 1.0 - torch.pow(ADAM_B1, count), 1.0 - torch.pow(ADAM_B2, count)
        for name, g in grads.items():
            p, mu, nu = params[name][i], opt["mu"][name][i], opt["nu"][name][i]
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * g.square() + ADAM_B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            if self.decays(p):
                u = u + wd * p
            p.sub_(lr * u)

    @torch.no_grad()
    def eval_logits(self, params, feats: torch.Tensor):
        """[P, B, num_classes] logits (a tuple of them for a model with
        several heads) for frozen features."""
        outs = [functional_call(self.model, self._probe(params, i), (feats,))
                for i in range(self.n)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)

    def eval_correct(self, params, feats: torch.Tensor, labels) -> np.ndarray:
        """Per-probe #correct on a batch."""
        return count_correct(self.eval_logits(params, feats), labels)


def probe_flash(device) -> bool:
    """Whether probes on ``device`` take the flash route: on the card (the
    fp32 flash kernels), as `cli.eval.placement` decides for the encoder;
    on the CPU the plain route, as JAX's probes."""
    return device is not None and torch.device(device).type == "cuda"


def count_correct(logits: torch.Tensor, labels) -> np.ndarray:
    """Per-probe #correct of [P, B, C] logits against labels [B]."""
    labels = torch.as_tensor(labels, device=logits.device)
    return (logits.argmax(-1) == labels[None, :]).sum(-1).cpu().numpy()


def warmup_cosine_probe_configs(grid: Sequence[dict]) -> list[ProbeConfig]:
    """ProbeConfigs from the reference's ``multihead_kwargs`` grid (a list of
    {"ref_lr": ..., "final_lr": ..., "ref_wd": ...})."""
    out = []
    for g in grid:
        fwd = g.get("final_wd", g.get("final_weight_decay"))
        out.append(ProbeConfig(
            lr=float(g.get("ref_lr", g.get("lr", 1e-3))),
            weight_decay=float(g.get("ref_wd", g.get("weight_decay", 0.0))),
            final_lr=float(g.get("final_lr", 0.0)),
            final_wd=float(fwd) if fwd is not None else None))
    return out
