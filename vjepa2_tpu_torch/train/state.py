"""Train state for JEPA pretraining (counterpart of
`vjepa2_tpu/train/state.py:18`).

One object holds what the step touches: the online encoder and predictor,
the EMA target encoder (a deep copy of the encoder that takes no gradient)
and the optimizer. PyTorch updates them in place, so the step mutates the
state instead of returning a new one. ``step`` counts the updates made;
the schedules read it (the optimizer keeps no counter of its own).
`state_dict` / `load_state_dict` carry all of it for `core.checkpoint`.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch.nn as nn

from vjepa2_tpu_torch.core.optim import ScheduledAdamW


@dataclass
class TrainState:
    step: int
    encoder: nn.Module
    predictor: nn.Module
    target_encoder: nn.Module
    optimizer: ScheduledAdamW

    @classmethod
    def create(cls, encoder: nn.Module, predictor: nn.Module,
               optimizer: ScheduledAdamW) -> "TrainState":
        target = copy.deepcopy(encoder).requires_grad_(False)
        return cls(step=0, encoder=encoder, predictor=predictor, target_encoder=target,
                   optimizer=optimizer)

    def state_dict(self) -> dict:
        """The step, the three models' parameters and the optimizer's
        moments and counts."""
        return {"step": self.step, "encoder": self.encoder.state_dict(),
                "predictor": self.predictor.state_dict(),
                "target_encoder": self.target_encoder.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` into this state's tensors (bit-exact, onto
        their devices)."""
        self.step = int(state["step"])
        self.encoder.load_state_dict(state["encoder"])
        self.predictor.load_state_dict(state["predictor"])
        self.target_encoder.load_state_dict(state["target_encoder"])
        self.optimizer.load_state_dict(state["optimizer"])
