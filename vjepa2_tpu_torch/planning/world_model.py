"""The latent world model for planning (counterpart of
`vjepa2_tpu/planning/world_model.py:22 WorldModel`; reference
`notebooks/utils/world_model_wrapper.py`).

``encode`` embeds one RGB frame with the frozen encoder (the frame
duplicated into a 2-frame tubelet); ``infer_next_action`` runs the CEM
(`planning.cem`) over the action-conditioned predictor, on the device that
holds the models. The port's modules carry their own weights, so where
JAX's constructor takes (module, params) pairs this one takes the modules.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from vjepa2_tpu_torch.planning.cem import CEMConfig, Sampler, make_cem
from vjepa2_tpu_torch.train.droid import feature_layernorm


class WorldModel:
    def __init__(self, encoder: nn.Module, predictor: nn.Module, tokens_per_frame: int,
                 preprocessor=None, cem_config: CEMConfig = CEMConfig(),
                 normalize_reps: bool = True):
        self.encoder = encoder
        self.predictor = predictor
        self.tokens_per_frame = tokens_per_frame
        self.preprocessor = preprocessor
        self.cem_config = cem_config
        self.normalize_reps = normalize_reps
        self._cem = make_cem(self.step_fn, cem_config)

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    def step_fn(self, reps: torch.Tensor, actions: torch.Tensor,
                poses: torch.Tensor) -> torch.Tensor:
        """reps [S, T*N, D], actions and poses [S, T, 7] -> the next frame's
        tokens [S, N, D] (JAX `world_model.py:44-50`)."""
        nxt = self.predictor(reps, actions, poses)[:, -self.tokens_per_frame:]
        return feature_layernorm(nxt) if self.normalize_reps else nxt

    def encode_frame(self, frame: torch.Tensor) -> torch.Tensor:
        """frame [H, W, 3] fp32, preprocessed, on the models' device -> [N, D]
        tokens (JAX's ``_encode_impl``, `world_model.py:54`): the frame
        duplicated into a 2-frame tubelet, encoded, and normalised with
        ``normalize_reps``. A function of its tensor alone, which
        `hub.export.export_world_model` traces."""
        clip = frame[None, None].expand(1, 2, *frame.shape)  # [1, 2, H, W, C]
        h = self.encoder(clip)[0]
        return feature_layernorm(h) if self.normalize_reps else h

    def encode(self, image) -> torch.Tensor:
        """image [H, W, 3] uint8 (or preprocessed float) -> [N, D] tokens on
        the models' device (fp32 with ``normalize_reps``, else the encoder's
        dtype)."""
        if self.preprocessor is not None:
            image = self.preprocessor(np.asarray(image)[None])[0]
        frame = torch.as_tensor(image).to(device=self.device, dtype=torch.float32)
        with torch.inference_mode():
            return self.encode_frame(frame)

    def infer_next_action(self, rep, pose, goal_rep, generator: Optional[torch.Generator] = None,
                          sampler: Optional[Sampler] = None) -> np.ndarray:
        """rep and goal_rep [N, D]; pose [7] -> the planned actions
        [rollout, 7]. The noise comes from ``generator`` (on the models'
        device; seeded 0 when None), or from ``sampler`` (`planning.cem`)."""
        rep = torch.as_tensor(rep, device=self.device)
        goal_rep = torch.as_tensor(goal_rep, device=self.device)
        plan = self._cem(rep, pose, goal_rep, generator=generator, sampler=sampler)
        return plan.cpu().numpy()
