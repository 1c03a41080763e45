"""V-JEPA 2-AC post-training on robot trajectories: the train step
(counterpart of `vjepa2_tpu/train/droid.py`; reference
`app/vjepa_droid/train.py:403-470`).

Per step: each frame of the clips is encoded alone by the frozen target
encoder (duplicated into a 2-frame tubelet), without gradients; the AC
predictor is then trained with (a) teacher-forced next-frame prediction and
(b) an autoregressive rollout of ``auto_steps - 1`` more predictor calls,
whose first input frame is the teacher-forced prediction (the gradient runs
through it into the teacher-forcing call). The loss is L1^p on both against
the shifted target features; AdamW follows the WSD learning rate and the
cosine weight decay. Parameters and optimizer state are fp32 at either
compute dtype (``meta.dtype``, bf16 or fp32 on the card); bf16 compute needs
no loss scaling.

JAX carries a trainable copy of the encoder when ``enc_lr_scale > 0``
(`droid.py:249-250`); the objective never reads it, so its gradient is zero,
and JAX masks it from weight decay, so it never changes. The port leaves it
out: the predictor's updates and the grad norm are the same without it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn as nn

from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.core.optim import ScheduledAdamW, global_norm
from vjepa2_tpu_torch.core.schedulers import cosine_wd, wsd_lr
from vjepa2_tpu_torch.models.ac_predictor import VisionTransformerPredictorAC, vit_ac_predictor
from vjepa2_tpu_torch.models.vision_transformer import MODEL_REGISTRY, VisionTransformer
from vjepa2_tpu_torch.train.accum import accumulate
from vjepa2_tpu_torch.train.pretrain import _device_normalize


@dataclass(frozen=True)
class DroidHParams:
    lr: float = 4.25e-4
    start_lr: float = 2e-4
    final_lr: float = 0.0
    warmup_steps: int = 800
    anneal_steps: int = 4000
    total_steps: int = 24000
    wd: float = 0.04
    final_wd: float = 0.4
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    loss_exp: float = 1.0
    auto_steps: int = 2
    normalize_reps: bool = True


@dataclass
class DroidState:
    """What the step touches: the predictor, the frozen target encoder and
    the optimizer; ``step`` counts the updates made (the schedules read it).
    `state_dict` / `load_state_dict` carry all of it for `core.checkpoint`."""

    step: int
    predictor: nn.Module
    target_encoder: nn.Module
    optimizer: ScheduledAdamW

    def state_dict(self) -> dict:
        return {"step": self.step, "predictor": self.predictor.state_dict(),
                "target_encoder": self.target_encoder.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.predictor.load_state_dict(state["predictor"])
        self.target_encoder.load_state_dict(state["target_encoder"])
        self.optimizer.load_state_dict(state["optimizer"])


def build_droid_models(model_name: str = "vit_giant_xformers", crop_size: int = 256,
                       patch_size: int = 16, tubelet_size: int = 2, pred_depth: int = 24,
                       pred_embed_dim: int = 1024, pred_num_heads: int | None = None,
                       uniform_power: bool = False, use_rope: bool = True,
                       use_extrinsics: bool = False, use_flash: bool = True,
                       dtype=torch.bfloat16, device="cuda",
                       use_activation_checkpointing: bool = False,
                       remat_policy: str | None = None
                       ) -> tuple[VisionTransformer, VisionTransformerPredictorAC]:
    """The target encoder (one frame as a 2-frame tubelet, frozen) and the AC
    predictor, as JAX's `DroidTrainer` builds them (`droid_loop.py:70-98`);
    parameters allocated on ``device``, not initialised. Builds on the card
    unless ``device="cpu"`` is passed."""
    device = entry_device(device)
    enc = MODEL_REGISTRY[model_name](
        patch_size=patch_size, img_size=(crop_size, crop_size), num_frames=2,
        tubelet_size=tubelet_size, uniform_power=uniform_power, use_rope=use_rope,
        use_flash=use_flash, dtype=dtype, device=device)
    pred = vit_ac_predictor(
        img_size=(crop_size, crop_size), patch_size=patch_size, embed_dim=enc.embed_dim,
        predictor_embed_dim=pred_embed_dim, depth=pred_depth, num_heads=pred_num_heads or 16,
        use_extrinsics=use_extrinsics, use_flash=use_flash, dtype=dtype, device=device,
        use_activation_checkpointing=use_activation_checkpointing, remat_policy=remat_policy)
    return enc.requires_grad_(False), pred


def tokens_per_frame(encoder: VisionTransformer) -> int:
    """Tokens the encoder gives one frame (a 2-frame tubelet)."""
    h, w = (s // encoder.patch_size for s in encoder.img_size)
    return (2 // encoder.tubelet_size) * h * w


def make_droid_optimizer(hp: DroidHParams, predictor: nn.Module) -> ScheduledAdamW:
    """AdamW over the predictor with the WSD learning rate and the cosine
    weight decay (JAX `droid.py:52`)."""
    lr_fn = functools.partial(wsd_lr, warmup_steps=hp.warmup_steps,
                              anneal_steps=hp.anneal_steps, t_max=hp.total_steps,
                              start_lr=hp.start_lr, ref_lr=hp.lr, final_lr=hp.final_lr)
    wd_fn = functools.partial(cosine_wd, ref_wd=hp.wd, t_max=hp.total_steps,
                              final_wd=hp.final_wd)
    return ScheduledAdamW(predictor.parameters(), lr_fn, wd_fn, betas=hp.betas, eps=hp.eps)


def feature_layernorm(h: torch.Tensor) -> torch.Tensor:
    """Per-token normalisation over features in fp32: the biased variance,
    eps 1e-6 inside the square root, no affine (JAX `droid.py:47`)."""
    h = h.float()
    return (h - h.mean(-1, keepdim=True)) / torch.sqrt(h.var(-1, keepdim=True, unbiased=False)
                                                       + 1e-6)


def encode_frames(encoder: nn.Module, clips: torch.Tensor) -> torch.Tensor:
    """Each frame alone, duplicated into a 2-frame tubelet:
    clips [B, T, H, W, C] -> [B, T * N_f, D] (JAX `droid.py:97`)."""
    B, T = clips.shape[:2]
    frames = clips.reshape(B * T, 1, *clips.shape[2:]).expand(-1, 2, -1, -1, -1)
    h = encoder(frames)
    return h.reshape(B, T * h.shape[1], h.shape[2])


def droid_losses(predictor: nn.Module, target_encoder: nn.Module, hp: DroidHParams, tpf: int,
                 clips, actions, states, extrinsics=None, norm_stats=None):
    """(loss, loss_teacher_forcing, loss_rollout) fp32 scalars, autograd
    recording through the predictor (JAX `droid.py:131-173`). clips
    [B, T, H, W, C] (uint8 with ``norm_stats``); actions [B, T-1, 7]; states
    [B, T, 7]; extrinsics [B, T, 6] or None; ``tpf`` tokens a frame."""
    clips = _device_normalize(clips, target_encoder.dtype, norm_stats)
    with torch.no_grad():
        h = encode_frames(target_encoder, clips)
        if hp.normalize_reps:
            h = feature_layernorm(h)

    def predict(z, a, s, e):
        z = predictor(z, a, s, e)
        return feature_layernorm(z) if hp.normalize_reps else z

    def extr(n):
        return None if extrinsics is None else extrinsics[:, :n]

    # teacher forcing: frames 1..T-1 from frames 0..T-2
    z_tf = predict(h[:, :-tpf], actions, states[:, :-1], extr(-1))
    # the rollout starts from the first real frame and the first prediction
    z = torch.cat([h[:, :tpf], z_tf[:, :tpf]], dim=1)
    for n in range(1, hp.auto_steps):
        z_next = predict(z, actions[:, :n + 1], states[:, :n + 1], extr(n + 1))[:, -tpf:]
        z = torch.cat([z, z_next], dim=1)

    def l1(zz):
        d = (zz.float() - h[:, tpf:zz.shape[1] + tpf].float()).abs()
        if hp.loss_exp != 1.0:
            d = d**hp.loss_exp
        return d.mean() / hp.loss_exp

    jloss, sloss = l1(z_tf), l1(z[:, tpf:])
    return jloss + sloss, jloss, sloss


def make_droid_train_step(hp: DroidHParams, tokens_per_frame: int, norm_stats=None,
                          grad_accum: int = 1):
    """The AC train step: ``train_step(state, clips, actions, states,
    extrinsics=None)`` updates the `DroidState` in place and returns its
    metrics (``loss``, ``loss_teacher_forcing``, ``loss_rollout``,
    ``grad_norm``).

    ``grad_accum = A > 1``: every batch input carries a leading microbatch
    dim [A, B/A, ...]; each microbatch runs its forward and backward in turn
    and the mean gradient makes one update (`train/accum.py`), the losses
    averaged the same way (JAX `droid.py:180-186`).
    """

    def loss_and_backward(state: DroidState, clips, actions, states, extrinsics):
        losses = droid_losses(state.predictor, state.target_encoder, hp, tokens_per_frame,
                              clips, actions, states, extrinsics, norm_stats)
        losses[0].backward()
        return torch.stack(losses).detach()

    def train_step(state: DroidState, clips, actions, states, extrinsics=None) -> dict:
        state.optimizer.zero_grad()
        if grad_accum == 1:
            losses = loss_and_backward(state, clips, actions, states, extrinsics)
        else:
            micro = [(state, clips[i], actions[i], states[i],
                      None if extrinsics is None else extrinsics[i]) for i in range(grad_accum)]
            losses = accumulate(loss_and_backward, micro, grad_accum, state.optimizer.params)
        grad_norm = global_norm([p.grad for p in state.optimizer.params if p.grad is not None])
        state.optimizer.step(state.step)
        state.step += 1
        return {"loss": losses[0], "loss_teacher_forcing": losses[1], "loss_rollout": losses[2],
                "grad_norm": grad_norm}

    return train_step
