"""JEPA masked-latent pretraining: the train step (counterpart of
`vjepa2_tpu/train/pretrain.py`).

One step (`make_train_step`, the reference's hot loop
`app/vjepa/train.py:409-471`): the EMA target encoder over the whole clip
without gradients, a feature-wise normalisation in fp32 and a gather per
target mask; per mask config the context encoder over the kept tokens and the
predictor; the L1^p loss; backward; AdamW; the EMA update of the target with
the momentum of the step before the increment. bf16 compute with fp32
parameters and optimizer state needs no loss scaling.

``grad_accum > 1`` runs the batch as sequential microbatches whose gradients
average before the one update (`train/accum.py`); `make_multifpc_train_step`
averages the loss over every (fpc bucket x mask config) pair in one update.
Activation checkpointing is the models' (`build_models`'
``use_activation_checkpointing`` and ``remat_policy``). Not ported yet:
sharding (one card).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import torch

from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.core.optim import ScheduledAdamW, ema_update, global_norm
from vjepa2_tpu_torch.core.schedulers import cosine_wd, ema_momentum, warmup_cosine_lr
from vjepa2_tpu_torch.models.modules import parse_ln_fusions
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import MODEL_REGISTRY, VisionTransformer
from vjepa2_tpu_torch.ops.masking import apply_mask
from vjepa2_tpu_torch.train.accum import accumulate
from vjepa2_tpu_torch.train.state import TrainState


@dataclass(frozen=True)
class PretrainHParams:
    """Optimization hyper-parameters (reference `configs/train/*/..yaml`)."""

    lr: float = 6.25e-4
    start_lr: float = 2e-4
    final_lr: float = 1e-6
    warmup_epochs: float = 40
    epochs: int = 300
    ipe: int = 300
    ipe_scale: float = 1.25
    wd: float = 0.04
    final_wd: float = 0.4
    ema: tuple[float, float] = (0.998, 1.0)
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    loss_exp: float = 1.0

    @property
    def total_steps(self) -> int:
        return int(self.ipe_scale * self.epochs * self.ipe)

    @property
    def warmup_steps(self) -> int:
        return int(self.warmup_epochs * self.ipe)


def build_models(model_name: str = "vit_base", crop_size: int = 224, patch_size: int = 16,
                 num_frames: int = 16, tubelet_size: int = 2, pred_depth: int = 12,
                 pred_embed_dim: int = 384, pred_num_heads: int | None = None,
                 uniform_power: bool = True, use_rope: bool = False,
                 use_mask_tokens: bool = True, num_mask_tokens: int = 2,
                 zero_init_mask_tokens: bool = True, use_flash: bool = True,
                 dtype=torch.bfloat16, device="cuda", fuse_ln: str = "",
                 use_activation_checkpointing: bool = False, remat_policy: str | None = None,
                 ) -> tuple[VisionTransformer, VisionTransformerPredictor]:
    """Mirror of reference `app/vjepa/utils.py:init_video_model`; parameters
    are allocated on ``device`` but not initialised (`init_params` does).
    Builds on the card with the flash kernels on by default, and raises
    without a CUDA device unless ``device="cpu"`` is passed. ``fuse_ln``:
    the fused LayerNorm prologues for every block of both models, as
    `bench.py --fuse-ln` takes them ('qkv,mlp', 'qkv', 'mlp' or '').
    ``use_activation_checkpointing`` / ``remat_policy``: every block of both
    models under the remat policy (`models.modules.resolve_remat_policy`)."""
    device = entry_device(device)
    fuse_qkv, fuse_mlp = parse_ln_fusions(fuse_ln)
    enc = MODEL_REGISTRY[model_name](
        patch_size=patch_size, img_size=(crop_size, crop_size), num_frames=num_frames,
        tubelet_size=tubelet_size, uniform_power=uniform_power, use_rope=use_rope,
        use_flash=use_flash, dtype=dtype, device=device, fuse_ln_qkv=fuse_qkv,
        fuse_ln_mlp=fuse_mlp, use_activation_checkpointing=use_activation_checkpointing,
        remat_policy=remat_policy)
    pred = VisionTransformerPredictor(
        img_size=(crop_size, crop_size), patch_size=patch_size, num_frames=num_frames,
        tubelet_size=tubelet_size, embed_dim=enc.embed_dim, predictor_embed_dim=pred_embed_dim,
        depth=pred_depth, num_heads=pred_num_heads or enc.num_heads,
        uniform_power=uniform_power, use_mask_tokens=use_mask_tokens,
        num_mask_tokens=num_mask_tokens, zero_init_mask_tokens=zero_init_mask_tokens,
        use_rope=use_rope, use_flash=use_flash, dtype=dtype, device=device,
        fuse_ln_qkv=fuse_qkv, fuse_ln_mlp=fuse_mlp,
        use_activation_checkpointing=use_activation_checkpointing, remat_policy=remat_policy)
    return enc, pred


def init_params(encoder, predictor, generator: torch.Generator | None = None) -> None:
    """Draw the encoder's and the predictor's weights from ``generator``
    (the target encoder is the state's copy of the encoder,
    `TrainState.create`)."""
    encoder.reset_parameters(generator)
    predictor.reset_parameters(generator)


def make_optimizer(hp: PretrainHParams, encoder, predictor) -> ScheduledAdamW:
    lr_fn = functools.partial(warmup_cosine_lr, warmup_steps=hp.warmup_steps,
                              start_lr=hp.start_lr, ref_lr=hp.lr, t_max=hp.total_steps,
                              final_lr=hp.final_lr)
    wd_fn = functools.partial(cosine_wd, ref_wd=hp.wd, t_max=hp.total_steps,
                              final_wd=hp.final_wd)
    params = list(encoder.parameters()) + list(predictor.parameters())
    return ScheduledAdamW(params, lr_fn, wd_fn, betas=hp.betas, eps=hp.eps)


def jepa_loss(z_list, h_list, loss_exp: float) -> torch.Tensor:
    """Mean over (mask-config) pairs of mean |z - h|^p / p (reference
    `train.py:425-435`), in fp32."""
    loss = 0.0
    for z, h in zip(z_list, h_list):
        diff = (z.float() - h.float()).abs()
        if loss_exp != 1.0:
            diff = diff**loss_exp
        loss = loss + diff.mean() / loss_exp
    return loss / len(z_list)


def _device_normalize(clips: torch.Tensor, dtype, norm_stats=None) -> torch.Tensor:
    """uint8 clips -> (x/255 - mean)/std in fp32, cast to the compute dtype,
    on the clips' device; other clips pass through."""
    if clips.dtype != torch.uint8:
        return clips
    if norm_stats is None:
        raise ValueError("uint8 clips need norm_stats=(mean, std)")
    mean, std = (torch.as_tensor(s, dtype=torch.float32, device=clips.device) for s in norm_stats)
    return ((clips.float() * (1.0 / 255.0) - mean) / std).to(dtype)


def target_features(target_encoder, clips, masks_pred) -> list[torch.Tensor]:
    """The target encoder over the whole clip, without gradients, normalised
    per token over features in fp32 (`pretrain.py:211-216`), gathered per
    target mask."""
    with torch.no_grad():
        h = target_encoder(clips).float()
        h = (h - h.mean(-1, keepdim=True)) / torch.sqrt(h.var(-1, keepdim=True, unbiased=False)
                                                        + 1e-6)
        return [apply_mask(h, mp) for mp in masks_pred]


def forward_loss(encoder, predictor, clips, masks_enc, masks_pred, h_list, loss_exp: float,
                 mask_indices: Sequence[int] | None = None) -> torch.Tensor:
    """The JEPA loss of the online networks, with autograd recording: per
    mask config the context encoder on its kept tokens, then the predictor at
    the targets."""
    z_list = []
    for i, (me, mp) in enumerate(zip(masks_enc, masks_pred)):
        z = encoder(clips, [me])
        mask_index = mask_indices[i] if mask_indices is not None else i
        z_list.append(predictor(z, me, mp, mask_index))
    return jepa_loss(z_list, h_list, loss_exp)


def _update(state: TrainState, loss: torch.Tensor, momentum: float) -> dict:
    """The update after the gradients are in ``.grad``: the grad norm, AdamW
    at the step's lr and weight decay, the EMA of the target, the count."""
    grad_norm = global_norm([p.grad for p in state.optimizer.params if p.grad is not None])
    state.optimizer.step(state.step)
    ema_update(state.target_encoder.parameters(), state.encoder.parameters(), momentum)
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm, "ema_momentum": momentum}


def make_train_step(hp: PretrainHParams, mask_indices: Sequence[int] | None = None,
                    norm_stats=None, grad_accum: int = 1):
    """The train step: ``train_step(state, clips, masks_enc, masks_pred)``
    updates ``state`` in place and returns its metrics (``loss``,
    ``grad_norm``, ``ema_momentum``).

    clips: [B, T, H, W, C] on the models' device (uint8 with ``norm_stats``,
    else any float type; cast to the compute dtype at the patch embed).
    masks_enc / masks_pred: sequences (one per mask config) of [B, K] index
    tensors, K fixed per config.

    ``grad_accum = A > 1``: every input carries a leading microbatch dim,
    [A, B/A, ...] and [A, B/A, K] (`pretrain.py:192-263`); each microbatch
    runs its target, context and predictor passes and its backward in turn,
    and the mean gradient makes one update (`train/accum.py`).
    """

    def loss_and_backward(state: TrainState, clips, masks_enc, masks_pred) -> torch.Tensor:
        clips = _device_normalize(clips, state.encoder.dtype, norm_stats)
        h_list = target_features(state.target_encoder, clips, masks_pred)
        loss = forward_loss(state.encoder, state.predictor, clips, masks_enc, masks_pred,
                            h_list, hp.loss_exp, mask_indices)
        loss.backward()
        return loss.detach()

    def train_step(state: TrainState, clips, masks_enc, masks_pred) -> dict:
        momentum = ema_momentum(state.step, ema_start=hp.ema[0], ema_end=hp.ema[1],
                                t_max=hp.total_steps)
        state.optimizer.zero_grad()
        if grad_accum == 1:
            loss = loss_and_backward(state, clips, masks_enc, masks_pred)
        else:
            micro = [(state, clips[i], [m[i] for m in masks_enc], [m[i] for m in masks_pred])
                     for i in range(grad_accum)]
            loss = accumulate(loss_and_backward, micro, grad_accum, state.optimizer.params)
        return _update(state, loss, momentum)

    return train_step


def make_multifpc_train_step(hp: PretrainHParams, num_mask_cfgs: int, norm_stats=None):
    """The reference's within-step multi-fpc composition
    (`app/vjepa/train.py:425-435`; JAX `pretrain.py:266-352`): ONE update
    averages the JEPA loss over every (fpc bucket x mask config) pair.

    ``train_step(state, clips_tup, masks_enc_tup, masks_pred_tup)``: tuples
    over the fpc buckets (in the trainer's sorted fpc order) of clips
    [B_i, T_i, H, W, C] and per-mask-config index tuples; bucket ``bi``'s
    mask config ``mi`` takes mask token ``bi * num_mask_cfgs + mi``, as the
    per-bucket step does.
    """

    def train_step(state: TrainState, clips_tup, masks_enc_tup, masks_pred_tup) -> dict:
        dtype = state.encoder.dtype
        clips_tup = tuple(_device_normalize(c, dtype, norm_stats) for c in clips_tup)
        momentum = ema_momentum(state.step, ema_start=hp.ema[0], ema_end=hp.ema[1],
                                t_max=hp.total_steps)
        h_lists = [target_features(state.target_encoder, clips, mp)
                   for clips, mp in zip(clips_tup, masks_pred_tup)]
        z_list, h_flat = [], []
        for bi, (clips, masks_enc, masks_pred) in enumerate(
                zip(clips_tup, masks_enc_tup, masks_pred_tup)):
            for mi, (me, mp) in enumerate(zip(masks_enc, masks_pred)):
                z = state.encoder(clips, [me])
                z_list.append(state.predictor(z, me, mp, bi * num_mask_cfgs + mi))
                h_flat.append(h_lists[bi][mi])
        loss = jepa_loss(z_list, h_flat, hp.loss_exp)
        state.optimizer.zero_grad()
        loss.backward()
        return _update(state, loss, momentum)

    return train_step
