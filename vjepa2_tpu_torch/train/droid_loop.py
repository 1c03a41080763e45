"""V-JEPA 2-AC post-training loop: config -> models -> trajectories -> the
DROID step (counterpart of `vjepa2_tpu/train/droid_loop.py`; reference
`app/vjepa_droid/train.py:main` minus DDP wrappers).

The target encoder is frozen (drawn from ``meta.seed``, or a pretrained
encoder's state dict passed in as ``enc_state``); the AC predictor trains.
What one card and this slice cannot honour is refused as in the
`Pretrainer` (`loop._refuse`): several cards (ROADMAP A12) and in-process
evals; and DROID trajectories from disk (A8c, with `data/droid.py`).
``meta.dtype`` is the compute dtype on either device: bf16 on the card runs
the bf16 kernels, fp32 the fp32 ones (the AC predictor's frame-causal
segment ids included). The models take the flash routes whatever
``model.use_flash`` says: the kernels on the card, their plain versions on
the CPU. Each iteration logs (epoch, itr, loss, iter_ms) to
``droid_log_r0.csv``; a non-finite loss aborts the run; every epoch ends
with a checkpoint, from which ``meta.load_checkpoint`` resumes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vjepa2_tpu_torch.core.checkpoint import CheckpointManager
from vjepa2_tpu_torch.core.config import PretrainConfig
from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.core.logging import AverageMeter, CSVLogger, get_logger
from vjepa2_tpu_torch.data.prefetch import device_prefetch
from vjepa2_tpu_torch.data.video import synthetic_clip
from vjepa2_tpu_torch.train.accum import validate_grad_accum
from vjepa2_tpu_torch.train.droid import (DroidHParams, DroidState, build_droid_models,
                                          make_droid_optimizer, make_droid_train_step,
                                          tokens_per_frame)
from vjepa2_tpu_torch.train.loop import IMAGENET_MEAN, IMAGENET_STD, _refuse

logger = get_logger(__name__)


DEFAULT_IPE = 100  # iterations an epoch when the config gives none (JAX's)


def droid_hparams(c: PretrainConfig) -> DroidHParams:
    """The step's hyper-parameters from a config, as JAX's `DroidTrainer`
    derives them (`droid_loop.py:101-114`): warmup and anneal in epochs of
    ``ipe`` iterations, ``ipe_scale * epochs * ipe`` steps in all; AdamW's
    betas and eps are JAX's defaults, whatever the config says."""
    o = c.optimization
    ipe = o.ipe or DEFAULT_IPE
    return DroidHParams(
        lr=o.lr, start_lr=o.start_lr, final_lr=o.final_lr, warmup_steps=int(o.warmup * ipe),
        anneal_steps=int((o.anneal or 1) * ipe), total_steps=int(o.ipe_scale * o.epochs * ipe),
        wd=o.weight_decay, final_wd=o.final_weight_decay, loss_exp=c.loss.loss_exp,
        auto_steps=c.loss.auto_steps, normalize_reps=c.loss.normalize_reps)


class SyntheticDroidLoader:
    """Deterministic synthetic trajectories (JAX `droid_loop.py:43`): one
    clip for every example, random actions, states and extrinsics."""

    def __init__(self, batch_size: int, fpc: int, crop_size: int, ipe: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        clip = synthetic_clip(fpc, crop_size, crop_size, seed).astype(np.float32) / 255.0
        self.clips = np.stack([clip] * batch_size)
        self.actions = rng.normal(size=(batch_size, fpc - 1, 7)).astype(np.float32) * 0.05
        self.states = rng.normal(size=(batch_size, fpc, 7)).astype(np.float32)
        self.extr = rng.normal(size=(batch_size, fpc, 6)).astype(np.float32)
        self.ipe = ipe

    def __iter__(self):
        for _ in range(self.ipe):
            yield self.clips, self.actions, self.states, self.extr


@dataclass
class DroidTrainer:
    cfg: PretrainConfig
    enc_state: Optional[dict] = None  # a pretrained encoder's state dict (the target)
    synthetic_data: bool = False
    device: object = "cuda"

    def __post_init__(self):
        c = self.cfg
        _refuse(c)
        if c.data.datasets and not self.synthetic_data:
            raise NotImplementedError("data.datasets: DROID trajectories from disk are not "
                                      "ported (ROADMAP A8c, the rest of A8b); run on synthetic "
                                      "trajectories (datasets: [] or --synthetic-data)")
        self.device = entry_device(self.device)
        self.dtype = torch.bfloat16 if c.meta.dtype in ("bfloat16", "bf16") else torch.float32
        # reference: max_num_frames = max(dataset_fpcs) (`train.py:106`)
        self.frames_per_clip = max(c.data.dataset_fpcs) if c.data.dataset_fpcs else 8
        m = c.model
        self.target_encoder, self.predictor = build_droid_models(
            model_name=m.model_name, crop_size=c.data.crop_size, patch_size=c.data.patch_size,
            tubelet_size=c.data.tubelet_size, pred_depth=m.pred_depth,
            pred_embed_dim=m.pred_embed_dim, pred_num_heads=m.pred_num_heads,
            uniform_power=m.uniform_power, use_rope=m.use_rope,
            use_extrinsics=m.use_extrinsics, use_flash=True, dtype=self.dtype,
            device=self.device, use_activation_checkpointing=m.use_activation_checkpointing,
            remat_policy=m.remat_policy)
        self.tpf = tokens_per_frame(self.target_encoder)
        o = c.optimization
        self.ipe = o.ipe or DEFAULT_IPE
        self.hp = droid_hparams(c)
        self.grad_accum = max(1, int(o.grad_accum))
        if self.grad_accum > 1:
            validate_grad_accum(c.data.batch_size, self.grad_accum)
        os.makedirs(c.folder, exist_ok=True)
        keep_period = c.meta.save_every_freq * self.ipe if c.meta.save_every_freq else None
        self.ckpt = CheckpointManager(os.path.join(c.folder, "ckpt"), keep_period=keep_period)
        norm_stats = (IMAGENET_MEAN, IMAGENET_STD) if c.data.normalize_on_device else None
        self._step = make_droid_train_step(self.hp, self.tpf, norm_stats=norm_stats,
                                           grad_accum=self.grad_accum)

    def make_loader(self):
        c = self.cfg
        return SyntheticDroidLoader(c.data.batch_size, self.frames_per_clip, c.data.crop_size,
                                    self.ipe, c.meta.seed)

    def init_state(self) -> DroidState:
        """Weights from a generator seeded with ``meta.seed`` on the models'
        device; the target from ``enc_state`` when given."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.meta.seed)
        self.target_encoder.reset_parameters(gen)
        self.predictor.reset_parameters(gen)
        if self.enc_state is not None:
            self.target_encoder.load_state_dict(self.enc_state)
        logger.info("params: target encoder %.1fM predictor %.1fM",
                    sum(p.numel() for p in self.target_encoder.parameters()) / 1e6,
                    sum(p.numel() for p in self.predictor.parameters()) / 1e6)
        return DroidState(0, self.predictor, self.target_encoder,
                          make_droid_optimizer(self.hp, self.predictor))

    def restore_or_init(self) -> DroidState:
        state = self.init_state()
        if self.ckpt.latest_step() is not None and self.cfg.meta.load_checkpoint:
            logger.info("restoring checkpoint step=%s", self.ckpt.latest_step())
            state = self.ckpt.restore(state)
        return state

    def _step_fn(self):
        return self._step

    def stage(self, batch):
        """Host tensors of one batch (clips in the compute dtype unless uint8;
        extrinsics only with ``use_extrinsics``), split into ``grad_accum``
        microbatches [A, B/A, ...] (`droid_loop.py:181-199`)."""
        clips, actions, states, extr = batch
        clips = torch.from_numpy(np.ascontiguousarray(clips))
        if clips.dtype != torch.uint8:
            clips = clips.to(self.dtype)
        out = [clips, torch.from_numpy(np.asarray(actions, np.float32)),
               torch.from_numpy(np.asarray(states, np.float32)),
               torch.from_numpy(np.asarray(extr, np.float32))
               if self.cfg.model.use_extrinsics else None]
        if self.grad_accum > 1:
            a = self.grad_accum
            out = [None if x is None else x.reshape(a, x.shape[0] // a, *x.shape[1:])
                   for x in out]
        return tuple(out)

    def run(self, epochs: Optional[int] = None, log_every: int = 10) -> dict:
        c = self.cfg
        epochs = epochs if epochs is not None else c.optimization.epochs
        state = self.restore_or_init()
        csv = CSVLogger(os.path.join(c.folder, "droid_log_r0.csv"), ("%d", "epoch"),
                        ("%d", "itr"), ("%.5f", "loss"), ("%.2f", "iter_ms"))
        last_loss = float("nan")
        for epoch in range(state.step // self.ipe, epochs):
            loss_meter, time_meter = AverageMeter(), AverageMeter()
            pending: list = []  # (itr, metrics)
            window_t0 = time.perf_counter()

            def drain():
                # read the queued losses back at log points only (the
                # `Pretrainer`'s pattern, `loop.py:drain`)
                nonlocal window_t0
                if not pending:
                    return
                losses = []
                for itr_i, m in pending:
                    loss_i = float(m["loss"])  # waits for the step
                    if not np.isfinite(loss_i):
                        raise AssertionError(f"non-finite loss at itr {itr_i}")
                    losses.append((itr_i, loss_i))
                dt_ms = (time.perf_counter() - window_t0) * 1e3 / len(pending)
                for itr_i, loss_i in losses:
                    loss_meter.update(loss_i)
                    time_meter.update(dt_ms)
                    csv.log(epoch, itr_i, loss_i, dt_ms)
                pending.clear()
                window_t0 = time.perf_counter()

            batches = device_prefetch(self.make_loader(), size=2, transform=self.stage,
                                      device=self.device)
            step_fn = self._step_fn()
            for itr, (clips, actions, states, extr) in enumerate(batches):
                metrics = step_fn(state, clips, actions, states, extr)
                pending.append((itr, metrics))
                if itr % log_every == 0 or len(pending) >= log_every:
                    drain()
                    logger.info("droid epoch %d itr %d loss %.4f (avg %.4f) %.0f ms", epoch,
                                itr, loss_meter.val, loss_meter.avg, time_meter.avg)
            batches.close()
            drain()
            last_loss = loss_meter.avg
            self.ckpt.save(state.step, state)
        return {"loss": last_loss, "step": state.step}
