"""Pretraining loop: config -> models -> data -> the train steps
(counterpart of `vjepa2_tpu/train/loop.py`; reference `app/vjepa/train.py:main`
minus DDP wrappers, GradScaler and scheduler replay on resume).

One card: the mesh, pipeline parallelism and ring-attention context
parallelism are not here (ROADMAP A12), and a config that asks for them is
refused, as are in-process evals (A8c): nothing is skipped quietly.

Data: ``data.datasets`` (CSV or ``.npy`` manifests) is read from disk through
`data.manager.init_video_data` and `data.transforms.VideoTransform` built
from ``data`` and ``data_aug`` as JAX builds them (`loop.py:224-254`); with
``datasets: []`` or ``synthetic_data`` the loop runs on synthetic clips. Two
departures from JAX's loop (ROADMAP queue C): each epoch's loader draws that
epoch's order, windows and crops (JAX builds every epoch's loader at epoch 0,
so every epoch replays the first), and the loader yields its batches in the
sampler's order (JAX's yields them as its workers finish, so a resume's skip
of the trained batches can drop other batches than those).

``meta.dtype`` float32 runs on the card too: the fp32 BHND flash kernels
take the step's RoPE and kv_valid, and the GEMMs stay full fp32 (TF32 stays
off, PyTorch's default). The models always take the flash routes, whatever
``model.use_flash`` says (JAX's default picks XLA's attention; the port's only
other attention is its plain test version): on the card the hand-written
kernels run, on the CPU their plain versions.

Multi-fpc batches: the loader emits one fpc bucket per step and the trainer
keeps a step function per bucket; with ``multifpc_within_step`` one step
averages every bucket (`group_fpc_batches`, `make_multifpc_train_step`).
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vjepa2_tpu_torch.core.checkpoint import CheckpointManager
from vjepa2_tpu_torch.core.config import PretrainConfig
from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.core.logging import AverageMeter, CSVLogger, get_logger
from vjepa2_tpu_torch.data.manager import init_video_data
from vjepa2_tpu_torch.data.prefetch import device_prefetch
from vjepa2_tpu_torch.data.transforms import VideoTransform
from vjepa2_tpu_torch.data.video import synthetic_clip
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.train.accum import validate_grad_accum
from vjepa2_tpu_torch.train.pretrain import (PretrainHParams, build_models, init_params,
                                             make_multifpc_train_step, make_optimizer,
                                             make_train_step)
from vjepa2_tpu_torch.train.state import TrainState

logger = get_logger(__name__)

# ImageNet statistics for uint8 clips normalised on the card
# (`vjepa2_tpu/data/transforms.py` IMAGENET_MEAN / IMAGENET_STD)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class SyntheticVideoLoader:
    """Deterministic synthetic clips — lets the full loop run without data
    on disk (smoke tests, perf shakeout). With several fpcs it emits one
    bucket per step, round-robin (matching the real loader's FpcBucketSampler)."""

    def __init__(self, batch_size: int, fpc, crop_size: int, ipe: int, seed: int = 0):
        self.batch_size = batch_size
        self.fpcs = list(fpc) if isinstance(fpc, (list, tuple)) else [fpc]
        self.crop_size = crop_size
        self.ipe = ipe
        self._batches = {}
        for f in self.fpcs:
            base = synthetic_clip(f, crop_size, crop_size, seed=seed).astype(np.float32) / 255.0
            self._batches[f] = np.stack(
                [np.roll(base, s, axis=2) for s in range(batch_size)]
            )

    def __iter__(self):
        for i in range(self.ipe):
            f = self.fpcs[i % len(self.fpcs)]
            yield [self._batches[f]], np.zeros(self.batch_size, np.int64), [
                np.tile(np.arange(f), (self.batch_size, 1))
            ]

    def __len__(self):
        return self.ipe


def group_fpc_batches(loader, fpcs, max_pending: int = 8):
    """Group a one-bucket-per-batch stream into per-step groups with ONE
    sub-batch of EVERY fpc (reference within-step multi-fpc composition,
    `multiseq_multiblock3d.py:63-74`). Groups are ordered by sorted fpc.

    ``max_pending`` bounds the per-fpc backlog when sampling weights are
    uneven: beyond it the OLDEST pending batch of that fpc is dropped.
    """
    fpcs = sorted(fpcs)
    pending = {f: deque() for f in fpcs}
    for batch in loader:
        f = int(np.asarray(batch[0][0]).shape[1])
        q = pending[f]
        q.append(batch)
        if len(q) > max_pending:
            q.popleft()
        if all(pending[x] for x in fpcs):
            yield [pending[x].popleft() for x in fpcs]


def _refuse(c: PretrainConfig) -> None:
    """Raise on what one card and this slice cannot honour, naming the
    ROADMAP item that brings it."""
    m = c.mesh
    if m.model > 1:
        what = "context parallelism" if c.model.context_parallel else "tensor parallelism"
        raise NotImplementedError(f"mesh.model={m.model} ({what} over a model axis) needs "
                                  "several cards: not ported (ROADMAP A12); set mesh.model: 1")
    for name, value in (("mesh.fsdp", m.fsdp), ("mesh.pipe", m.pipe), ("mesh.data", m.data)):
        if value > 1:
            raise NotImplementedError(f"{name}={value} needs several cards: not ported "
                                      "(ROADMAP A12)")
    if c.evals and c.meta.eval_freq:
        raise NotImplementedError("in-process evals (evals with meta.eval_freq) are not "
                                  "ported (ROADMAP A8c, formerly A10b; the frozen evals run "
                                  "through cli.eval)")


@dataclass
class Pretrainer:
    cfg: PretrainConfig
    synthetic_data: bool = False
    device: object = "cuda"

    def __post_init__(self):
        c = self.cfg
        _refuse(c)
        self.device = entry_device(self.device)
        self.dtype = torch.bfloat16 if c.meta.dtype in ("bfloat16", "bf16") else torch.float32
        self.fpcs = sorted(set(c.data.dataset_fpcs))
        self.encoder, self.predictor = build_models(
            model_name=c.model.model_name,
            crop_size=c.data.crop_size,
            patch_size=c.data.patch_size,
            num_frames=max(self.fpcs),
            tubelet_size=c.data.tubelet_size,
            pred_depth=c.model.pred_depth,
            pred_embed_dim=c.model.pred_embed_dim,
            pred_num_heads=c.model.pred_num_heads,
            uniform_power=c.model.uniform_power,
            use_rope=c.model.use_rope,
            use_mask_tokens=c.model.use_mask_tokens,
            num_mask_tokens=len(c.mask) * len(self.fpcs),
            zero_init_mask_tokens=c.model.zero_init_mask_tokens,
            use_flash=True,
            dtype=self.dtype,
            device=self.device,
            use_activation_checkpointing=c.model.use_activation_checkpointing,
            remat_policy=c.model.remat_policy,
        )
        o = c.optimization
        self.hp = PretrainHParams(
            lr=o.lr, start_lr=o.start_lr, final_lr=o.final_lr, warmup_epochs=o.warmup,
            epochs=o.epochs, ipe=o.ipe or 300, ipe_scale=o.ipe_scale, wd=o.weight_decay,
            final_wd=o.final_weight_decay, ema=tuple(o.ema), betas=tuple(o.betas), eps=o.eps,
            loss_exp=c.loss.loss_exp)
        self.grad_accum = max(1, int(o.grad_accum))
        if self.grad_accum > 1:
            validate_grad_accum(c.data.batch_size, self.grad_accum)
            if o.multifpc_within_step:
                raise ValueError("grad_accum composes with the per-fpc-bucket step, not the "
                                 "within-step multi-fpc program (each bucket is already a "
                                 "separate backward there)")
        self.collator = MaskCollator(
            c.mask, dataset_fpcs=self.fpcs, crop_size=(c.data.crop_size, c.data.crop_size),
            patch_size=(c.data.patch_size, c.data.patch_size), tubelet_size=c.data.tubelet_size,
            seed=c.meta.seed)
        os.makedirs(c.folder, exist_ok=True)
        # permanent milestone snapshots every save_every_freq epochs, on top
        # of the rolling latest-3 (reference `app/vjepa/train.py:516-521`)
        keep_period = c.meta.save_every_freq * self.hp.ipe if c.meta.save_every_freq else None
        self.ckpt = CheckpointManager(os.path.join(c.folder, "ckpt"), keep_period=keep_period)
        self._step_fns: dict = {}

    # -- data ---------------------------------------------------------------
    def make_loader(self, epoch: int = 0):
        """Epoch ``epoch``'s batches: synthetic clips, or ``data.datasets``
        from disk (ipe batches, in the sampler's order)."""
        c = self.cfg
        if self.synthetic_data or not c.data.datasets:
            return SyntheticVideoLoader(c.data.batch_size, self.fpcs, c.data.crop_size,
                                        self.hp.ipe, c.meta.seed)
        aug = c.data_aug
        transform = VideoTransform(
            crop_size=c.data.crop_size, random_resize_scale=tuple(aug.random_resize_scale),
            random_resize_aspect_ratio=tuple(aug.random_resize_aspect_ratio),
            horizontal_flip=aug.horizontal_flip, motion_shift=aug.motion_shift,
            auto_augment=aug.auto_augment, rand_erase_prob=aug.reprob,
            normalize_on_device=c.data.normalize_on_device)
        _, loader, _ = init_video_data(
            data_paths=c.data.datasets, batch_size=c.data.batch_size, transform=transform,
            datasets_weights=c.data.datasets_weights, dataset_fpcs=c.data.dataset_fpcs,
            fps=c.data.fps, num_workers=c.data.num_workers, ordered=True, ipe=self.hp.ipe,
            seed=c.meta.seed)
        loader.set_epoch(epoch)
        return loader

    # -- state --------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Weights from a generator seeded with ``meta.seed`` on the models'
        device; the target is the encoder's copy. The mask collator takes one
        step, as JAX's takes one to sample masks for its init shapes
        (`loop.py:258-260`): train step k then draws collator step k + 1,
        which is where `restore_or_init`'s ``set_step`` puts a resumed run."""
        self.collator.step()
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.meta.seed)
        init_params(self.encoder, self.predictor, gen)
        state = TrainState.create(self.encoder, self.predictor,
                                  make_optimizer(self.hp, self.encoder, self.predictor))
        logger.info("params: encoder %.1fM predictor %.1fM",
                    sum(p.numel() for p in self.encoder.parameters()) / 1e6,
                    sum(p.numel() for p in self.predictor.parameters()) / 1e6)
        return state

    def restore_or_init(self) -> TrainState:
        state = self.init_state()
        if self.ckpt.latest_step() is not None and self.cfg.meta.load_checkpoint:
            logger.info("restoring checkpoint step=%s", self.ckpt.latest_step())
            state = self.ckpt.restore(state)
            self.collator.set_step(int(state.step))
        return state

    def _norm_stats(self):
        return (IMAGENET_MEAN, IMAGENET_STD) if self.cfg.data.normalize_on_device else None

    def _step_fn(self, fpc: int):
        if fpc not in self._step_fns:
            fi, n_mask = self.fpcs.index(fpc), len(self.cfg.mask)
            self._step_fns[fpc] = make_train_step(
                self.hp, [fi * n_mask + mi for mi in range(n_mask)],
                norm_stats=self._norm_stats(), grad_accum=self.grad_accum)
        return self._step_fns[fpc]

    @property
    def multifpc(self) -> bool:
        return len(self.fpcs) > 1 and bool(self.cfg.optimization.multifpc_within_step)

    def _multifpc_step_fn(self):
        if "multifpc" not in self._step_fns:
            self._step_fns["multifpc"] = make_multifpc_train_step(
                self.hp, len(self.cfg.mask), norm_stats=self._norm_stats())
        return self._step_fns["multifpc"]

    def _host_clips(self, clips) -> torch.Tensor:
        """Host clips in the compute dtype (uint8 stays: the step normalises
        on the card)."""
        clips = torch.from_numpy(np.ascontiguousarray(clips))
        return clips if clips.dtype == torch.uint8 else clips.to(self.dtype)

    def stage(self, batch):
        """Host work per batch, on the prefetch thread: the clips' cast and
        the masks of one collator step, sampled over the FULL batch (the
        batch-min truncation statistics unchanged), then split into
        ``grad_accum`` microbatches [A, B/A, ...] (`loop.py:436-446`)."""
        clips_list, _labels, _ci = batch
        clips = self._host_clips(clips_list[0])
        self.collator.step()
        me, mp = self.collator(clips.shape[1], clips.shape[0])
        me = [torch.from_numpy(m) for m in me]
        mp = [torch.from_numpy(m) for m in mp]
        if self.grad_accum > 1:
            a = self.grad_accum
            b = clips.shape[0] // a
            clips = clips.reshape(a, b, *clips.shape[1:])
            me = [m.reshape(a, b, -1) for m in me]
            mp = [m.reshape(a, b, -1) for m in mp]
        return clips, me, mp

    def stage_group(self, group):
        """Within-step multi-fpc: one collator step per TRAIN step (reference
        `app/vjepa/train.py:314`), then per-bucket mask sampling."""
        self.collator.step()
        out_c, out_me, out_mp = [], [], []
        for batch in group:
            clips = self._host_clips(batch[0][0])
            me, mp = self.collator(clips.shape[1], clips.shape[0])
            out_c.append(clips)
            out_me.append([torch.from_numpy(m) for m in me])
            out_mp.append([torch.from_numpy(m) for m in mp])
        return tuple(out_c), tuple(out_me), tuple(out_mp)

    # -- loop ---------------------------------------------------------------
    def run(self, epochs: Optional[int] = None, log_every: int = 10,
            preemption_guard=None) -> dict:
        c = self.cfg
        epochs = epochs if epochs is not None else self.hp.epochs
        state = self.restore_or_init()
        preempted = False
        csv = CSVLogger(os.path.join(c.folder, "log_r0.csv"), ("%d", "epoch"), ("%d", "itr"),
                        ("%.5f", "loss"), ("%.2f", "iter_ms"))
        start_epoch = int(state.step) // self.hp.ipe
        # mid-epoch resume (preemption): skip the iterations already trained
        skip_itrs = int(state.step) % self.hp.ipe
        last_loss = float("nan")
        for epoch in range(start_epoch, epochs):
            loader = self.make_loader(epoch)
            loss_meter, time_meter = AverageMeter(), AverageMeter()
            pending: list = []  # (itr, metrics)
            window_t0 = time.perf_counter()

            def drain():
                # read the queued losses back; syncing only at log points
                # keeps the card busy between them
                nonlocal window_t0
                if not pending:
                    return
                losses = []
                for itr_i, m in pending:
                    loss_i = float(m["loss"])  # waits for the step
                    if not np.isfinite(loss_i):
                        raise AssertionError(f"non-finite loss at itr {itr_i}")
                    losses.append((itr_i, loss_i))
                # the window's time after the read-back: the host runs ahead
                # of the card, so timing before it measures dispatch
                dt_ms = (time.perf_counter() - window_t0) * 1e3 / len(pending)
                for itr_i, loss_i in losses:
                    loss_meter.update(loss_i)
                    time_meter.update(dt_ms)
                    csv.log(epoch, itr_i, loss_i, dt_ms)
                pending.clear()
                window_t0 = time.perf_counter()

            if self.multifpc:
                # group BEFORE the resume skip: one group == one train step
                loader = group_fpc_batches(loader, self.fpcs)
                transform = self.stage_group
            else:
                transform = self.stage
            start_itr = 0
            if epoch == start_epoch and skip_itrs:
                # consume already-trained batches without touching the mask
                # collator (set_step already positioned it at the restored step)
                loader = itertools.islice(iter(loader), skip_itrs, None)
                start_itr = skip_itrs
            batches = device_prefetch(loader, size=2, transform=transform, device=self.device)
            for itr, (clips, masks_enc, masks_pred) in enumerate(batches, start=start_itr):
                if self.multifpc:
                    step_fn = self._multifpc_step_fn()
                else:
                    step_fn = self._step_fn(clips.shape[-4])  # T in [(A,) B, T, H, W, C]
                metrics = step_fn(state, clips, masks_enc, masks_pred)
                pending.append((itr, metrics))
                if itr % log_every == 0 or len(pending) >= log_every:
                    drain()
                    logger.info("epoch %d itr %d loss %.4f (avg %.4f) %.0f ms", epoch, itr,
                                loss_meter.val, loss_meter.avg, time_meter.avg)
                if preemption_guard is not None and preemption_guard.should_stop:
                    # checkpoint mid-epoch and hand control back for requeue
                    # (reference: submitit checkpoint() + resume_preempt,
                    # `app/main_distributed.py:87-91`)
                    preempted = True
                    break
            batches.close()
            drain()
            last_loss = loss_meter.avg
            self.ckpt.save(int(state.step), state)
            if preempted:
                logger.warning("preempted at step %d; checkpoint saved", int(state.step))
                return {"loss": last_loss, "step": int(state.step), "preempted": True}
        return {"loss": last_loss, "step": int(state.step), "preempted": False}
