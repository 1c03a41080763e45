"""Pretraining loop: config -> models -> data -> the train steps
(counterpart of `vjepa2_tpu/train/loop.py`; reference `app/vjepa/train.py:main`
minus DDP wrappers, GradScaler and scheduler replay on resume).

Several processes, one per GPU (`core.distributed`, `cli.main`): the
config's ``mesh`` lays the ranks out as JAX's `core/mesh.py` lays out its
devices (`process_layout`). ``data`` splits the batch: ``data.batch_size``
is the global batch, as on JAX's mesh; each rank of the data group loads
its share through a sampler over that group and takes its rows of the
masks the collator samples for the whole batch, and the step averages the
gradients over the group. ``model`` with ``model.context_parallel`` rings
each block's attention over the token dimension
(`ops.ring_attention.seq_sharded_attention`), and without it splits each
block's heads and hidden columns (tensor parallelism); ``fsdp`` shards the
parameters, the EMA target and AdamW's moments (FSDP2, also over ``model``
under context parallelism); ``pipe`` splits the encoder's blocks into GPipe
stages over ``mesh.pipe_microbatches`` microbatches (`core.sharding`,
`core.pipeline`). The ranks of one ``model`` group and of one ``pipe``
group read the same clips. JAX's refusals stay, with JAX's messages: a
pipeline with context parallelism, a batch (or an accumulation pass) that
the pipeline's microbatches do not divide, a depth that the stages do not
divide, a mesh wider than the world. Only rank 0 writes checkpoints, in the
one-card format (a sharded state is gathered to it first), which any mesh
resumes; the others wait at a barrier. The online evals see the gathered
encoder. Each rank logs to ``log_r{rank}.csv``.

In-process evals: with ``evals`` (eval YAMLs) and ``meta.eval_freq``, every
``eval_freq``-th epoch ends, after its checkpoint, with
`evals.online.make_online_eval`'s probes on the frozen EMA target and the
live predictor, each metric logged to ``eval_log_r{rank}.csv`` (JAX's
`loop.py:503-546`).

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

from vjepa2_tpu_torch.core import distributed, mesh as mesh_lib
from vjepa2_tpu_torch.core.checkpoint import CheckpointManager
from vjepa2_tpu_torch.core.config import PretrainConfig
from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.core.logging import AverageMeter, CSVLogger, get_logger
from vjepa2_tpu_torch.data.manager import init_video_data
from vjepa2_tpu_torch.data.prefetch import device_prefetch
from vjepa2_tpu_torch.data.transforms import VideoTransform
from vjepa2_tpu_torch.data.video import synthetic_clip
from vjepa2_tpu_torch.evals.online import make_online_eval
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.models.vision_transformer import MODEL_REGISTRY
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

    def __init__(self, batch_size: int, fpc, crop_size: int, ipe: int, seed: int = 0,
                 shard: tuple[int, int] = (1, 0)):
        """``shard`` = (ways, index): this rank's rows of the global batch
        of ``batch_size`` clips."""
        ways, index = shard
        self.batch_size = batch_size // ways
        self.fpcs = list(fpc) if isinstance(fpc, (list, tuple)) else [fpc]
        self.crop_size = crop_size
        self.ipe = ipe
        self._batches = {}
        rows = range(index * self.batch_size, (index + 1) * self.batch_size)
        for f in self.fpcs:
            base = synthetic_clip(f, crop_size, crop_size, seed=seed).astype(np.float32) / 255.0
            self._batches[f] = np.stack([np.roll(base, s, axis=2) for s in rows])

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


def check_pipeline(c: PretrainConfig) -> None:
    """JAX's refusals of a pipeline (`vjepa2_tpu/train/loop.py:112-118,174-191`),
    with its messages: with the ring, a batch or an accumulation pass that
    the microbatches do not divide, a depth that the stages do not divide.
    Checked before the mesh, so that one process names them too."""
    m, o = c.mesh, c.optimization
    if m.pipe <= 1:
        return
    assert not c.model.context_parallel, (
        "pipeline and ring-attention context parallelism both re-schedule the block stack; "
        "pick one")
    assert c.data.batch_size % m.pipe_microbatches == 0, (
        f"batch {c.data.batch_size} not divisible by pipe_microbatches={m.pipe_microbatches}")
    depth = MODEL_REGISTRY[c.model.model_name].depth
    assert depth % m.pipe == 0, f"depth {depth} not divisible by pipe={m.pipe}"
    ga = max(1, int(o.grad_accum))
    if ga > 1:
        per_pass = c.data.batch_size // ga
        assert per_pass % m.pipe_microbatches == 0, (
            f"per-accumulation batch {per_pass} not divisible by "
            f"pipe_microbatches={m.pipe_microbatches}")


@dataclass
class ProcessLayout:
    """This rank's place in the config's mesh: its rank, the data group it
    averages gradients over (size ``dp_size``, this rank ``dp_rank`` in it;
    None in one process), the ring of its ``model`` group (None without
    context parallelism) and what shards its state (`core.sharding.Parallel`;
    None when nothing does)."""

    rank: int
    dp_group: object
    dp_size: int
    dp_rank: int
    cp_attend: object
    parallel: object = None


def process_layout(c: PretrainConfig, device, pipe: bool = True) -> ProcessLayout:
    """The mesh over the process group's ranks, as JAX's `Pretrainer` builds
    its device mesh (`loop.py:105-131`): JAX's `resolve` over the world (one
    process with a mesh wider than one fails its assertion, as in JAX),
    then the groups and, with ``model.context_parallel`` and ``model`` > 1,
    the ring; with ``fsdp``, ``model`` or ``pipe`` > 1 the state's
    placement. ``pipe=False`` drops the ``pipe`` axis (JAX's `DroidTrainer`
    builds its mesh without it)."""
    rank, world = distributed.world()
    cfg = mesh_lib.MeshConfig(c.mesh.data, c.mesh.fsdp, c.mesh.model,
                              c.mesh.pipe if pipe else 1)
    d, f, m, p = cfg.resolve(world)
    if d * f * m * p != world:
        raise ValueError(f"mesh {d}x{f}x{m}x{p} leaves {world - d * f * m * p} of {world} "
                         "ranks without a place: every rank trains")
    mesh = mesh_lib.make_mesh(cfg, torch.device(device).type) if world > 1 else None
    dp_group = mesh_lib.data_group(mesh)
    cp = bool(c.model.context_parallel and m > 1)
    cp_attend = parallel = None
    if cp:
        from vjepa2_tpu_torch.ops.ring_attention import seq_sharded_attention

        cp_attend = seq_sharded_attention(mesh_lib.model_group(mesh))
    if f > 1 or m > 1 or p > 1:
        from vjepa2_tpu_torch.core.sharding import Parallel

        parallel = Parallel(mesh, cp=cp, pipe_microbatches=c.mesh.pipe_microbatches)
    return ProcessLayout(rank, dp_group, d * f,
                         0 if dp_group is None else torch.distributed.get_rank(dp_group),
                         cp_attend, parallel)


@dataclass
class Pretrainer:
    cfg: PretrainConfig
    synthetic_data: bool = False
    device: object = "cuda"

    def __post_init__(self):
        c = self.cfg
        self.device = entry_device(self.device)
        check_pipeline(c)
        self.layout = process_layout(c, self.device)
        self.dtype = torch.bfloat16 if c.meta.dtype in ("bfloat16", "bf16") else torch.float32
        self.fpcs = sorted(set(c.data.dataset_fpcs))
        self.model_kwargs = dict(
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
            # JAX's loop drops these two (ROADMAP queue C): the config's MLP trains here
            use_silu=c.model.use_silu,
            wide_silu=c.model.wide_silu,
            use_mask_tokens=c.model.use_mask_tokens,
            num_mask_tokens=len(c.mask) * len(self.fpcs),
            zero_init_mask_tokens=c.model.zero_init_mask_tokens,
            use_flash=True,
            dtype=self.dtype,
            device=self.device,
            use_activation_checkpointing=c.model.use_activation_checkpointing,
            remat_policy=c.model.remat_policy,
        )
        self.encoder, self.predictor = build_models(**self.model_kwargs,
                                                    cp_attend=self.layout.cp_attend)
        o = c.optimization
        self.hp = PretrainHParams(
            lr=o.lr, start_lr=o.start_lr, final_lr=o.final_lr, warmup_epochs=o.warmup,
            epochs=o.epochs, ipe=o.ipe or 300, ipe_scale=o.ipe_scale, wd=o.weight_decay,
            final_wd=o.final_weight_decay, ema=tuple(o.ema), betas=tuple(o.betas), eps=o.eps,
            loss_exp=c.loss.loss_exp)
        self.grad_accum = max(1, int(o.grad_accum))
        validate_grad_accum(c.data.batch_size, self.grad_accum, self.layout.dp_size)
        if self.grad_accum > 1:
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
        # in-process probe evals at eval_freq (reference: eval jobs from the
        # pretrain config's `evals`, `app/vjepa/utils.py:25-87`)
        self.online_eval = make_online_eval(c.evals) if c.evals else None

    # -- data ---------------------------------------------------------------
    def make_loader(self, epoch: int = 0):
        """Epoch ``epoch``'s batches: synthetic clips, or ``data.datasets``
        from disk (ipe batches, in the sampler's order)."""
        c = self.cfg
        lay = self.layout
        if self.synthetic_data or not c.data.datasets:
            return SyntheticVideoLoader(c.data.batch_size, self.fpcs, c.data.crop_size,
                                        self.hp.ipe, c.meta.seed, (lay.dp_size, lay.dp_rank))
        aug = c.data_aug
        transform = VideoTransform(
            crop_size=c.data.crop_size, random_resize_scale=tuple(aug.random_resize_scale),
            random_resize_aspect_ratio=tuple(aug.random_resize_aspect_ratio),
            horizontal_flip=aug.horizontal_flip, motion_shift=aug.motion_shift,
            auto_augment=aug.auto_augment, rand_erase_prob=aug.reprob,
            normalize_on_device=c.data.normalize_on_device)
        # the data group's ranks read disjoint shards (JAX `loop.py:249-250`)
        _, loader, _ = init_video_data(
            data_paths=c.data.datasets, batch_size=c.data.batch_size // lay.dp_size,
            transform=transform, datasets_weights=c.data.datasets_weights,
            dataset_fpcs=c.data.dataset_fpcs, fps=c.data.fps, num_workers=c.data.num_workers,
            world_size=lay.dp_size, rank=lay.dp_rank, ordered=True, ipe=self.hp.ipe,
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
        logger.info("params: encoder %.1fM predictor %.1fM",
                    sum(p.numel() for p in self.encoder.parameters()) / 1e6,
                    sum(p.numel() for p in self.predictor.parameters()) / 1e6)
        par = self.layout.parallel
        if par is None:
            return TrainState.create(self.encoder, self.predictor,
                                     make_optimizer(self.hp, self.encoder, self.predictor))
        # every rank drew the whole weights: each keeps its share
        target = par.place(self.encoder, self.predictor)
        return TrainState(0, self.encoder, self.predictor, target,
                          make_optimizer(self.hp, self.encoder, self.predictor), par)

    def eval_models(self, state: TrainState):
        """(EMA target, predictor) as one process holds them, for the online
        evals: a sharded state's gathered into plain models (every rank
        calls it)."""
        if state.parallel is None:
            return state.target_encoder, state.predictor
        sd = state.state_dict()
        encoder, predictor = build_models(**self.model_kwargs)
        encoder.load_state_dict(sd["target_encoder"])
        predictor.load_state_dict(sd["predictor"])
        return encoder.requires_grad_(False), predictor

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
                norm_stats=self._norm_stats(), grad_accum=self.grad_accum,
                grad_group=self.layout.dp_group)
        return self._step_fns[fpc]

    @property
    def multifpc(self) -> bool:
        return len(self.fpcs) > 1 and bool(self.cfg.optimization.multifpc_within_step)

    def _multifpc_step_fn(self):
        if "multifpc" not in self._step_fns:
            self._step_fns["multifpc"] = make_multifpc_train_step(
                self.hp, len(self.cfg.mask), norm_stats=self._norm_stats(),
                grad_group=self.layout.dp_group)
        return self._step_fns["multifpc"]

    def _host_clips(self, clips) -> torch.Tensor:
        """Host clips in the compute dtype (uint8 stays: the step normalises
        on the card)."""
        clips = torch.from_numpy(np.ascontiguousarray(clips))
        return clips if clips.dtype == torch.uint8 else clips.to(self.dtype)

    def _masks(self, fpc: int, rows: int):
        """The masks of this rank's ``rows`` examples: the collator samples
        them for the global batch (the same on every rank), and the rank
        takes its rows."""
        lay = self.layout
        me, mp = self.collator(fpc, rows * lay.dp_size)
        lo = lay.dp_rank * rows
        return ([torch.from_numpy(np.ascontiguousarray(m[lo:lo + rows])) for m in me],
                [torch.from_numpy(np.ascontiguousarray(m[lo:lo + rows])) for m in mp])

    def stage(self, batch):
        """Host work per batch, on the prefetch thread: the clips' cast and
        the masks of one collator step, sampled over the FULL batch (the
        batch-min truncation statistics unchanged), then split into
        ``grad_accum`` microbatches [A, B/A, ...] (`loop.py:436-446`)."""
        clips_list, _labels, _ci = batch
        clips = self._host_clips(clips_list[0])
        self.collator.step()
        me, mp = self._masks(clips.shape[1], clips.shape[0])
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
            me, mp = self._masks(clips.shape[1], clips.shape[0])
            out_c.append(clips)
            out_me.append(me)
            out_mp.append(mp)
        return tuple(out_c), tuple(out_me), tuple(out_mp)

    # -- loop ---------------------------------------------------------------
    def run(self, epochs: Optional[int] = None, log_every: int = 10,
            preemption_guard=None) -> dict:
        c = self.cfg
        epochs = epochs if epochs is not None else self.hp.epochs
        state = self.restore_or_init()
        preempted = False
        csv = CSVLogger(os.path.join(c.folder, f"log_r{self.layout.rank}.csv"), ("%d", "epoch"),
                        ("%d", "itr"), ("%.5f", "loss"), ("%.2f", "iter_ms"))
        start_epoch = int(state.step) // self.hp.ipe
        # mid-epoch resume (preemption): skip the iterations already trained
        skip_itrs = int(state.step) % self.hp.ipe
        last_loss = float("nan")
        eval_csv = None  # created at the first online eval
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
                if preemption_guard is not None and distributed.any_process(
                        preemption_guard.should_stop):
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
            if (self.online_eval is not None and c.meta.eval_freq
                    and (epoch + 1) % c.meta.eval_freq == 0):
                target, predictor = self.eval_models(state)
                metrics = self.online_eval(target, epoch, predictor=predictor,
                                           shard=(self.layout.dp_size, self.layout.dp_rank))
                logger.info("online eval @ epoch %d: %s", epoch, metrics)
                if eval_csv is None:
                    eval_csv = CSVLogger(os.path.join(c.folder,
                                                      f"eval_log_r{self.layout.rank}.csv"),
                                         ("%d", "epoch"), ("%s", "tag"), ("%.5f", "top1"))
                for tag, top1 in metrics.items():
                    eval_csv.log(epoch, tag, float(top1))
        return {"loss": last_loss, "step": int(state.step), "preempted": False}
