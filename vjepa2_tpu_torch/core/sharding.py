"""Parameter sharding, tensor parallelism and pipeline stages of one train
state (counterpart of `vjepa2_tpu/core/mesh.py:167 shard_params` and
`vjepa2_tpu/train/pretrain.py:359-378 shard_state`).

`Parallel` holds this rank's place in the mesh and puts the models there,
in two steps, on models whose weights were drawn whole (every rank draws
the same weights from the seed, so a sharded run starts where one process
does):

* `Parallel.split_` (before the EMA target is copied): the ``model`` axis
  without context parallelism keeps each block's heads and hidden columns
  (`models.modules.Attention.shard_heads_`, `Mlp.shard_hidden_`); the
  ``pipe`` axis keeps the encoder's stage of blocks (`core.pipeline`).
* `Parallel.shard_`: FSDP2 (`fully_shard`) per block and at the root of each
  model over the ``(data, fsdp)`` mesh: replicated over ``data``, sharded
  over ``fsdp`` (HSDP), or over ``(fsdp, model)`` combined under context
  parallelism (JAX's ``cp=True`` rule). Each matrix is cut on the dim
  `core.mesh.param_placement` gives ``fsdp``; biases and LayerNorms stay
  whole (FSDP ignores them) and their gradients are averaged over the data
  group as before. Parameters stay fp32 and every bf16 cast stays where the
  modules make it: FSDP gathers fp32 and reduces fp32.

After the backward (`finish_gradients`): FSDP has reduce-scattered the
sharded gradients; the whole ones are averaged over the data group; the
patch embedding, whose gradient only the first stage computes, is summed
over ``pipe``. `grad_norm` is JAX's ``optax.global_norm``: each rank's
squares, a parameter held whole on several ranks of the state group
counted once, summed over ``pipe`` x ``fsdp`` x ``model``.

`full_state_dict` gathers a state to the layout one process writes (the
same keys, the optimizer's moments indexed as one process indexes them),
on every rank; `load_full_state_dict` cuts such a dict to this rank's
shares, so a checkpoint restores onto any mesh.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from vjepa2_tpu_torch.core import mesh as mesh_lib
from vjepa2_tpu_torch.core.distributed import mean_
from vjepa2_tpu_torch.core.optim import global_norm
from vjepa2_tpu_torch.core.pipeline import Pipeline, ProcessPipe
from vjepa2_tpu_torch.ops.tensor_parallel import TensorParallel

# the TP cut of a block's matrices: (rows or cols, pieces along dim 0); a
# SwiGLU MLP's fc2 is column-parallel as its fc1 and fc3 row-parallel
_TP_RULES = {"attn.qkv.weight": (0, 3), "attn.proj.weight": (1, 1),
             "mlp.fc1.weight": (0, 1), "mlp.fc2.weight": (1, 1)}
_SWIGLU_TP_RULES = {**_TP_RULES, "mlp.fc2.weight": (0, 1), "mlp.fc3.weight": (1, 1)}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def _block_index(name: str, prefix: str) -> Optional[int]:
    if not name.startswith(prefix + "."):
        return None
    return int(name[len(prefix) + 1:].split(".")[0])


@dataclass
class _Layout:
    """A model's parameters as one process holds them: name -> (shape,
    TP rule or None, owning stage or None for every stage)."""

    params: dict = field(default_factory=dict)
    fsdp_dims: dict = field(default_factory=dict)  # name -> dim FSDP cuts


class Parallel:
    """This rank's place in the mesh and what it does to a train state.

    ``tp``: the `ops.tensor_parallel.TensorParallel` of the ``model`` group
    (None with ``model`` 1 or under context parallelism); ``pipeline``: the
    `core.pipeline.Pipeline` of the encoder's stages (None with ``pipe``
    1); ``fsdp_mesh``: the 2-D mesh FSDP2 shards over (None when the
    shard axis has one rank, unless ``shard`` asks for FSDP2 all the same);
    ``dp_group``: the data group; ``state_group``: the ranks of this rank's
    data index; ``pipe_group``."""

    def __init__(self, mesh, cp: bool = False, pipe_microbatches: int = 1,
                 shard: bool | None = None):
        d, f, m, p = (mesh.size(mesh_lib.AXES.index(a)) for a in ("data", "fsdp", "model",
                                                                  "pipe"))
        self.sizes = {"data": d, "fsdp": f, "model": m, "pipe": p}
        self.cp = cp
        self.dp_group = mesh_lib.data_group(mesh)
        self.state_group = mesh_lib.state_group(mesh)
        self.pipe_group = mesh_lib.pipe_group(mesh)
        self.tp = TensorParallel(mesh_lib.model_group(mesh)) if m > 1 and not cp else None
        self.shard_size = f * (m if cp else 1)
        if shard is None:
            shard = self.shard_size > 1
        self.fsdp_mesh = mesh_lib.shard_mesh(mesh, cp) if shard else None
        self.pipe_microbatches = pipe_microbatches
        self.pipeline = None
        self.layouts: dict[str, _Layout] = {}
        self.encoder_prefix = None  # the pipelined encoder's key in a state dict
        self._replicas: dict = {}

    def __deepcopy__(self, memo):
        return self

    # -- placing the models ---------------------------------------------
    def split_(self, name: str, model: nn.Module, blocks: str, pipelined: bool = False,
               tensor_parallel: bool = True) -> nn.Module:
        """Record ``model``'s whole layout under ``name`` (its state-dict key),
        then keep this rank's share of its ``blocks`` (the ModuleList's
        attribute): their heads and hidden columns, and with ``pipelined``
        the encoder's stage."""
        lay = _Layout()
        tp = self.tp if tensor_parallel else None
        n_blocks = len(getattr(model, blocks))
        if pipelined and self.sizes["pipe"] > 1:
            self.pipeline = Pipeline(ProcessPipe(self.pipe_group), self.pipe_microbatches,
                                     n_blocks)
            self.encoder_prefix = name
        stage_of = {}
        if pipelined and self.pipeline is not None:
            stage_of = {i: s for s in range(self.sizes["pipe"])
                        for i in self.pipeline.stage_blocks(s)}
        for pname, prm in model.named_parameters():
            i = _block_index(pname, blocks)
            rule = None
            if tp is not None and i is not None:
                swiglu = hasattr(getattr(model, blocks)[i].mlp, "fc3")
                rule = (_SWIGLU_TP_RULES if swiglu else _TP_RULES).get(pname.split(".", 2)[2])
            spec = mesh_lib.param_placement(pname, prm.shape, tp=tp is not None, cp=self.cp)
            shard = [d for d, a in enumerate(spec) if a in ("fsdp", ("fsdp", "model"))]
            lay.params[pname] = (tuple(prm.shape), rule, stage_of.get(i))
            if shard:
                lay.fsdp_dims[pname] = shard[0]
        self.layouts[name] = lay
        if pipelined and self.pipeline is not None:
            model.pipeline_(self.pipeline)
        if tp is not None:
            kept = [blk for blk in getattr(model, blocks) if not isinstance(blk, nn.Identity)]
            for blk in kept:
                blk.attn.shard_heads_(tp)
                blk.mlp.shard_hidden_(tp)
            model.perm_heads = kept[0].attn.num_heads
        return model

    def shard_(self, name: str, model: nn.Module, blocks: str, layout: str | None = None
               ) -> nn.Module:
        """FSDP2 over ``fsdp_mesh``: each block of ``blocks``, then the root;
        ``layout``: the recorded layout to follow (``name``'s by default; the
        EMA target follows the encoder's)."""
        lay = self.layouts[layout or name]
        if layout is not None:
            self.layouts[name] = lay
        if self.fsdp_mesh is None:
            self._count_replicas(name, model)
            return model
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dims = {prm: lay.fsdp_dims[n] for n, prm in model.named_parameters()
                if n in lay.fsdp_dims}
        ignored = {prm for prm in model.parameters() if prm not in dims}

        def place(prm):
            return Shard(dims[prm])

        # the root reshards after its forward too: the EMA target runs no backward
        kw = dict(mesh=self.fsdp_mesh, shard_placement_fn=place, ignored_params=ignored,
                  reshard_after_forward=True)
        for blk in getattr(model, blocks):
            if any(True for _ in blk.parameters()):
                fully_shard(blk, **kw)
        fully_shard(model, **kw)
        self._count_replicas(name, model)
        return model

    def _count_replicas(self, name: str, model: nn.Module) -> None:
        """How many ranks of the state group hold each parameter whole."""
        lay = self.layouts[name]
        s = self.sizes
        for pname, prm in model.named_parameters():
            _, rule, owner = lay.params[pname]
            sharded = _is_dtensor(prm)
            if self.cp:
                r = 1 if sharded else self.shard_size
            else:
                r = (1 if sharded else s["fsdp"]) * (1 if rule is not None else s["model"])
            if owner is None:
                r *= s["pipe"]
            self._replicas[prm] = r

    def place(self, encoder, predictor):
        """A pretrain state's three models placed: split the encoder and the
        predictor, copy the target from the split encoder, shard all three.
        Returns the target."""
        self.split_("encoder", encoder, "blocks", pipelined=True)
        self.split_("predictor", predictor, "predictor_blocks")
        target = copy.deepcopy(encoder).requires_grad_(False)
        self.shard_("encoder", encoder, "blocks")
        self.shard_("predictor", predictor, "predictor_blocks")
        self.shard_("target_encoder", target, "blocks", layout="encoder")
        return target

    def place_droid(self, target_encoder, predictor) -> None:
        """The DROID state's models placed: the AC predictor's heads over
        ``model`` (JAX's `DroidTrainer` puts them there), the frozen encoder
        whole over ``model``; both sharded over ``fsdp``."""
        self.split_("predictor", predictor, "predictor_blocks")
        self.split_("target_encoder", target_encoder, "blocks", tensor_parallel=False)
        self.shard_("predictor", predictor, "predictor_blocks")
        self.shard_("target_encoder", target_encoder, "blocks")

    # -- the step -------------------------------------------------------
    def set_gradient_sync(self, models, flag: bool) -> None:
        """FSDP's reduce-scatter on (``flag``) or off for the next backward
        (accumulation runs one reduction a step)."""
        if self.fsdp_mesh is None:
            return
        for m in models:
            m.set_requires_gradient_sync(flag)

    @torch.no_grad()
    def finish_gradients(self, named_params) -> None:
        """After the backward: the whole parameters' gradients averaged over
        the data group; the first stage's patch-embedding gradient summed
        over ``pipe`` (zeros where a stage computed none)."""
        whole = []
        for name, prm in named_params:
            if self.pipeline is not None and name.startswith(f"{self.encoder_prefix}."
                                                             "patch_embed."):
                if prm.grad is None:
                    prm.grad = torch.zeros_like(prm)
                dist.all_reduce(_local(prm.grad), group=self.pipe_group)
            if prm.grad is not None and not _is_dtensor(prm.grad):
                whole.append(prm.grad)
        mean_(whole, self.dp_group)

    @torch.no_grad()
    def grad_norm(self, params) -> torch.Tensor:
        """JAX's ``optax.global_norm`` of the whole gradient."""
        params = [p for p in params if p.grad is not None]
        return global_norm([_local(p.grad) for p in params], self.state_group,
                           [self._replicas[p] for p in params])

    # -- state dicts ----------------------------------------------------
    def _owns(self, owner) -> bool:
        return owner is None or self.pipeline is None or owner in self.pipeline.pipe.stages

    def _staged(self, owner) -> bool:
        """Whether one stage of a pipeline over processes holds it."""
        return owner is not None and self.pipeline is not None and self.sizes["pipe"] > 1

    def _from_stage(self, t: torch.Tensor, owner) -> torch.Tensor:
        """``t`` as the owning stage holds it, on every stage (a broadcast)."""
        t = t.contiguous()
        dist.broadcast(t, dist.get_global_rank(self.pipe_group, owner), group=self.pipe_group)
        return t

    def gather(self, t, rule, owner, shape, device):
        """The whole tensor of a parameter (or a moment shaped as it), on
        every rank (collectives: FSDP over its mesh, TP over ``model``,
        then a broadcast from the owning stage)."""
        if self._owns(owner):
            t = t.full_tensor() if _is_dtensor(t) else t
            if rule is not None and self.tp is not None:
                t = self.tp.gather(t, rule[0], rule[1])
            t = t.detach()
        if self._staged(owner):
            t = self._from_stage(t if self._owns(owner) else torch.empty(shape, device=device),
                                 owner)
        return t.cpu().clone()

    def _cut(self, full: torch.Tensor, prm, rule) -> torch.Tensor:
        """This rank's share of ``full`` as ``prm`` holds it (local tensor)."""
        t = full
        if rule is not None and self.tp is not None:
            t = self.tp.rows(t, rule[1]) if rule[0] == 0 else self.tp.cols(t)
        if _is_dtensor(prm):
            for mesh_dim, pl in enumerate(prm.placements):
                if pl.is_shard():
                    n = prm.device_mesh.size(mesh_dim)
                    c = prm.device_mesh.get_local_rank(mesh_dim)
                    chunks = t.chunk(n, pl.dim)
                    t = chunks[c] if c < len(chunks) else t.narrow(pl.dim, 0, 0)
        return t

    def model_state_dict(self, name: str, model: nn.Module) -> dict:
        lay = self.layouts[name]
        local = dict(model.named_parameters())
        device = next(iter(local.values())).device
        return {pname: self.gather(local.get(pname), rule, owner, shape, device)
                for pname, (shape, rule, owner) in lay.params.items()}

    @torch.no_grad()
    def load_model_state_dict(self, name: str, model: nn.Module, sd: dict) -> None:
        lay = self.layouts[name]
        for pname, prm in model.named_parameters():
            _, rule, _ = lay.params[pname]
            _local(prm).copy_(self._cut(sd[pname].to(prm.device), prm, rule))

    def _full_order(self, models: dict) -> list[tuple[str, str]]:
        """(model key, name) of every trained parameter in the order one
        process's `ScheduledAdamW` indexes them: the decayed (ndim >= 2)
        first, then the rest."""
        names = [(key, n) for key in models for n, (shape, _, _) in
                 self.layouts[key].params.items()]
        decay = [kn for kn in names if len(self.layouts[kn[0]].params[kn[1]][0]) >= 2]
        rest = [kn for kn in names if len(self.layouts[kn[0]].params[kn[1]][0]) < 2]
        return decay + rest

    def optimizer_state_dict(self, optimizer, models: dict) -> dict:
        """The optimizer's state as one process's `ScheduledAdamW` saves it."""
        opt = optimizer.opt
        by_param = {prm: (key, n) for key, m in models.items()
                    for n, prm in m.named_parameters()}
        local = {by_param[p]: p for g in opt.param_groups for p in g["params"]}
        order = self._full_order(models)
        state = {}
        device = next(iter(local.values())).device
        for idx, (key, n) in enumerate(order):
            shape, rule, owner = self.layouts[key].params[n]
            prm = local.get((key, n))
            st = opt.state.get(prm, {}) if prm is not None else {}
            # every rank takes part in the same gathers: whether the owning
            # stage holds a state (a parameter no step has touched has none)
            # and its step count reach the other stages
            has = bool(st)
            if self._staged(owner):
                has = bool(self._from_stage(torch.tensor([int(has)], device=device), owner))
            if not has:
                continue
            entry = {k: self.gather(st.get(k), rule, owner, shape, device)
                     for k in ("exp_avg", "exp_avg_sq")}
            step = st["step"] if st else torch.zeros(())
            if self._staged(owner):
                step = self._from_stage(step.to(device, torch.float32), owner)
            entry["step"] = step.detach().cpu().clone()
            state[idx] = entry
        n_decay = sum(1 for k, n in order if len(self.layouts[k].params[n][0]) >= 2)
        groups = []
        for g in opt.param_groups:
            ids = range(n_decay) if g["decay"] else range(n_decay, len(order))
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(ids)})
        return {"state": state, "param_groups": groups}

    @torch.no_grad()
    def load_optimizer_state_dict(self, optimizer, models: dict, sd: dict) -> None:
        from torch.distributed.tensor import DTensor

        opt = optimizer.opt
        index = {kn: i for i, kn in enumerate(self._full_order(models))}
        for key, m in models.items():
            for n, prm in m.named_parameters():
                saved = sd["state"].get(index[(key, n)])
                if saved is None or not prm.requires_grad:
                    continue
                _, rule, _ = self.layouts[key].params[n]
                st = {"step": saved["step"].clone()}
                for k in ("exp_avg", "exp_avg_sq"):
                    t = self._cut(saved[k].to(prm.device), prm, rule).clone()
                    if _is_dtensor(prm):
                        t = DTensor.from_local(t, prm.device_mesh, prm.placements,
                                               run_check=False, shape=prm.shape,
                                               stride=prm.stride())
                    st[k] = t
                opt.state[prm] = st

