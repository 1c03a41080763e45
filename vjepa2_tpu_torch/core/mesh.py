"""The process mesh (counterpart of `vjepa2_tpu/core/mesh.py`).

JAX lays its devices out as one `jax.sharding.Mesh` with the axes
``("pipe", "data", "fsdp", "model")``; the port lays the ranks of its
process group out the same way, ``model`` varying fastest (JAX
`mesh.py:103`), as a `torch.distributed.device_mesh.DeviceMesh`. What the
trainers use of it:

* ``data`` (with ``fsdp``): the batch splits over these ranks and the
  gradients are averaged over them (`data_group`);
* ``fsdp``: ZeRO-3 parameter sharding (`core.sharding`, FSDP2 over the
  ``(data, fsdp)`` ranks of one ``(pipe, model)`` place: replicated over
  ``data``, sharded over ``fsdp``);
* ``model`` with ``model.context_parallel``: the ranks of one group hold one
  clip and ring its attention over the token dimension (`model_group`,
  `ops.ring_attention.seq_sharded_attention`); without it, Megatron tensor
  parallelism: each rank holds its heads and hidden columns
  (`ops.tensor_parallel`);
* ``pipe``: GPipe stages of the encoder's blocks (`core.pipeline`).

`param_placement` is JAX's `param_spec` (`mesh.py:123-164`) in the port's
layout: which dims of each parameter the ``fsdp`` and ``model`` axes cut.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch.distributed as dist

from vjepa2_tpu_torch.core.distributed import world

AXES = ("pipe", "data", "fsdp", "model")


@dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining ranks
    fsdp: int = 1
    model: int = 1
    pipe: int = 1

    def resolve(self, n_ranks: Optional[int] = None) -> tuple[int, int, int, int]:
        """(data, fsdp, model, pipe) over ``n_ranks`` (the world by default),
        JAX's `resolve` (`mesh.py:34-44`) over ranks: ``data: -1`` takes the
        rest; an explicit mesh may use a subset of the ranks."""
        n = n_ranks if n_ranks is not None else world()[1]
        d, f, m, p = self.data, self.fsdp, self.model, self.pipe
        if d == -1:
            assert n % (f * m * p) == 0, (
                f"{n} devices not divisible by fsdp*model*pipe={f * m * p}")
            d = n // (f * m * p)
        assert d * f * m * p <= n, f"mesh {d}x{f}x{m}x{p} > {n} devices"
        return d, f, m, p


def _default_slice_of(dv) -> int:
    return getattr(dv, "slice_index", 0) or 0


def arrange_hybrid(devices, slice_of=None) -> list:
    """Order ranks so that those of one node are contiguous, node varying
    slowest (JAX's multi-slice rule, with a GPU node in a slice's place):
    ``data`` then crosses nodes and ``fsdp`` / ``model`` stay inside one.
    torchrun and SLURM already number the ranks of a node contiguously, so
    by default (``slice_of`` reads a ``slice_index`` attribute, which a rank
    lacks) the order is returned untouched; ``slice_of`` injects a node
    assignment."""
    slice_of = slice_of or _default_slice_of
    slices = {slice_of(dv) for dv in devices}
    if len(slices) <= 1:
        return list(devices)
    return sorted(devices, key=lambda dv: (slice_of(dv), getattr(dv, "id", 0)))


def mesh_layout(cfg: MeshConfig, devices, slice_of=None) -> np.ndarray:
    """The [pipe, data, fsdp, model] array of ``devices`` (ranks) that
    `make_mesh` builds, with JAX's check that ``fsdp`` x ``model`` divides
    each node's count."""
    devices = arrange_hybrid(list(devices), slice_of=slice_of)
    d, f, m, p = cfg.resolve(len(devices))
    slice_of = slice_of or _default_slice_of
    counts: dict = {}
    for dv in devices[: d * f * m * p]:
        counts[slice_of(dv)] = counts.get(slice_of(dv), 0) + 1
    if len(counts) > 1:
        bad = {s: n for s, n in counts.items() if n % (f * m)}
        assert not bad, (
            f"devices-per-slice {bad} not divisible by fsdp*model={f * m}: "
            "per-layer fsdp/model collectives would cross DCN every step; "
            "shrink fsdp/model or use whole slices")
    arr = np.empty(d * f * m * p, dtype=object)
    arr[:] = devices[: d * f * m * p]
    return arr.reshape(p, d, f, m)


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda", slice_of=None):
    """The ``("pipe", "data", "fsdp", "model")`` `DeviceMesh` over the
    process group's ranks (`mesh_layout`), with its data-parallel group
    (``data`` x ``fsdp``) and its ``model`` group built beside it
    (`data_group`, `model_group`). Every rank calls it, in the same order."""
    from torch.distributed.device_mesh import DeviceMesh

    layout = mesh_layout(cfg, range(world()[1]), slice_of=slice_of)
    ranks = layout.astype(np.int64)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=AXES)
    p, d, f, m = ranks.shape
    # the data-parallel group spans (data, fsdp) at one (pipe, model) place
    dp_lists = [ranks[i, :, :, j].reshape(-1).tolist() for i in range(p) for j in range(m)]
    mesh.dp_group = _subgroup(dp_lists)
    mesh.model_group = mesh.get_group("model")
    mesh.pipe_group = mesh.get_group("pipe")
    return mesh


def _subgroup(rank_lists):
    """This rank's group among ``rank_lists`` (every rank creates them all)."""
    mine = None
    me = dist.get_rank()
    for ranks in rank_lists:
        g = dist.new_group(ranks)
        if me in ranks:
            mine = g
    return mine


def data_group(mesh):
    """The ranks this rank averages its gradients with (``data`` x
    ``fsdp``); None without a mesh."""
    return None if mesh is None else mesh.dp_group


def model_group(mesh):
    """The ranks that share this rank's clip (``model``); None without a mesh."""
    return None if mesh is None else mesh.model_group


def pipe_group(mesh):
    """The ranks that hold this rank's place on the other pipeline stages
    (``pipe``); None without a mesh."""
    return None if mesh is None else mesh.pipe_group


def state_group(mesh):
    """The ranks of this rank's data index (``pipe`` x ``fsdp`` x ``model``),
    which hold one copy of the train state between them: a global norm sums
    over them. Every rank calls it, in the same order."""
    ranks = mesh.mesh.numpy()
    return _subgroup([ranks[:, i].reshape(-1).tolist() for i in range(ranks.shape[1])])


def shard_mesh(mesh, cp: bool = False):
    """The 2-D ``(data, fsdp)`` mesh FSDP2 shards this rank's parameters
    over (replicated over ``data``); with ``cp`` the second axis is
    ``(fsdp, model)`` combined (JAX's ``cp=True`` rule). Every rank calls
    it, in the same order."""
    if not cp:
        return mesh["data", "fsdp"]
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.mesh.numpy()
    p, d, f, m = ranks.shape
    combined = DeviceMesh(mesh.device_type, ranks.reshape(p, d, f * m),
                          mesh_dim_names=("pipe", "data", "shard"))
    return combined["data", "shard"]


def _torch_to_flax_dims(name: str, ndim: int) -> list[int]:
    """For each dim of the JAX leaf, the port's dim holding it: a Dense
    kernel [in, out] is the transposed ``weight`` [out, in]; a conv kernel
    [t, p, p, C, D] is ``weight`` [D, C, t, p, p], an image's [p, p, C, D]
    ``weight`` [D, C, p, p] (`hub.converter`); other leaves keep their
    order."""
    if name.endswith("weight") and ndim == 2:
        return [1, 0]
    if name.endswith("weight") and ndim == 4:
        return [2, 3, 1, 0]
    if name.endswith("weight") and ndim == 5:
        return [2, 3, 4, 1, 0]
    return list(range(ndim))


def param_placement(name: str, shape, tp: bool = True, cp: bool = False) -> tuple:
    """JAX's `param_spec` (`core/mesh.py:123-164`) for the port's parameter
    ``name`` of ``shape``: one entry a dim, None (whole), ``"fsdp"``,
    ``"model"`` or ``("fsdp", "model")``.

    * 1-D parameters (biases, LayerNorms) are replicated;
    * with ``tp``, qkv / ``kv`` / fc1 (and an MLP weight that widens) are
      column-parallel: the output dim on ``model``, the input dim on
      ``fsdp``; attn.proj / fc3 (and an fc2 that narrows) are row-parallel:
      the input dim on ``model``, the output dim on ``fsdp``;
    * every other matrix is ZeRO-sharded on its largest dim as JAX's leaf
      lays it out (the first of equal dims), over ``fsdp``, or over
      ``("fsdp", "model")`` with ``cp``.
    """
    if tp and cp:
        raise ValueError("the 'model' axis carries either tensors (tp) or tokens (cp), not both")
    shape = tuple(shape)
    if len(shape) < 2:
        return (None,) * len(shape)
    order = _torch_to_flax_dims(name, len(shape))  # JAX dim i is the port's dim order[i]
    flax_shape = [shape[d] for d in order]
    spec = [None] * len(shape)
    if len(shape) == 2 and tp:
        d_in, d_out = flax_shape
        is_qkv = name.endswith("qkv.weight") or name.endswith("kv.weight")
        col = is_qkv or "mlp.fc1" in name or (d_out > d_in and "mlp" in name)
        row = ("attn.proj" in name or "mlp.fc3" in name
               or ("mlp.fc2" in name and d_out < d_in))
        if col or row:
            spec[order[0]], spec[order[1]] = ("fsdp", "model") if col else ("model", "fsdp")
            return tuple(spec)
    spec[order[int(np.argmax(flax_shape))]] = ("fsdp", "model") if cp else "fsdp"
    return tuple(spec)
