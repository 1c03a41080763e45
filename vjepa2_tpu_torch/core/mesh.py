"""The process mesh (counterpart of `vjepa2_tpu/core/mesh.py`).

JAX lays its devices out as one `jax.sharding.Mesh` with the axes
``("pipe", "data", "fsdp", "model")``; the port lays the ranks of its
process group out the same way, ``model`` varying fastest (JAX
`mesh.py:103`), as a `torch.distributed.device_mesh.DeviceMesh`. What the
trainers use of it:

* ``data`` (with ``fsdp``): the batch splits over these ranks and the
  gradients are averaged over them (`data_group`);
* ``model`` with ``model.context_parallel``: the ranks of one group hold one
  clip and ring its attention over the token dimension (`model_group`,
  `ops.ring_attention.seq_sharded_attention`).

Parameter sharding (``fsdp`` > 1, `param_spec`'s tensor-parallel rules) and
the ``pipe`` axis are not ported (ROADMAP A12b); the trainers refuse them.
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
