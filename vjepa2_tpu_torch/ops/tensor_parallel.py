"""Megatron tensor parallelism over the mesh's ``model`` group (the port's
counterpart of JAX's GSPMD ``model`` rules, `vjepa2_tpu/core/mesh.py:123-164`).

A column-parallel product (qkv, fc1) keeps this rank's rows of the weight
and gives this rank's columns of the output; a row-parallel product (proj,
fc2) keeps this rank's columns of the weight, gives a partial sum of the
output, and the partial sums add up over the group. Two autograd Functions
carry the activations across (Megatron's f and g):

* `copy_in` before a column-parallel product: identity forward, all-reduce
  of the gradient backward (each rank's input gradient is its heads' share);
* `reduce_out` after a row-parallel product: all-reduce forward, identity
  backward. Its forward is one dispatcher op, ``torch.ops.vjepa2.tp_all_reduce``,
  whose output the selective remat policies keep
  (`models.modules.resolve_remat_policy`), so that a recomputed block sends
  nothing over the group again (the ring's answer, `ops.ring_attention`);
  only ``full`` recomputes it.

Attention splits by heads: each rank holds its heads' rows of q, k and v in
``qkv.weight`` (not a contiguous third: `TensorParallel.rows` with
``parts=3``) and runs every route (plain, DN, BHND, fused) at its local head
count, so the `vjepa2::` custom ops and the kernels take plain tensors. When
the heads do not divide the group (22 heads of ViT-g over 4), the layer
keeps the same rows and gathers the whole qkv weight (`gather_rows`, one
more dispatcher op) to run all heads on every rank, then the row-parallel
projection takes this rank's columns of the output: the function GSPMD
computes for JAX at that shape.

Biases and LayerNorms stay whole on every rank, as in JAX: the bias a
column-parallel product adds is cut in the forward after a `copy_in`, so
its gradient sums over the group; the bias after a row-parallel product is
added after the reduction.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

# the live groups by id: the dispatcher ops take the id
_GROUPS: dict[int, "TensorParallel"] = {}
_NEXT_ID = itertools.count()
# forward collectives run by the dispatcher ops (a recompute that keeps them runs none)
CALLS = {"tp_all_reduce": 0, "tp_all_gather": 0}


class TensorParallel:
    """The ``model`` group a layer's heads and hidden columns split over."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.id = next(_NEXT_ID)
        _GROUPS[self.id] = self

    def __deepcopy__(self, memo):  # a copied model (the EMA target) shares the group
        return self

    def rows(self, t: torch.Tensor, parts: int = 1) -> torch.Tensor:
        """This rank's rows of ``t``: dim 0 cut into ``parts`` equal pieces
        (q, k, v for ``parts=3``), this rank's slice of each, in order."""
        pieces = t.chunk(parts, 0)
        n = pieces[0].shape[0] // self.size
        return torch.cat([p.narrow(0, self.rank * n, n) for p in pieces], 0)

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns (dim 1) of ``t``."""
        n = t.shape[1] // self.size
        return t.narrow(1, self.rank * n, n)

    def gather(self, t: torch.Tensor, dim: int, parts: int = 1) -> torch.Tensor:
        """The whole tensor from every rank's `rows` (dim 0) or `cols`
        (dim 1), on every rank: one all-gather, or, where gloo holds CUDA
        tensors (its all-gather refuses them), a broadcast from each rank."""
        t = t.contiguous()
        if t.is_cuda and dist.get_backend(self.group) == "gloo":
            got = []
            for r in range(self.size):
                buf = t.clone() if r == self.rank else torch.empty_like(t)
                dist.broadcast(buf, dist.get_global_rank(self.group, r), group=self.group)
                got.append(buf)
        else:
            got = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(got, t, group=self.group)
        return unshard(got, dim, parts)


def unshard(shards, dim: int, parts: int = 1) -> torch.Tensor:
    """The inverse of `TensorParallel.rows` / ``cols`` over the shards of
    every rank, in rank order."""
    if parts == 1:
        return torch.cat(shards, dim)
    pieces = [s.chunk(parts, dim) for s in shards]
    return torch.cat([torch.cat([p[i] for p in pieces], dim) for i in range(parts)], dim)


def _all_reduce(x, group):
    CALLS["tp_all_reduce"] += 1
    y = x.contiguous().clone()
    dist.all_reduce(y, group=_GROUPS[group].group)
    return y


def _all_gather(x, group, parts):
    CALLS["tp_all_gather"] += 1
    return _GROUPS[group].gather(x, 0, parts)


_LIB = torch.library.Library("vjepa2", "FRAGMENT")
_LIB.define("tp_all_reduce(Tensor x, int group) -> Tensor")
_LIB.impl("tp_all_reduce", _all_reduce, "CompositeExplicitAutograd")
_LIB.define("tp_all_gather(Tensor x, int group, int parts) -> Tensor")
_LIB.impl("tp_all_gather", _all_gather, "CompositeExplicitAutograd")


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_GROUPS[ctx.group].group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return torch.ops.vjepa2.tp_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, parts):
        ctx.group, ctx.parts = group, parts
        return torch.ops.vjepa2.tp_all_gather(w, group, parts)

    @staticmethod
    def backward(ctx, g):
        # every rank's gradient of the whole weight is its share: sum, keep ours
        tp = _GROUPS[ctx.group]
        g = g.contiguous().clone()
        dist.all_reduce(g, group=tp.group)
        return tp.rows(g, ctx.parts), None, None


def copy_in(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the group."""
    return _CopyIn.apply(x, tp.id)


def reduce_out(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the group (``vjepa2::tp_all_reduce``); the gradient
    passes as it is."""
    return _ReduceOut.apply(x, tp.id)


def gather_rows(w: torch.Tensor, tp: TensorParallel, parts: int = 1) -> torch.Tensor:
    """The whole weight from every rank's `TensorParallel.rows`
    (``vjepa2::tp_all_gather``); backward, this rank's rows of the summed
    gradient."""
    return _GatherRows.apply(w, tp.id, parts)
