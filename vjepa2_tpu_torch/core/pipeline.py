"""GPipe pipeline parallelism over the mesh's ``pipe`` axis (counterpart of
`vjepa2_tpu/core/pipeline.py`).

The encoder's blocks split into P contiguous stages of depth / P blocks;
the batch splits into M microbatches that stream through the stages (fill
and drain, M + P - 1 slots). Each stage owns its blocks; the embedding
before them and the final norm after them run on every stage, so each stage
builds the per-microbatch aux it needs (position ids, RoPE tables,
``kv_valid``, the qkv row permutation) itself and only the boundary
activations travel (JAX's `:140-196`). The last stage's tokens reach every
stage, and the predictor and the loss run replicated over ``pipe`` (JAX's
`:327-350`): every pipe rank computes the same predictor gradients.

The schedule (`pipeline_blocks`) is written against a transport, as the
ring is (`ops.ring_attention`):

* `ProcessPipe`: one stage a process over the ``pipe`` group. A stage
  receives its input from the previous rank and sends its output to the
  next; the backward runs the reverse pipeline through the autograd graph
  itself: a receive's backward sends the input's gradient back, a send's
  backward receives the output's gradient. The last stage broadcasts its
  tokens to the group, and its backward keeps the last stage's own
  gradient. Autograd runs each process's nodes in reverse creation order,
  so the ranks meet their sends and receives in the same order.
* `InProcessPipe`: every stage in one process, stage after stage, the
  boundary handed on with no copy: the same blocks on the same inputs in
  the same order, so it gives the process pipe's bits. Tests and
  ``chip_smoke.py`` use it; no config selects it.

``jax.checkpoint`` around each stage (`:133-137`) is `models.modules.remat_call`
around it, under the model's remat policy. Gradient accumulation runs the
whole schedule once a pass (`train.accum`).

JAX stacks the blocks' leaves on a [depth, ...] axis for its ``scan``
(`split_block_params`, `pp_wd_mask`, `tools/convert_pp_layout.py`); the
port's stage keeps its blocks under their own names (``blocks.{i}``), so a
state dict has one layout whatever the mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Recv(torch.autograd.Function):
    """Forward: the previous stage's boundary; backward: its gradient sent back."""

    @staticmethod
    def forward(ctx, anchor, like, src, group):
        ctx.src, ctx.group = src, group
        t = torch.empty_like(like)
        dist.recv(t, src, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.src, group=ctx.group)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Forward: the boundary sent to the next stage (returns an empty token
    that ties the send into the graph); backward: its gradient received."""

    @staticmethod
    def forward(ctx, x, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.like = (x.shape, x.dtype, x.device)
        dist.send(x.contiguous(), dst, group=group)
        return x.new_zeros(0)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.dst, group=ctx.group)
        return g, None, None


class _Collect(torch.autograd.Function):
    """The last stage's tokens on every stage (a broadcast); backward, the
    last stage keeps its gradient and the other stages' sends get theirs."""

    @staticmethod
    def forward(ctx, out, src, group, is_last, *sent):
        ctx.is_last = is_last
        ctx.sent = [(s.dtype, s.device) for s in sent]
        t = out.contiguous().clone() if is_last else torch.empty_like(out)
        dist.broadcast(t, src, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros(0, dtype=dt, device=dv) for dt, dv in ctx.sent]
        return (g if ctx.is_last else None, None, None, None, *zeros)


class ProcessPipe:
    """One stage a process: this rank runs stage ``group``-rank of ``size``."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.stages = (self.index,)
        self.prev = dist.get_global_rank(group, (self.index - 1) % self.size)
        self.next = dist.get_global_rank(group, (self.index + 1) % self.size)
        self.last = dist.get_global_rank(group, self.size - 1)
        self._sent: list = []
        self._anchor = None

    def begin(self, tokens):
        self._sent = []
        self._anchor = tokens.new_zeros(0).requires_grad_(torch.is_grad_enabled())

    def receive(self, like):
        return _Recv.apply(self._anchor, like, self.prev, self.group)

    def hand_on(self, x):
        self._sent.append(_Send.apply(x, self.next, self.group))
        return None

    def collect(self, outs, like):
        is_last = self.index == self.size - 1
        out = torch.cat(outs) if is_last else like
        return _Collect.apply(out, self.last, self.group, is_last, *self._sent)


class InProcessPipe:
    """Every stage in this process, one after the other."""

    def __init__(self, size: int):
        self.size = size
        self.stages = tuple(range(size))

    def begin(self, tokens):
        pass

    @staticmethod
    def receive(x):
        return x

    @staticmethod
    def hand_on(x):
        return x

    @staticmethod
    def collect(outs, like):
        return torch.cat(outs)


def _chunk(value, m: int):
    """``value`` (a tensor, a tuple of them, or None) cut into ``m`` along
    its batch dim."""
    if value is None:
        return [None] * m
    if isinstance(value, (tuple, list)):
        return [tuple(parts) for parts in zip(*(_chunk(v, m) for v in value))]
    return list(value.chunk(m))


def pipeline_blocks(stage_apply, tokens: torch.Tensor, aux_mb: dict, aux_bc: dict, pipe,
                    n_microbatch: int) -> torch.Tensor:
    """The GPipe schedule: ``stage_apply(s, x, aux) -> x`` runs stage ``s``
    on one microbatch; ``aux`` merges this microbatch's slice of ``aux_mb``
    (leading batch dims) and the shared ``aux_bc``. Returns the last
    stage's tokens for the whole batch, on every stage of ``pipe``."""
    b = tokens.shape[0]
    if b % n_microbatch:
        raise ValueError(f"batch {b} not divisible by microbatches {n_microbatch}")
    tok = tokens.chunk(n_microbatch)
    per = {k: _chunk(v, n_microbatch) for k, v in aux_mb.items()}
    pipe.begin(tokens)
    outs = []
    for j in range(n_microbatch):
        aux = {**aux_bc, **{k: v[j] for k, v in per.items()}}
        x = tok[j]
        for s in pipe.stages:
            if s > 0:
                x = pipe.receive(x)
            x = stage_apply(s, x, aux)
            if s < pipe.size - 1:
                x = pipe.hand_on(x)
        if pipe.size - 1 in pipe.stages:
            outs.append(x)
    return pipe.collect(outs, tokens)


class Pipeline:
    """A model's pipeline: the transport, M microbatches and the stages'
    blocks (contiguous runs of depth / P)."""

    def __init__(self, pipe, n_microbatch: int, depth: int):
        if depth % pipe.size:
            raise ValueError(f"depth {depth} not divisible by pipe={pipe.size}")
        self.pipe, self.n_microbatch = pipe, n_microbatch
        self.per_stage = depth // pipe.size

    def __deepcopy__(self, memo):  # a copied model (the EMA target) shares the transport
        return self

    def stage_blocks(self, s: int) -> range:
        return range(s * self.per_stage, (s + 1) * self.per_stage)

    def owned(self) -> list[int]:
        """The blocks this process holds."""
        return [i for s in self.pipe.stages for i in self.stage_blocks(s)]
