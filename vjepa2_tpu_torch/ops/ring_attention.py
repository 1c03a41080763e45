"""Ring attention: context parallelism over the token dimension (counterpart
of `vjepa2_tpu/ops/ring_attention.py`).

The ranks of one group hold one sequence and take one token shard each; the
K/V shards travel around the ring, rank r sending to r + 1, and at each hop
every rank attends its queries to the block it holds (Liu et al.'s ring
schedule; JAX moves the blocks with ``ppermute``, the port with
``batch_isend_irecv``).

* A hop's forward is B3 (`flash_attention._fwd`, the kernel on a CUDA tensor,
  its plain version on the CPU) with the keys' own segment ids, returning
  the hop's normalised out and lse; the hops merge by their lse (JAX's
  `_merge_hops`, `ring_attention.py:134-149`).
* The backward is JAX's bespoke one (`:180-208`): each hop runs the BHND
  backward (B4/B5, `flash_attention._bwd`) given the GLOBAL out and lse, so
  that p = exp(s - lse) is the globally normalised probability and each
  hop's gradients are its share of the total; dq sums in fp32, dk and dv
  sum in fp32 while they ride the ring with their K/V block, and one more
  rotation brings them home; the K/V rotation after the last hop is
  skipped.
* The forward of a rank is one dispatcher op, ``torch.ops.vjepa2.ring_fwd``,
  whose (out, lse) the selective remat policies keep under JAX's
  ``flash_out`` / ``flash_lse`` names (`models.modules.resolve_remat_policy`),
  so that a recomputed block sends nothing around the ring again.

`seq_sharded_attention(group)` returns ``apply(q, k, v, segment_ids=None)``
over the [B, H, N, D] tensors every rank of ``group`` holds whole (JAX's
takes [B, N, H, D]): each rank takes its token slice of q, k and v, rings
it, and all-gathers the out; the backward mirrors it, all-gathering dq, dk
and dv, so the rest of a block computes on every rank what JAX's
``shard_map`` around the attention computes. N is padded to a multiple of
R * 8 with pad keys on int32-max ids (no real query attends them) and the
pad rows are sliced off (`:329-356`).

`in_process_ring(R)` gives the same ``apply`` over a second transport that
holds the R shards in one process and rotates them by index: the same hops
in the same order and the same merge, so it gives the bits of the process
ring. Tests and ``chip_smoke.py`` use it; no config selects it.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vjepa2_tpu_torch.ops import flash_attention as fa

# the pad keys' id: no query with a real id (< it) attends them
PAD_ID = torch.iinfo(torch.int32).max
QUANTUM = 8  # rows a shard is padded to, per rank

# the live transports by id: the dispatcher op takes the id
_RINGS: dict[int, object] = {}
_NEXT_ID = itertools.count()


class ProcessRing:
    """One shard per process, this rank's (slot 0): a rotation sends each
    block to the next rank of ``group`` and receives the previous rank's."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.index + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.index - 1) % self.size)

    def shards(self, t: torch.Tensor, dim: int) -> list[torch.Tensor]:
        n = t.shape[dim] // self.size
        return [t.narrow(dim, self.index * n, n).contiguous()]

    def start_rotate(self, blocks: list[list[torch.Tensor]]):
        """Post the sends and receives of ``blocks`` (lists of slots);
        `finish_rotate` waits and returns the received lists."""
        ops, recv = [], []
        for tag, slots in enumerate(blocks):
            out = torch.empty_like(slots[0])
            ops.append(dist.P2POp(dist.isend, slots[0].contiguous(), self.next, self.group,
                                  tag))
            ops.append(dist.P2POp(dist.irecv, out, self.prev, self.group, tag))
            recv.append([out])
        return dist.batch_isend_irecv(ops), recv

    @staticmethod
    def finish_rotate(pending):
        works, recv = pending
        for w in works:
            w.wait()
        return recv

    def gather(self, slots: list[torch.Tensor], dim: int) -> torch.Tensor:
        parts = [torch.empty_like(slots[0]) for _ in range(self.size)]
        dist.all_gather(parts, slots[0].contiguous(), group=self.group)
        return torch.cat(parts, dim)


class InProcessRing:
    """All R shards in one process, slot i being rank i's: a rotation hands
    slot i - 1's block to slot i, with no copy."""

    def __init__(self, size: int):
        self.size = size

    def shards(self, t: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [c.contiguous() for c in t.chunk(self.size, dim)]

    def start_rotate(self, blocks):
        return [[slots[-1]] + slots[:-1] for slots in blocks]

    @staticmethod
    def finish_rotate(pending):
        return pending

    def gather(self, slots, dim: int) -> torch.Tensor:
        return torch.cat(slots, dim)


def _hop_fwd(q, k, v, seg_q, seg_k, scale):
    """One hop: (out normalised [B, H, n, D], lse [B, H, n] fp32, natural
    log, -inf where no key is attended)."""
    return fa._fwd(q, k, v, scale, None, None, seg_q, seg_k, False, None)


def _hop_bwd(q, k, v, seg_q, seg_k, out, lse, do, scale):
    """One hop's (dq, dk, dv) given the global (out, lse)."""
    return fa._bwd(q, k, v, out, lse, do, scale, None, None, seg_q, seg_k, False, None)


def merge_hops(outs, lses):
    """Combine the hops' normalised outputs by their lse (JAX's
    `_merge_hops`), in fp32: (out in the hops' dtype, global lse)."""
    lse_stack = torch.stack(lses)  # [R, B, H, n]
    m = lse_stack.amax(0)
    m_safe = m.clamp_min(-0.5e30)
    w = torch.exp(lse_stack - m_safe)
    denom = w.sum(0)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = sum((w[i] / denom)[..., None] * outs[i].float() for i in range(len(outs)))
    lse = torch.where(m > -0.5e30, m_safe + torch.log(denom.clamp_min(1e-38)), float("-inf"))
    return out.to(outs[0].dtype), lse


def ring_forward(ring, q, k, v, seg, scale):
    """The ring's forward over slot lists (one per process, R in process):
    per slot (out, global lse). ``seg``: the slots' [B, n] int32 ids or None."""
    slots = range(len(q))
    k_blk, v_blk, s_blk = list(k), list(v), seg
    outs = [[] for _ in slots]
    lses = [[] for _ in slots]
    for i in range(ring.size):
        pending = None
        if i < ring.size - 1:  # the rotation after the last hop would go unread
            pending = ring.start_rotate([k_blk, v_blk] + ([s_blk] if seg is not None else []))
        for s in slots:
            o, lse = _hop_fwd(q[s], k_blk[s], v_blk[s], None if seg is None else seg[s],
                              None if seg is None else s_blk[s], scale)
            outs[s].append(o)
            lses[s].append(lse)
        if pending is not None:
            got = ring.finish_rotate(pending)
            k_blk, v_blk = got[0], got[1]
            s_blk = got[2] if seg is not None else None
    return [merge_hops(outs[s], lses[s]) for s in slots]


def ring_backward(ring, q, k, v, seg, out, lse, do, scale):
    """JAX's `_ring_core_bwd` over slot lists: per slot (dq, dk, dv) in the
    operands' dtype."""
    slots = range(len(q))
    k_blk, v_blk, s_blk = list(k), list(v), seg
    dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in q]
    dk_blk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in k]
    dv_blk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in v]
    for i in range(ring.size):
        pending = None
        if i < ring.size - 1:
            pending = ring.start_rotate([k_blk, v_blk] + ([s_blk] if seg is not None else []))
        for s in slots:
            dq_i, dk_i, dv_i = _hop_bwd(q[s], k_blk[s], v_blk[s],
                                        None if seg is None else seg[s],
                                        None if seg is None else s_blk[s],
                                        out[s], lse[s], do[s], scale)
            dq[s] = dq[s] + dq_i.float()
            dk_blk[s] = dk_blk[s] + dk_i.float()
            dv_blk[s] = dv_blk[s] + dv_i.float()
        # dk / dv ride with their block after every hop: after R rotations
        # each partial is home
        dk_blk, dv_blk = ring.finish_rotate(ring.start_rotate([dk_blk, dv_blk]))
        if pending is not None:
            got = ring.finish_rotate(pending)
            k_blk, v_blk = got[0], got[1]
            s_blk = got[2] if seg is not None else None
    return ([t.to(x.dtype) for t, x in zip(dq, q)], [t.to(x.dtype) for t, x in zip(dk_blk, k)],
            [t.to(x.dtype) for t, x in zip(dv_blk, v)])


def _ring_fwd(q, k, v, seg, scale, ring_id):
    """This process's forward: its shards of q, k, v [B, H, N, D] (and seg
    [B, N]) around the ring; returns (out [B, H, N, D] gathered from every
    rank, the global lse of this process's rows)."""
    ring = _RINGS[ring_id]
    qs, ks, vs = (ring.shards(t, 2) for t in (q, k, v))
    segs = None if seg is None else ring.shards(seg, 1)
    merged = ring_forward(ring, qs, ks, vs, segs, scale)
    out = ring.gather([o for o, _ in merged], 2)
    return out, torch.cat([lse for _, lse in merged], 2)


_LIB = torch.library.Library("vjepa2", "FRAGMENT")
_LIB.define("ring_fwd(Tensor q, Tensor k, Tensor v, Tensor? seg, float scale, int ring) "
            "-> (Tensor, Tensor)")
_LIB.impl("ring_fwd", _ring_fwd, "CompositeExplicitAutograd")


class RingAttention(torch.autograd.Function):
    """The ring's forward (`_ring_fwd`, one dispatcher op) and its backward
    (`ring_backward` on this process's slices, then dq, dk, dv gathered);
    ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, ring_id):
        out, lse = torch.ops.vjepa2.ring_fwd(q, k, v, seg, scale, ring_id)
        ctx.scale, ctx.ring_id = scale, ring_id
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, seg, out, lse = ctx.saved_tensors
        ring = _RINGS[ctx.ring_id]
        qs, ks, vs, outs, dos = (ring.shards(t, 2) for t in (q, k, v, out, dout))
        segs = None if seg is None else ring.shards(seg, 1)
        lses = [t.contiguous() for t in lse.chunk(len(qs), 2)]
        dq, dk, dv = ring_backward(ring, qs, ks, vs, segs, outs, lses, dos, ctx.scale)
        return ring.gather(dq, 2), ring.gather(dk, 2), ring.gather(dv, 2), None, None, None


def pad_onto_ring(q, k, v, segment_ids, size: int):
    """(q, k, v, seg) with N padded to a multiple of ``size`` * 8: pad rows of
    zeros, the pad keys on `PAD_ID` (JAX `ring_attention.py:329-356`); seg
    [B, N'] int32, or None without ids and pad."""
    B, N = q.shape[0], q.shape[2]
    pad = (-N) % (size * QUANTUM)
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        if segment_ids is None:
            segment_ids = torch.zeros(B, N, dtype=torch.int32, device=q.device)
    if segment_ids is None:
        return q, k, v, None
    seg = segment_ids.to(device=q.device, dtype=torch.int32)
    seg = seg.expand(B, N) if seg.ndim == 1 else seg
    if pad:
        seg = F.pad(seg, (0, pad), value=PAD_ID)
    return q, k, v, seg.contiguous()


def _make_apply(ring):
    ring_id = next(_NEXT_ID)
    _RINGS[ring_id] = ring

    def apply(q, k, v, segment_ids=None):
        """Attention over [B, H, N, D] q, k, v (the whole sequence, the same
        on every rank of the ring), token-sharded around the ring;
        ``segment_ids`` ([N] or [B, N] int): query i attends key j iff
        seg[i] >= seg[j]. Returns [B, H, N, D]."""
        N = q.shape[2]
        q, k, v, seg = pad_onto_ring(q, k, v, segment_ids, ring.size)
        out, _ = RingAttention.apply(q, k, v, seg, 1.0 / math.sqrt(q.shape[-1]), ring_id)
        return out[:, :, :N]

    apply.axis_size = ring.size
    apply.ring, apply.ring_id = ring, ring_id
    return apply


def seq_sharded_attention(group):
    """Attention token-sharded over the ranks of ``group`` (the mesh's
    ``model`` group): every rank calls ``apply`` on the same q, k, v."""
    return _make_apply(ProcessRing(group))


def in_process_ring(size: int):
    """The same ``apply`` with the ``size`` shards held in this process
    (`InProcessRing`): for tests and ``chip_smoke.py``, whose one card holds
    the whole ring."""
    return _make_apply(InProcessRing(size))
