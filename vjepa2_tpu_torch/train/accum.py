"""Gradient accumulation for the pretrain step (counterpart of
`vjepa2_tpu/train/accum.py`).

``grad_accum > 1`` splits a batch into sequential microbatches: one forward
and backward pass each, whose gradients sum in the parameters' ``.grad``
(activations are freed between passes), then one multiply by ``1 / A``
before ONE optimizer update. JAX sums in a ``lax.scan`` and multiplies by the
inverse, not a division (`accum.py:47-51`); the loss is averaged the same
way. Capability the reference lacks: it scales effective batch by adding
nodes (`configs/train/vitl16/cooldown-256px-64f.yaml:5-17`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from vjepa2_tpu_torch.core.optim import split_sharded


def accumulate(loss_and_backward: Callable, microbatches: Sequence, grad_accum: int,
               params: Sequence[torch.Tensor], sync: Callable | None = None) -> torch.Tensor:
    """Run ``loss_and_backward(*microbatch)`` (a forward and a ``backward()``
    that adds into ``.grad``, returning the detached loss) over the
    ``grad_accum`` microbatches, then scale every ``.grad`` of ``params`` by
    ``1 / grad_accum``. ``microbatches``: a sequence of argument tuples.
    ``sync(flag)``: turns a sharded state's gradient reduction off before
    every microbatch but the last and on before the last, so that the
    accumulated gradient is reduced once (`core.sharding`). Returns the
    mean loss."""
    if len(microbatches) != grad_accum:
        raise ValueError(f"{len(microbatches)} microbatches for grad_accum {grad_accum}")
    total = None
    for i, args in enumerate(microbatches):
        if sync is not None:
            sync(i == grad_accum - 1)
        loss = loss_and_backward(*args)
        total = loss if total is None else total + loss
    inv = 1.0 / grad_accum
    with torch.no_grad():
        grads = [p.grad for p in params if p.grad is not None]
        for (part,) in split_sharded(grads):
            torch._foreach_mul_(part, inv)
    return total * inv


def validate_grad_accum(batch_size: int, grad_accum: int, data_parallel: int = 1) -> None:
    """Config-time checks (JAX's messages, `accum.py:43-56`): fail here with a
    readable message instead of a shape error at the first step. The
    batch splits into ``grad_accum`` microbatches, each over the
    ``data_parallel`` ranks of the mesh's data group."""
    if batch_size % grad_accum:
        raise ValueError(f"batch_size {batch_size} not divisible by grad_accum {grad_accum}")
    if (batch_size // grad_accum) % data_parallel:
        raise ValueError(f"microbatch {batch_size // grad_accum} not divisible by the "
                         f"data-parallel mesh ({data_parallel} ways)")
