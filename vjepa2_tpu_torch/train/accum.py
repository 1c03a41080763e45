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


def accumulate(loss_and_backward: Callable, microbatches: Sequence, grad_accum: int,
               params: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run ``loss_and_backward(*microbatch)`` (a forward and a ``backward()``
    that adds into ``.grad``, returning the detached loss) over the
    ``grad_accum`` microbatches, then scale every ``.grad`` of ``params`` by
    ``1 / grad_accum``. ``microbatches``: a sequence of argument tuples.
    Returns the mean loss."""
    if len(microbatches) != grad_accum:
        raise ValueError(f"{len(microbatches)} microbatches for grad_accum {grad_accum}")
    total = None
    for args in microbatches:
        loss = loss_and_backward(*args)
        total = loss if total is None else total + loss
    inv = 1.0 / grad_accum
    with torch.no_grad():
        grads = [p.grad for p in params if p.grad is not None]
        if grads:
            torch._foreach_mul_(grads, inv)
    return total * inv


def validate_grad_accum(batch_size: int, grad_accum: int) -> None:
    """Config-time check (JAX's message): fail here with a readable message
    instead of a shape error at the first step. One card means a
    data-parallel width of 1, so JAX's microbatch-by-mesh check always
    passes."""
    if batch_size % grad_accum:
        raise ValueError(f"batch_size {batch_size} not divisible by grad_accum {grad_accum}")
