"""AdamW with scheduled LR and weight decay, and the EMA target update
(counterpart of `vjepa2_tpu/core/optim.py`).

The JAX chain is ``scale_by_adam -> + wd * p (ndim >= 2 only) -> * -lr``
(`make_adamw:58`, `_scheduled_wd:27`): p <- p - lr * (m_hat / (sqrt(v_hat) +
eps) + wd * p), with the schedules read at the optimizer's 0-based count.
`torch.optim.AdamW` computes the same update (it decays p by lr * wd first,
then takes the Adam step, which does not read p), so `ScheduledAdamW` is
torch's AdamW with two parameter groups (decayed where ``ndim >= 2``, the
reference's "bias or 1-D" exclusion) whose lr and weight decay are set from
the schedules before every step (the counterpart of `make_adamw`).
`tests/test_torch_optim.py` holds it to optax on identical gradients.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.distributed as dist


def wd_mask(params: Iterable[torch.Tensor]) -> list[bool]:
    """True where weight decay applies (ndim >= 2)."""
    return [p.ndim >= 2 for p in params]


class ScheduledAdamW:
    """AdamW whose lr and weight decay follow ``lr_fn(step)`` and
    ``wd_fn(step)``, ``step`` being the 0-based count of updates made before
    this one (the train state's step)."""

    def __init__(self, params: Iterable[torch.Tensor], lr_fn: Callable, wd_fn: Callable,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        params = [p for p in params if p.requires_grad]
        mask = wd_mask(params)
        decay = [p for p, m in zip(params, mask) if m]
        no_decay = [p for p, m in zip(params, mask) if not m]
        self.lr_fn, self.wd_fn = lr_fn, wd_fn
        self.params = params
        groups = [{"params": decay, "decay": True}, {"params": no_decay, "decay": False}]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=0.0, betas=betas,
                                     eps=eps, weight_decay=0.0)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """AdamW's state: each parameter's ``exp_avg``, ``exp_avg_sq`` and
        ``step``. The lr and weight decay need no saving: every step sets
        them from ``lr_fn`` and ``wd_fn`` of the train state's step."""
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)

    @torch.no_grad()
    def step(self, step: int) -> None:
        lr, wd = self.lr_fn(step), self.wd_fn(step)
        for group in self.opt.param_groups:
            group["lr"] = lr
            group["weight_decay"] = wd if group["decay"] else 0.0
        self.opt.step()


@torch.no_grad()
def ema_update(target_params, online_params, momentum: float) -> None:
    """target <- m * target + (1 - m) * online, in place
    (reference `train.py:456-465`). Sharded (DTensor) and whole parameters
    update as two lists."""
    for tgt, onl in split_sharded(list(target_params), list(online_params)):
        torch._foreach_mul_(tgt, momentum)
        torch._foreach_add_(tgt, onl, alpha=1.0 - momentum)


def split_sharded(first: list, *rest: list) -> list[tuple[list, ...]]:
    """Parallel lists split in two by whether ``first``'s tensor is a
    DTensor (a sharded parameter or its gradient): a foreach op takes one
    kind at a time. One part when there is one kind."""
    from torch.distributed.tensor import DTensor

    kinds = [isinstance(t, DTensor) for t in first]
    return [tuple([x for x, k in zip(lst, kinds) if k is kind] for lst in (first, *rest))
            for kind in dict.fromkeys(kinds)]


@torch.no_grad()
def global_norm(tensors, group=None, replicas=None) -> torch.Tensor:
    """L2 norm over every entry of every tensor, in fp32. With ``group``
    the tensors are this rank's shares of tensors spread over the group:
    the squares summed over it, tensor i counted once although
    ``replicas[i]`` ranks of the group hold it whole."""
    if group is None:
        norms = torch._foreach_norm([t.float() for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for t, r in zip(tensors, replicas):
        sq = sq + t.float().square().sum() / r
    dist.all_reduce(sq, group=group)
    return sq.sqrt()
