"""LR / WD / EMA-momentum schedules as plain functions of the step
(counterpart of `vjepa2_tpu/core/schedulers.py`).

Semantics match the reference's `src/utils/schedulers.py`, including its
1-based ``_step`` (the first ``step()`` returns the value for step 1): each
function adds 1 to the 0-based step it is given, as the JAX functions do.
"""

from __future__ import annotations

import math


def warmup_cosine_lr(step, *, warmup_steps, start_lr, ref_lr, t_max, final_lr=0.0) -> float:
    """Reference `WarmupCosineSchedule`; ``t_max`` is the total length."""
    step = float(step) + 1.0
    if step < warmup_steps:
        return start_lr + (step / max(1.0, float(warmup_steps))) * (ref_lr - start_lr)
    progress = (step - warmup_steps) / max(1.0, float(t_max) - warmup_steps)
    cos = final_lr + (ref_lr - final_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))
    return max(final_lr, cos)


def cosine_wd(step, *, ref_wd, t_max, final_wd=0.0) -> float:
    """Reference `CosineWDSchedule`, clamped toward ``final_wd``."""
    progress = (float(step) + 1.0) / t_max
    wd = final_wd + (ref_wd - final_wd) * 0.5 * (1.0 + math.cos(math.pi * progress))
    return max(final_wd, wd) if final_wd <= ref_wd else min(final_wd, wd)


def wsd_lr(step, *, warmup_steps, anneal_steps, t_max, start_lr, ref_lr, final_lr=0.0) -> float:
    """Warmup-stable-decay, reference `WSDSchedule`; ``t_max`` is the total
    length, the stable phase ``t_max - warmup_steps - anneal_steps``."""
    step = float(step) + 1.0
    stable_end = t_max - anneal_steps
    if step < warmup_steps:
        return start_lr + (step / max(1, warmup_steps)) * (ref_lr - start_lr)
    if step < stable_end:
        return ref_lr
    return ref_lr + (step - stable_end) / max(1, anneal_steps) * (final_lr - ref_lr)


def ema_momentum(step, *, ema_start, ema_end, t_max) -> float:
    """Linear EMA momentum ramp (reference `app/vjepa/train.py:286-289`);
    0-based, no increment."""
    return ema_start + float(step) * (ema_end - ema_start) / t_max
