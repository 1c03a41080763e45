"""Checkpoint save and restore over `torch.save` (counterpart of
`vjepa2_tpu/core/checkpoint.py`, which sits on Orbax).

The reference saves `latest.pt` each epoch plus a periodic `e{N}.pt`
(`app/vjepa/train.py:315-333`) and replays its schedulers on resume. Here the
whole train state (step, encoder, predictor, EMA target, AdamW moments and
counts) is one `state_dict`, and the schedules are pure functions of the
restored step. The manager keeps JAX's semantics (`checkpoint.py:18-50`):

* one file a step, ``<directory>/<step>.pt``, and a rolling window of the
  latest ``max_to_keep``; steps divisible by ``keep_period`` are kept outside
  the window (the reference's permanent ``e{N}.pt``);
* a save is atomic: it writes a temporary file in the same directory, syncs
  it and renames it into place (`os.replace`), so a step is visible only once
  it is whole and a save cut short leaves the previous latest step;
* a restore is exact: every tensor comes back bit-equal, onto the devices of
  the state it is restored into.

Saves are synchronous, and every step handed to ``save`` is written.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _atomic_save(obj: Any, path: str) -> None:
    """`torch.save` to a temporary name beside ``path``, fsync, then rename."""
    directory = os.path.dirname(path) or "."
    tmp = os.path.join(directory, f".{os.path.basename(path)}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _state_of(state: Any) -> Any:
    return state.state_dict() if hasattr(state, "state_dict") else state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, keep_period: Optional[int] = None):
        """keep_period: steps divisible by it are kept FOREVER, outside the
        rolling max_to_keep window — the reference's permanent ``e{N}.pt``
        every ``save_every_freq`` epochs (`app/vjepa/train.py:516-521`)."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> list[int]:
        steps = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` (a `state_dict()` holder, or tensors in dicts and
        lists) as ``step``, then drop the steps outside the window."""
        _atomic_save(_state_of(state), self.path(step))
        self._collect(step)

    def _collect(self, newest: int) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:]) | {newest}
        if self.keep_period:
            keep |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in keep:
                os.remove(self.path(s))

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (the latest by default). A template with
        `load_state_dict` is loaded in place and returned (its tensors keep
        their devices); otherwise the saved object comes back, on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(self.path(step), map_location="cpu", weights_only=True)
        if hasattr(state_template, "load_state_dict"):
            state_template.load_state_dict(saved)
            return state_template
        return saved


def save_params(path: str, params: Any) -> None:
    """One-shot parameter save (hub-style release artifacts), atomic."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_save(_state_of(params), os.path.abspath(path))


def load_params(path: str, template: Optional[Any] = None, retries: int = 3,
                backoff: float = 2.0) -> Any:
    """Parameter restore with exponential-backoff retry (reference
    `src/utils/checkpoint_loader.py:19-37` wraps flaky storage the same way).
    A ``template`` with `load_state_dict` is loaded in place and returned."""
    last = None
    for attempt in range(retries):
        try:
            saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
            break
        except (OSError, RuntimeError) as e:
            last = e
            time.sleep(backoff**attempt)
    else:
        raise last
    if template is not None and hasattr(template, "load_state_dict"):
        template.load_state_dict(saved)
        return template
    return saved
