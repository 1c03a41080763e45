"""Experiment provenance and preemption handling (counterpart of
`vjepa2_tpu/core/provenance.py`).

Reference (`app/main_distributed.py:87-91,144-172`): the SLURM launcher
snapshots params and git info into the run folder, and submitit's
``Trainer.checkpoint()`` requeues preempted jobs with resume_preempt=True.

* ``dump_provenance`` writes ``params-<app>.yaml`` (the resolved config),
  ``git-info.txt`` (commit, branch and dirty state of the running tree) and
  ``env-info.txt`` (python, torch, CUDA, the device's name and count) into
  the run folder.
* ``PreemptionGuard`` installs a SIGTERM handler (what batch schedulers
  deliver before they preempt); training loops poll ``guard.should_stop``
  each iteration, checkpoint, and return with ``preempted=True`` so the
  wrapper can requeue. Resume is the ordinary checkpoint restore (the
  schedules are pure functions of the restored step, so there is no replay).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys

from vjepa2_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


def _git_info(cwd: str) -> str:
    lines = []
    for label, cmd in (
        ("commit", ["git", "rev-parse", "HEAD"]),
        ("branch", ["git", "rev-parse", "--abbrev-ref", "HEAD"]),
        ("status", ["git", "status", "--short"]),
    ):
        try:
            out = subprocess.run(
                cmd, cwd=cwd, capture_output=True, text=True, timeout=10
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out = "<unavailable>"
        lines.append(f"{label}: {out}")
    return "\n".join(lines) + "\n"


def dump_provenance(folder: str, cfg_dict: dict, app: str = "app") -> None:
    """Reference `app/main_distributed.py:161-172` parity: params and git
    info (and an environment snapshot: torch, CUDA and the device where JAX
    records jax and its devices, `provenance.py:54-69`) written into the run
    folder."""
    import torch
    import yaml

    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"params-{app}.yaml"), "w") as f:
        yaml.safe_dump(cfg_dict, f, sort_keys=False)
    code_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(folder, "git-info.txt"), "w") as f:
        f.write(_git_info(code_root))
    device = (f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
              if torch.cuda.is_available() else "cpu x1")
    with open(os.path.join(folder, "env-info.txt"), "w") as f:
        f.write(f"python: {sys.version.split()[0]}\n")
        f.write(f"torch: {torch.__version__}\n")
        f.write(f"cuda: {torch.version.cuda}\n")
        f.write(f"device: {device}\n")
        f.write("processes: 1\n")
    logger.info("provenance written to %s", folder)


class PreemptionGuard:
    """SIGTERM-driven graceful-shutdown flag for training loops."""

    def __init__(self, signals=(signal.SIGTERM,), install: bool = True):
        self._stop = False
        self._prev = {}
        if install:
            for sig in signals:
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except (ValueError, OSError):  # not the main thread
                    logger.warning("PreemptionGuard: cannot install handler for %s", sig)

    def _handler(self, signum=None, frame=None):
        logger.warning("preemption signal received (%s): will checkpoint and stop", signum)
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
