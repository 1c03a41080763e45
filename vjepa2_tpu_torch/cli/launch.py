"""Requeue launcher (counterpart of `vjepa2_tpu/cli/launch.py`; the role of
the reference's `app/main_distributed.py` under submitit).

A supervisor: it runs ``cli.main`` as a child, and when the child exits with
EX_TEMPFAIL (75, what ``cli.main`` raises after a SIGTERM-driven checkpoint)
or dies to SIGTERM, it runs it again; the restart resumes from the checkpoint
(``meta.load_checkpoint``). Any other exit code propagates. Each rank of a
job runs its own supervisor (torchrun starts one a GPU, SLURM one a task),
and the child inherits the rank's environment.

Usage:
  python -m vjepa2_tpu_torch.cli.launch --fname cfg.yaml [--max-requeues 100] [...]
  torchrun --nproc-per-node 8 -m vjepa2_tpu_torch.cli.launch --fname cfg.yaml

All unknown arguments pass through to ``cli.main``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from vjepa2_tpu_torch.core.logging import get_logger

logger = get_logger(__name__, force=True)

EX_TEMPFAIL = 75
MAIN = "vjepa2_tpu_torch.cli.main"


def main(argv=None, cmd_prefix=None):
    """Run the child until it completes, fails or runs out of requeues;
    returns the exit code. ``cmd_prefix`` replaces ``python -m cli.main``."""
    p = argparse.ArgumentParser()
    p.add_argument("--max-requeues", type=int, default=100)
    p.add_argument("--requeue-delay", type=float, default=5.0)
    args, passthrough = p.parse_known_args(argv)

    cmd = [*(cmd_prefix or [sys.executable, "-m", MAIN]), *passthrough]
    for attempt in range(args.max_requeues + 1):
        logger.info("launch attempt %d: %s", attempt, " ".join(cmd))
        rc = subprocess.run(cmd).returncode
        if rc == 0:
            logger.info("run completed")
            return 0
        if rc == EX_TEMPFAIL or rc == -15:  # preempted / SIGTERM'd
            logger.warning("preempted (rc=%s); requeueing in %.0fs", rc, args.requeue_delay)
            time.sleep(args.requeue_delay)
            continue
        logger.error("run failed with rc=%s (not a preemption); giving up", rc)
        return rc
    logger.error("exceeded max requeues (%d)", args.max_requeues)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
