"""Logging utilities (reference `src/utils/logging.py`; a copy of
`vjepa2_tpu/core/logging.py`)."""

from __future__ import annotations

import logging
import sys


def get_logger(name=None, force=False):
    if force:
        logging.basicConfig(
            stream=sys.stdout,
            level=logging.INFO,
            format="[%(asctime)s][%(levelname)-8s][%(name)s] %(message)s",
            force=True,
        )
    return logging.getLogger(name=name)


class CSVLogger:
    """Append-mode CSV with printf formats (reference `logging.py:43-63`)."""

    def __init__(self, fname: str, *argv, mode: str = "+a"):
        self.fname = fname
        self.types = []
        with open(self.fname, mode) as f:
            for i, v in enumerate(argv, 1):
                self.types.append(v[0])
                end = "," if i < len(argv) else "\n"
                print(v[1], end=end, file=f)

    def log(self, *argv):
        with open(self.fname, "+a") as f:
            for i, tv in enumerate(zip(self.types, argv), 1):
                end = "," if i < len(argv) else "\n"
                print(tv[0] % tv[1], end=end, file=f)


class AverageMeter:
    """Running average (reference `logging.py:66-89`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.max = float("-inf")
        self.min = float("inf")
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        try:
            self.max = max(val, self.max)
            self.min = min(val, self.min)
        except Exception:
            pass
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

