"""Host resource monitoring (counterpart of `vjepa2_tpu/core/monitoring.py`;
reference `src/utils/monitoring.py:44-160`, `src/datasets/utils/dataloader.py:68-141`).

A daemon thread samples a process's counters (cpu %, resident memory, bytes
read and written, context switches) every ``interval`` seconds into a CSV,
to watch the data loader's workers feeding the card. The counters are read
from the process's own ``/proc/<pid>/{stat,status,io}``, where JAX's module
uses psutil (the card's host has none). The card's side is traced with
`torch.profiler` (`start_trace`, `stop_trace`).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


@dataclass
class ResourceSnapshot:
    ts: float
    cpu_percent: float
    rss_mb: float
    read_mb: float
    write_mb: float
    ctx_switches: int


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of ``pid`` (``/proc/<pid>/stat`` fields 14
    and 15, counted after the parenthesised command name)."""
    stat = _read(f"/proc/{pid}/stat")
    fields = stat[stat.rindex(")") + 2:].split()
    return (int(fields[11]) + int(fields[12])) / _CLK_TCK


def _status(pid: int) -> dict:
    out = {}
    for line in _read(f"/proc/{pid}/status").splitlines():
        key, _, value = line.partition(":")
        out[key] = value.strip()
    return out


class ResourceMonitoringThread(threading.Thread):
    """Appends one row a sample to ``out_csv`` (its header written first),
    until `stop`. ``cpu_percent`` is the CPU time over the wall time since
    the previous sample (0 at the first, as psutil's first call)."""

    def __init__(self, out_csv: str, interval: float = 5.0, pid: Optional[int] = None):
        super().__init__(daemon=True)
        self.pid = pid or os.getpid()
        if not os.path.exists(f"/proc/{self.pid}/stat"):
            raise OSError(f"no /proc/{self.pid}/stat to sample (resource monitoring reads "
                          "the process's /proc entries)")
        self.out_csv = out_csv
        self.interval = interval
        self._stop_event = threading.Event()
        self._last = None  # (wall, cpu seconds)
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
        with open(out_csv, "a") as f:
            f.write("ts,cpu_percent,rss_mb,read_mb,write_mb,ctx_switches\n")

    def snapshot(self) -> ResourceSnapshot:
        now, cpu = time.time(), _cpu_seconds(self.pid)
        pct = 0.0
        if self._last is not None and now > self._last[0]:
            pct = 100.0 * (cpu - self._last[1]) / (now - self._last[0])
        self._last = (now, cpu)
        status = _status(self.pid)
        rss = int(status.get("VmRSS", "0 kB").split()[0]) * 1024 / 1e6
        ctx = int(status.get("voluntary_ctxt_switches", 0)) + \
            int(status.get("nonvoluntary_ctxt_switches", 0))
        try:  # /proc/<pid>/io may be unreadable (a hardened kernel)
            io = dict(line.split(": ") for line in _read(f"/proc/{self.pid}/io").splitlines())
            rd, wr = int(io["read_bytes"]) / 1e6, int(io["write_bytes"]) / 1e6
        except (OSError, KeyError, ValueError):
            rd = wr = 0.0
        return ResourceSnapshot(now, pct, rss, rd, wr, ctx)

    def run(self):
        while not self._stop_event.wait(self.interval):
            s = self.snapshot()
            with open(self.out_csv, "a") as f:
                f.write(f"{s.ts:.1f},{s.cpu_percent:.1f},{s.rss_mb:.1f},"
                        f"{s.read_mb:.1f},{s.write_mb:.1f},{s.ctx_switches}\n")

    def stop(self):
        self._stop_event.set()


_TRACE = {}


def start_trace(log_dir: str):
    """Start a `torch.profiler` trace of the host and the card; `stop_trace`
    writes it to ``log_dir`` as a Chrome trace (view in Perfetto or
    TensorBoard)."""
    import torch

    if _TRACE:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _TRACE.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop `start_trace`'s trace; returns the file written."""
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("log_dir")
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    return path
