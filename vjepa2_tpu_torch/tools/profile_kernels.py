"""Where a kernel call's time goes, on one CUDA card: device time per kernel
launch and host time per wrapper call.

    python -m vjepa2_tpu_torch.tools.profile_kernels [[FAMILY:]SHAPE ...] [--calls 10]

Run from the repository root. For each shape named on the command line
(default: the ViT-H target and the 176-token context of the BHND kernels),
builds the same inputs as `chip_smoke.py`'s kernel phases and then:

* traces ``--calls`` calls with `torch.profiler` and prints the device ms
  of each of the port's kernels per call;
* times 300 wrapper calls on the host clock, without a synchronisation
  inside the loop: the host's cost of a call, which is what a call costs
  when its device time is smaller.

A shape is a family and a name of the smoke's shape table for it
(`FAMILIES`): ``bhnd:`` (the default family) and a name of ``BHND_SHAPES``
/ ``BHND_BWD_SHAPES`` (B3 forward and the BHND backward), ``dn:`` and a name
of ``SHAPES`` (B1: its prologue and main kernel), ``ln_mlp:`` and a name of
``PROLOGUE_SHAPES`` (B8: its statistics launch and GEMM).

Prints one JSON object per shape and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
DEFAULT = ("vit_huge target", "vit_huge context, mask 1")


def host_us(fn, calls: int = 300) -> float:
    """Host microseconds per call of ``fn``, after a warm-up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _bhnd_calls(c, dev, name, seqs):
    """B3 and the BHND backward at `chip_smoke.BHND_SHAPES`' (or
    ``BHND_BWD_SHAPES``') ``name``, as the smoke's kernel phases call them."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    cases = {n: (shape, f) for n, shape, f in c.BHND_SHAPES + c.BHND_BWD_SHAPES}
    (B, H, N, D), feats = cases[name]
    q, k, v, do, kw, _ = c._bhnd_case(dev, B, H, N, D, feats, seqs)
    out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    return ({"fwd": lambda: fa.flash_attention_bhnd(q, k, v, **kw),
             "bwd": lambda: fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)},
            {"bhnd": [B, H, N, D]})


def _dn_calls(c, dev, name, seqs):
    """B1 at `chip_smoke.SHAPES`' ``name``, as the smoke's kernel phase calls it."""
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

    (B, H, D, N), feats = {n: (shape, f) for n, shape, f in c.SHAPES}[name]
    q, k, v, kw = c._dn_case(dev, B, H, D, N, feats)
    return {"fwd": lambda: fdn.flash_attention_bhdn(q, k, v, **kw)}, {"bhdn": [B, H, D, N]}


def _ln_mlp_calls(c, dev, name, seqs):
    """B8 at `chip_smoke.PROLOGUE_SHAPES`' ``name``, as the smoke's phase calls it."""
    from vjepa2_tpu_torch.ops import ln_mlp

    row = {r[0]: r for r in c.PROLOGUE_SHAPES}[name]
    _, B, N, C, H, D, hidden, tables, real = row
    x, gamma, beta, w, bias, _ = c._prologue_case(dev, B, N, C, H, D, hidden, tables, real, seqs,
                                                  "ln_mlp")
    return ({"fwd": lambda: ln_mlp.ln_mlp(x, gamma, beta, w, bias)},
            {"bnc": [B, N, C], "hidden": hidden})


# family -> (chip_smoke module, device, shape name, mask sequences) ->
# ({call name: call}, the shape's fields)
FAMILIES = {"bhnd": _bhnd_calls, "dn": _dn_calls, "ln_mlp": _ln_mlp_calls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", default=list(DEFAULT))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    seqs = c._mask_seqs()
    for name in args.shapes:
        family, _, sub = name.rpartition(":")
        with torch.no_grad():
            calls, rec = FAMILIES[family or "bhnd"](c, dev, sub, seqs)
            rec = {"shape": name, **rec,
                   "host_us_per_call": {key: host_us(fn) for key, fn in calls.items()}}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    for fn in calls.values():
                        fn()
                torch.cuda.synchronize()
        rec["device_ms_per_call"] = {
            m.group(): e.device_time_total / 1e3 / args.calls for e in prof.key_averages()
            if e.device_time_total > 0 and "at::" not in e.key
            and (m := re.search(r"\w+_kernel(<[\w, ]*>)?", e.key))}
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
