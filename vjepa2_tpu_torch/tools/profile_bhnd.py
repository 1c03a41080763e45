"""Where a BHND flash call's time goes, on one CUDA card: device time per
kernel launch and host time per wrapper call.

    python -m vjepa2_tpu_torch.tools.profile_bhnd [SHAPE ...] [--calls 10]

Run from the repository root. For each shape of `chip_smoke.py`'s
``BHND_SHAPES`` / ``BHND_BWD_SHAPES`` named on the command line (default:
the ViT-H target and the 176-token context), builds the same inputs as the
smoke's kernel phases and then:

* traces ``--calls`` forward and backward calls with `torch.profiler` and
  prints the device ms of each BHND kernel (the RoPE prologue, the forward,
  the backward's prologue, dK/dV and dQ kernels) per call;
* times 300 wrapper calls of each direction on the host clock, without a
  synchronisation inside the loop: the host's cost of a call, which is what
  a call costs when its device time is smaller.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", default=list(DEFAULT))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_bhnd: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from torch.profiler import ProfilerActivity, profile

    from vjepa2_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    seqs = c._mask_seqs()
    cases = {name: (shape, feats) for name, shape, feats in c.BHND_SHAPES + c.BHND_BWD_SHAPES}
    for name in args.shapes:
        (B, H, N, D), feats = cases[name]
        q, k, v, do, kw, _ = c._bhnd_case(dev, B, H, N, D, feats, seqs)
        with torch.no_grad():
            out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)

            def fwd():
                fa.flash_attention_bhnd(q, k, v, **kw)

            def bwd():
                fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)

            rec = {"shape": name, "bhnd": [B, H, N, D], "host_us_per_call":
                   {"fwd": host_us(fwd), "bwd": host_us(bwd)}}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    fwd()
                    bwd()
                torch.cuda.synchronize()
        rec["device_ms_per_call"] = {
            m.group(): e.device_time_total / 1e3 / args.calls for e in prof.key_averages()
            if e.device_time_total > 0 and (m := re.search(r"\w*bhnd\w*_kernel<\d+>", e.key))}
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
