"""Time the kernels of two checkouts on one CUDA card, in turns.

    python -m vjepa2_tpu_torch.tools.ab_kernels OTHER_CHECKOUT [--rounds 1]
        [--phases b1,b2,b3,bhnd_bwd,ln_qkv,ln_mlp,ln,fp32,ln_qkv_fp32,ln_mlp_fp32,ln_fp32]
        [--out FILE]

Runs `chip_smoke.py`'s kernel phases (B1, B2, B3, the BHND backward, the
fused LayerNorm prologues B7 and B8, the LayerNorm B6, the fp32 BHND
forward and backward, and B7, B8 and B6 on fp32 operands, against their
plain versions at the main-path shapes, each timed with CUDA events;
``--phases`` picks some of them) in a fresh process from the root of OTHER_CHECKOUT and of this
checkout, in the order other, this, this, other for each round, so that
both see the same card and the same drift. Each process builds its own
checkout's kernels. Prints a table of each shape's kernel ms per run (and
the profiler's cold device ms after a slash where the phase gives it, as
B6's does), then
the card's name and power limit; with ``--out`` it also writes every run's
records as JSON. A phase that fails (a kernel off its plain version) fails
the run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the kernel phases by name, as `chip_smoke.py` calls them
PHASES = {
    "b1": "c.phase_kernels(d, s)",
    "b2": "c.phase_kernels_bwd(d, s)",
    "b3": "c.phase_kernels_bhnd(d, s)",
    "bhnd_bwd": "c.phase_kernels_bhnd_bwd(d, s)",
    "ln_qkv": "c.phase_kernels_prologue(d, s, 'ln_qkv')",
    "ln_mlp": "c.phase_kernels_prologue(d, s, 'ln_mlp')",
    "ln": "c.phase_kernels_ln(d, s)",
    "fp32": "c.phase_kernels_fp32(d, s)",
    "ln_qkv_fp32": "c.phase_kernels_prologue(d, s, 'ln_qkv', torch.float32)",
    "ln_mlp_fp32": "c.phase_kernels_prologue(d, s, 'ln_mlp', torch.float32)",
    "ln_fp32": "c.phase_kernels_ln(d, s, torch.float32)",
}
PRELUDE = """
import torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
d = torch.device("cuda", 0)
s = c.phase_device()
c.phase_build()
"""


def run(checkout: Path, phases: list[str]) -> tuple[str, dict]:
    """(the card's nvidia-smi line, {(kernel, shape): record}) of one process."""
    code = PRELUDE + "".join(PHASES[name] + "\n" for name in phases)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True,
                         text=True, timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"kernel phases failed in {checkout}:\n{out.stderr[-4000:]}")
    lines = out.stdout.splitlines()
    recs = [json.loads(ln) for ln in lines if ln.startswith('{"phase": "kernel')]
    return lines[0], {(r["kernel"], r["shape"]): r for r in recs}


def _cell(rec: dict | None) -> str:
    if rec is None:
        return "-"
    dev = rec.get("device_ms")
    return f"{rec['ms']:.4f}" + ("" if dev is None else f"/{dev:.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated, of {', '.join(PHASES)}")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    order = [("other", args.other.resolve()), ("this", ROOT), ("this", ROOT),
             ("other", args.other.resolve())] * args.rounds
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases: {', '.join(unknown)}")
    runs = []
    for name, checkout in order:
        smi, recs = run(checkout, phases)
        runs.append((name, recs))
    print("kernel | shape | " + " ".join(name for name, _ in runs))
    for key in dict.fromkeys(k for _, recs in runs for k in recs):
        print(f"{key[0]} | {key[1]} | " + " ".join(_cell(recs.get(key)) for _, recs in runs))
    if args.out:
        args.out.write_text(json.dumps([{"run": name, "gpu": smi, "records": list(recs.values())}
                                        for name, recs in runs]))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
