"""Where a kernel call's time goes, on one CUDA card: device time per kernel
launch and host time per wrapper call.

    python -m vjepa2_tpu_torch.tools.profile_kernels [[FAMILY:]SHAPE ...] [--calls 10]
        [--no-rope]
    python vjepa2_tpu_torch/tools/profile_kernels.py --checkout OTHER [SHAPE ...]

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
of ``SHAPES`` (B1: its prologue and main kernel), ``dn_bwd:`` and a name of
``BWD_SHAPES`` (B2: its prologue, dK/dV and dQ kernels), ``ln_qkv:`` or
``ln_mlp:`` and a name of ``PROLOGUE_SHAPES`` (B7 or B8: the statistics
launch and the GEMM), ``ln:`` and a name of ``LN_SHAPES`` (B6: the forward,
the statistics-only forward that B7 and B8 launch first, the backward, the
yardsticks `F.layer_norm` and its autograd backward, and `x.clone` and
`x.sum`, which move the forward's and the statistics launch's bytes).

The ``ln`` family times each call on its own and twice: cold, with a 64 MiB
write before each call so that the call reads its rows from device memory
(B6's rows are 8-100 MB, the card's L2 50 MB), and warm, back to back; the
write's kernels are left out (`chip_smoke.device_times`). It prints the
device ms of each call (the time some kernel of it runs) and of each kernel,
the bound (bytes over 3.35 TB/s) and the share of it taken cold.

``--no-rope`` drops the RoPE tables from every call (the ``bhnd``, ``dn``,
``dn_bwd`` and ``ln_qkv`` families): what the rotation costs a kernel.
``--checkout OTHER`` times the kernels of another checkout (its package and
its build) on this checkout's shapes, e.g. a parent commit unpacked into an
ignored directory, where that checkout's own tool lacks a family; run this
file by its path then, so that the package is imported from OTHER.

Prints one JSON object per shape and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
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


def _bhnd_calls(c, dev, name, seqs, rope):
    """B3 and the BHND backward at `chip_smoke.BHND_SHAPES`' (or
    ``BHND_BWD_SHAPES``') ``name``, as the smoke's kernel phases call them."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    cases = {n: (shape, f) for n, shape, f in c.BHND_SHAPES + c.BHND_BWD_SHAPES}
    (B, H, N, D), feats = cases[name]
    q, k, v, do, kw, _ = c._bhnd_case(dev, B, H, N, D, feats, seqs)
    if not rope:
        kw.pop("rope_expanded", None)
    out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    return ({"fwd": lambda: fa.flash_attention_bhnd(q, k, v, **kw),
             "bwd": lambda: fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)},
            {"bhnd": [B, H, N, D]})


def _dn_calls(c, dev, name, seqs, rope):
    """B1 at `chip_smoke.SHAPES`' ``name``, as the smoke's kernel phase calls it."""
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

    (B, H, D, N), feats = {n: (shape, f) for n, shape, f in c.SHAPES}[name]
    q, k, v, kw = c._dn_case(dev, B, H, D, N, feats)
    if not rope:
        kw.pop("rope_expanded", None)
    return {"fwd": lambda: fdn.flash_attention_bhdn(q, k, v, **kw)}, {"bhdn": [B, H, D, N]}


def _dn_bwd_calls(c, dev, name, seqs, rope):
    """B2 at `chip_smoke.BWD_SHAPES`' ``name``, as the smoke's kernel phase calls it."""
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

    H, D, seq = {n: (h, d, sq) for n, h, d, sq in c.BWD_SHAPES}[name]
    q, k, v, do, kw = c._dn_bwd_case(dev, H, D, seq, seqs)
    if not rope:
        kw.pop("rope_expanded", None)
    out, lse = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
    return ({"bwd": lambda: fdn.flash_attention_bhdn_bwd(q, k, v, out, lse, do, **kw)},
            {"bhdn": list(q.shape)})


def _prologue_calls(kernel):
    """B7 (``kernel="ln_qkv"``) or B8 (``"ln_mlp"``) at
    `chip_smoke.PROLOGUE_SHAPES`' ``name``, as the smoke's phase calls it."""

    def calls(c, dev, name, seqs, with_rope):
        from vjepa2_tpu_torch.ops import ln_mlp, ln_qkv

        row = {r[0]: r for r in c.PROLOGUE_SHAPES}[name]
        _, B, N, C, H, D, hidden, tables, real = row
        x, gamma, beta, w, bias, rope = c._prologue_case(dev, B, N, C, H, D, hidden, tables,
                                                         real, seqs, kernel)
        rope = rope if with_rope else None
        if kernel == "ln_qkv":
            return ({"fwd": lambda: ln_qkv.ln_qkv(x, gamma, beta, w, bias, rope, num_heads=H,
                                                  head_dim=D)},
                    {"bnc": [B, N, C], "heads": H, "head_dim": D})
        return ({"fwd": lambda: ln_mlp.ln_mlp(x, gamma, beta, w, bias)},
                {"bnc": [B, N, C], "hidden": hidden})

    return calls


def _ln_calls(c, dev, name, seqs, rope):
    """B6 at `chip_smoke.LN_SHAPES`' ``name``: the forward, the statistics-only
    forward (the first launch of B7 and B8), the backward, and the yardsticks
    `F.layer_norm` and its autograd backward, `x.clone` (the forward's bytes)
    and `x.sum` (the statistics launch's); with each kernel call's bound
    (bytes: each input read once, each output written once)."""
    from vjepa2_tpu_torch.ops import layernorm as ln

    R, C = dict(c.LN_SHAPES)[name]
    x, dy, gamma, beta = c._ln_case(dev, R, C)
    _, mean, rstd = ln.ln_forward(x, gamma, beta)
    lib_fwd, lib_bwd = c.ln_yardsticks(x, dy, gamma, beta)
    rows, params, stats = R * C * 2, C * 4, R * 4
    bounds = {"fwd": 2 * rows + 2 * params + 2 * stats, "stats": rows + 2 * stats,
              "bwd": 3 * rows + 3 * params + 2 * stats}
    return ({"fwd": lambda: ln.ln_forward(x, gamma, beta),
             "stats": _ln_stats_call(ln, x, gamma, beta),
             "bwd": lambda: ln.ln_backward(x, dy, gamma, mean, rstd),
             "F.layer_norm": lib_fwd, "F.layer_norm backward": lib_bwd,
             "x.clone": x.clone, "x.sum": x.sum},
            {"rows": [R, C],
             "bound_ms": {k: b / c.PEAK_BYTES * 1e3 for k, b in bounds.items()}})


def _ln_stats_call(ln, x, gamma, beta):
    """The statistics-only B6 forward, as B7 and B8 launch it first: through
    `ln_stats`, or, in a checkout from before it, through the C entry point
    with a null output (the PR 4-7 signature)."""
    if hasattr(ln, "ln_stats"):
        return lambda: ln.ln_stats(x, gamma, beta)
    import ctypes

    from vjepa2_tpu_torch import _build

    R, C = x.shape
    mean, rstd = (torch.empty(R, dtype=torch.float32, device=x.device) for _ in range(2))
    _, fn = _build.function("vjepa2_layernorm_fwd_bf16", [ctypes.c_void_p] * 6
                            + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    args = (*map(_build.ptr, (x, gamma, beta, None, mean, rstd)), R, C, 1e-6)
    return lambda: fn(*args, torch.cuda.current_stream().cuda_stream)


def _ln_device(c, calls, bound_ms, n):
    """Device ms per call, cold (the L2 evicted before each call) and warm,
    in all and by kernel, and the port's share of the bound (cold)."""
    cold = {key: c.device_times(fn, n) for key, fn in calls.items()}
    warm = {key: c.device_times(fn, n, cold=False) for key, fn in calls.items()}
    return {"device_ms_cold": {key: t[0] for key, t in cold.items()},
            "device_ms_warm": {key: t[0] for key, t in warm.items()},
            "device_ms_cold_by_kernel": {key: t[1] for key, t in cold.items()},
            "device_ms_warm_by_kernel": {key: t[1] for key, t in warm.items()},
            "bound_ms": bound_ms,
            "bound_share_cold": {key: b / cold[key][0] for key, b in bound_ms.items()}}


# family -> (chip_smoke module, device, shape name, mask sequences, with
# RoPE tables) -> ({call name: call}, the shape's fields)
FAMILIES = {"bhnd": _bhnd_calls, "dn": _dn_calls, "dn_bwd": _dn_bwd_calls,
            "ln_qkv": _prologue_calls("ln_qkv"), "ln_mlp": _prologue_calls("ln_mlp"),
            "ln": _ln_calls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", default=list(DEFAULT))
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--no-rope", action="store_true", help="drop the RoPE tables from each call")
    ap.add_argument("--checkout", type=Path,
                    help="time this checkout's kernels on this file's shapes (run by path)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    if args.checkout is not None and "vjepa2_tpu_torch" in sys.modules:
        ap.error("--checkout: run this file by its path, so that the package comes from there")
    sys.path.insert(0, str((args.checkout or ROOT).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)  # this checkout's shape tables
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    seqs = c._mask_seqs()
    for name in args.shapes:
        family, _, sub = name.rpartition(":")
        with torch.no_grad():
            calls, rec = FAMILIES[family or "bhnd"](c, dev, sub, seqs, not args.no_rope)
            rec = {"shape": name, **rec, "rope": not args.no_rope,
                   "checkout": str(args.checkout or "."),
                   "host_us_per_call": {key: host_us(fn) for key, fn in calls.items()}}
            if family == "ln":
                rec.update(_ln_device(c, calls, rec.pop("bound_ms"), args.calls))
                print(json.dumps(rec), flush=True)
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    for fn in calls.values():
                        fn()
                torch.cuda.synchronize()
        rec["device_ms_per_call"] = {
            m.group(): e.device_time_total / 1e3 / args.calls for e in prof.key_averages()
            if e.device_time_total > 0 and "at::" not in e.key
            and (m := re.search(r"\w+_kernel(<[\w, <>]*>)?",
                                e.key.replace("(anonymous namespace)::", "")))}
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
