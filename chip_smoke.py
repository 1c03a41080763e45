#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vjepa2_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON object on a line of its own:

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build   — builds the port's CUDA kernels from ``vjepa2_tpu_torch/csrc``;
3. kernel  — the DN flash-attention kernel (B1) against its plain PyTorch
   version at the production shapes, bf16, out and lse, each with its
   tolerance, and both timed with CUDA events;
4. slice   — the serving path: the ViT-L/16 encoder from the port's hub
   factory (RoPE, bf16, 16 frames at 256 px) and the SSv2 attentive probe
   (depth 4, 16 heads, 174 classes), random weights from a seeded generator,
   answering 3 requests of 8 clips; every request must launch B1 once per
   encoder layer, and the logits of one clip must match the port's fp32
   plain path on the CPU.

Then the kernels' summary line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero without that line;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "vjepa2_tpu_torch/csrc/flash_fwd_dn.cu"
KERNEL_REPLACES = "vjepa2_tpu/ops/flash_attention_dn.py:129"

# (name, [B, H, D, N], features) — the shapes B1 takes on the main paths
SHAPES = [
    ("vit_large encoder", (8, 16, 64, 2048), {}),
    ("pretrain predictor", (8, 12, 32, 1664), {"kv_valid_len": 1623}),
    ("ac predictor", (8, 16, 64, 1806), {"segments": 7}),
    ("vit_giant_xformers encoder", (2, 22, 64, 2048), {}),
]
# Kernel against plain, both from the same bf16 inputs: they round q at
# different points (after vs before the scale) and p at different points
# (unnormalised vs normalised), each 2**-9 relative. A score then differs by
# up to 2**-8*|s|; lse follows the largest scores of its row, and |s| stays
# below ~7 for unit-variance inputs at these lengths, hence 3e-2.
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 3e-2
# Slice logits, bf16 on the card against fp32 on the CPU: relative L2 error.
# bf16 keeps 8 bits (2**-9 relative per rounding); over 24 encoder layers and
# 4 probe blocks the measured error is expected near 1e-2.
LOGITS_REL_L2 = 5e-2
REQUESTS, CLIPS, FRAMES, SIZE = 3, 8, 16, 256


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    from vjepa2_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.library_path().relative_to(_build.BUILD_DIR.parent.parent)),
          "ptxas": ptxas})


def phase_kernels(dev, smi: str) -> dict:
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    first = None
    for name, (B, H, D, N), feats in SHAPES:
        rng = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rng.randn(B, H, D, N).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        (cos, sin), _ = expand_rope_cache(build_rope_cache(torch.arange(N, device=dev), D, 16, 16), D)
        kw = {"rope_expanded": (cos, sin)}
        if "kv_valid_len" in feats:
            kw["kv_valid_len"] = feats["kv_valid_len"]
        if "segments" in feats:  # frame-causal: equal frames of tokens
            frames = feats["segments"]
            kw["segment_ids"] = torch.arange(frames, device=dev, dtype=torch.int32) \
                .repeat_interleave(N // frames)
        with torch.inference_mode():
            out_k, lse_k = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
            out_p, lse_p = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            d_out = (out_k.float() - out_p.float()).abs()
            d_lse = (lse_k - lse_p).abs()
            ok = bool(torch.isfinite(out_k.float()).all() and torch.isfinite(lse_k).all()
                      and (d_out <= OUT_ATOL + OUT_RTOL * out_p.float().abs()).all()
                      and d_lse.max() <= LSE_ATOL)
            ms = cuda_ms(lambda: fdn.flash_attention_bhdn(q, k, v, **kw), iters=20)
            plain_ms = cuda_ms(lambda: fdn.flash_attention_bhdn_plain(q, k, v, **kw), iters=5)
        rec = {"phase": "kernel", "kernel": "flash_fwd_dn", "shape": name, "bhdn": [B, H, D, N],
               "features": sorted(kw), "ms": ms, "plain_ms": plain_ms,
               "max_abs_err_out": d_out.max().item(), "max_abs_err_lse": d_lse.max().item(),
               "tol": {"out": f"{OUT_ATOL} + {OUT_RTOL}*|plain|", "lse": LSE_ATOL},
               "ok": ok, "gpu": smi}
        emit(rec)
        if not ok:
            raise AssertionError(f"flash_fwd_dn disagrees with its plain version at {name}")
        first = first or rec
    return first


def phase_slice(dev, smi: str) -> int:
    from vjepa2_tpu_torch.evals.wrappers import encode_clips
    from vjepa2_tpu_torch.hub.backbones import vjepa2_vit_large
    from vjepa2_tpu_torch.models.attentive_pooler import AttentiveClassifier
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

    def build(device, dtype, generator=None):
        enc = vjepa2_vit_large(num_frames=FRAMES, uniform_power=True, use_flash=True,
                               dtype=dtype, device=device, generator=generator)
        clf = AttentiveClassifier(embed_dim=1024, num_heads=16, depth=4, num_classes=174,
                                  dtype=dtype, device=device)
        clf.reset_parameters(generator)
        return enc.eval(), clf.eval()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    enc, clf = build(dev, torch.bfloat16, gen)
    rs = np.random.RandomState(0)
    requests = [torch.from_numpy(rs.rand(CLIPS, 1, FRAMES, SIZE, SIZE, 3).astype(np.float32))
                for _ in range(REQUESTS)]
    setup_s = time.perf_counter() - t0

    def answer(clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return clf(encode_clips(enc, clips.to(dev))).cpu()

    answer(requests[0])  # warm-up, outside the counted run
    fdn.LAUNCHES = 0
    times, answers = [], []
    for clips in requests:
        before = fdn.LAUNCHES
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = answer(clips)
        times.append((time.perf_counter() - t1) * 1e3)
        launched = fdn.LAUNCHES - before
        if launched != len(enc.blocks):
            raise AssertionError(f"a request launched B1 {launched} times, want {len(enc.blocks)}")
        if logits.shape != (CLIPS, 174) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        answers.append(logits)
    launches = fdn.LAUNCHES

    on_device = requests[0].to(dev)
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: clf(encode_clips(enc, on_device)), iters=3, warmup=1)

    # the same weights in fp32 on the CPU: the wrapper takes the plain path there
    torch.set_num_threads(os.cpu_count() or 1)
    t2 = time.perf_counter()
    enc_cpu, clf_cpu = build("cpu", torch.float32)
    enc_cpu.load_state_dict(enc.state_dict())
    clf_cpu.load_state_dict(clf.state_dict())
    with torch.inference_mode():
        ref = clf_cpu(encode_clips(enc_cpu, requests[0][:1]))[0]
    cpu_s = time.perf_counter() - t2
    got = answers[0][0]
    rel = ((got - ref).norm() / ref.norm()).item()
    ok = rel <= LOGITS_REL_L2
    med = sorted(times)[len(times) // 2]
    emit({"phase": "slice", "model": "vit_large 16f@256 bf16 + ssv2 probe (depth 4, 174)",
          "requests": REQUESTS, "clips_per_request": CLIPS, "warmup_requests": 1,
          "ms_per_request": times, "median_ms_per_request": med,
          "clips_per_s": CLIPS / (med / 1e3), "device_ms_per_request": device_ms,
          "b1_launches": launches, "b1_launches_per_request": len(enc.blocks),
          "logits_rel_l2_vs_cpu_fp32": rel, "logits_max_abs_err": (got - ref).abs().max().item(),
          "ref_logits_max_abs": ref.abs().max().item(), "tol_rel_l2": LOGITS_REL_L2,
          "setup_s": setup_s, "cpu_reference_s": cpu_s, "ok": ok, "gpu": smi})
    if not ok:
        raise AssertionError(f"slice logits off the CPU fp32 reference: rel L2 {rel}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    # reference comparisons run in full fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    rec = phase_kernels(dev, smi)
    launches = phase_slice(dev, smi)
    emit({"kernels": [{"name": "flash_fwd_dn", "route": "cuda", "source": KERNEL_SOURCE,
                       "replaces": KERNEL_REPLACES, "launches": launches,
                       "max_abs_err": rec["max_abs_err_out"], "ms": rec["ms"],
                       "plain_ms": rec["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
