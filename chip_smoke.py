#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vjepa2_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON object on a line of its own:

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build   — builds the port's CUDA kernels from ``vjepa2_tpu_torch/csrc``;
3. kernel  — the DN flash-attention kernel (B1, wgmma and TMA) against its
   plain PyTorch version at the production shapes, bf16, out and lse, each
   with its tolerance, and both timed with CUDA events; each record also
   gives the achieved TFLOP/s (4*Dh FLOPs a score) and the share of the
   bound;
4. slice   — the serving path: the ViT-L/16 encoder from the port's hub
   factory (RoPE, bf16, 16 frames at 256 px) and the SSv2 attentive probe
   (depth 4, 16 heads, 174 classes), random weights from a seeded generator,
   answering 3 requests of 8 clips; every request must launch B1 once per
   encoder layer, and the logits of one clip must match the port's fp32
   plain path on the CPU;
5. kernel_bwd — the DN flash backward (B2, wgmma and TMA) against its plain
   PyTorch version at the training shapes, with RoPE tables per example from
   real collator masks: dq, dk and dv, each with its tolerance, both timed,
   with the achieved TFLOP/s (10*Dh FLOPs a score) and the share of the
   bound;
6. train   — the masked-pretrain train step: ViT-L/16 (RoPE, bf16, fp32
   parameters and AdamW state), the 12-layer predictor (width 384, 12 heads),
   16 frames at 256 px, batch 8, the two mask configs of `bench.py:56-61`
   with fresh masks each step; 1 warm-up and 5 timed steps, each launching
   B1 96 times and B2 72 times; finite loss and gradients, the EMA of the
   target, and clip 0's loss and gradients against the port's fp32 plain path
   on the CPU from the same weights;
7. kernel_bhnd — the BHND flash forward (B3, wgmma and TMA) against its
   plain version at the ViT-H and 16-head ViT-g shapes (RoPE, kv_valid,
   per-example tables), plus a segments + key-side ids call and a causal
   call, and at the fused ViT-L step's rope-free shapes (Dh 64 and 32); each
   record also gives the achieved TFLOP/s and the share of the bound;
8. kernel_bhnd_bwd — the BHND flash backward (B4/B5, wgmma and TMA) against
   its plain version at the ViT-H context and target shapes, the ViT-g width,
   a ring-hop call (no RoPE, key-side ids, an lse given from outside), and the
   fused step's context (Dh 64) and predictor (Dh 32) shapes; TFLOP/s (10*Dh
   FLOPs a score) and the share of the bound as in phase 7;
9. train_huge — the masked-pretrain step of phase 6 with ViT-H/16 (32
   layers, width 1280, 16 heads of 80): 1 + 5 steps, each launching B3 96
   times, the BHND backward 64, B1 24 and B2 24 times; the same checks;
10. encode_giant — the 16-head ViT-g (40 layers, width 1408, heads of 88,
   `bench.py:369`'s headline encoder) answering 3 requests of 8 clips at
   16f@256, 40 B3 launches each, one clip's features against the fp32 CPU
   path;
11. entry  — the hub factories `vjepa2_vit_huge()` and `vjepa2_vit_large()`
   called with no argument, as a user calls them: the full encoder on the
   card in bf16, one clip, one B3 (ViT-H) or B1 (ViT-L) launch per layer;
12. kernel_ln — the LayerNorm kernels (B6 forward and backward) against
   their plain versions at [16384, 1024], [13312, 384], [16384, 1280] and
   [16384, 1408] rows and at the fused step's other backward rows, [4672,
   1024], [1408, 1024] and [12992, 384]: y, mean and rstd; dx, dgamma and
   dbeta; each timed by CUDA events around back-to-back calls (``ms``) and by
   the profiler with a cold L2 (``device_ms``, and its share of the bound),
   beside the yardsticks' device time;
13. kernel_ln_qkv / kernel_ln_mlp — the fused LayerNorm prologues (B7: LN +
   qkv + RoPE; B8: LN + fc1 + GELU; one wgmma and TMA mainloop) against their
   plain versions at the fused step's shapes (ViT-L target and contexts, the
   predictor) and at ViT-H and the 16-head ViT-g widths, [8, 2048] rows,
   with TFLOP/s and the share of the bound;
14. train_fused — the ViT-L step of phase 6 with ``fuse_ln="qkv,mlp"``
   (`bench.py --fuse-ln qkv,mlp`): every block's LayerNorms fused into B7
   and B8, attention on the BHND kernels; 1 + 5 steps, each launching B7 96,
   B8 96, B3 96, the BHND backward 72, the B6 backward 144 and B1/B2 0
   times; the checks of phase 6 against the fp32 CPU path with the same
   fusions; and, interleaved step by step in the same phase, the unfused
   step of phase 6 beside it (the A/B; nothing is claimed from it).

Every attention kernel phase also times
`torch.nn.functional.scaled_dot_product_attention` on the same inputs
(pre-rotated q and k) as a yardstick the port never calls; the LayerNorm
phases time `F.layer_norm` and its autograd backward, and the prologue
phases the unfused chain `F.layer_norm` -> `F.linear` -> RoPE or `F.gelu`.
Each call's bound is the larger of its FLOPs over 989 TFLOP/s (bf16 dense)
and its bytes (each input read once, each output written once) over
3.35 TB/s, with the FLOPs of the (query, key) pairs its masks leave.

Then the kernels' summary line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero without that line;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "vjepa2_tpu_torch/csrc/flash_fwd_dn.cu"
KERNEL_REPLACES = "vjepa2_tpu/ops/flash_attention_dn.py:129"
BWD_SOURCE = "vjepa2_tpu_torch/csrc/flash_bwd_dn.cu"
BWD_REPLACES = "vjepa2_tpu/ops/flash_attention_dn.py:298"
BHND_SOURCE = "vjepa2_tpu_torch/csrc/flash_fwd_bhnd.cu"
BHND_REPLACES = "vjepa2_tpu/ops/flash_attention.py:166"
BHND_BWD_SOURCE = "vjepa2_tpu_torch/csrc/flash_bwd_bhnd.cu"
# B4 (one pass) and B5 (`_dq_kernel:361`, `_dkv_kernel:434`): one CUDA backward
BHND_BWD_REPLACES = "vjepa2_tpu/ops/flash_attention.py:511"

LN_SOURCE = "vjepa2_tpu_torch/csrc/layernorm.cu"
LN_FWD_REPLACES = "vjepa2_tpu/ops/layernorm.py:103"
LN_BWD_REPLACES = "vjepa2_tpu/ops/layernorm.py:115"
LN_GEMM_SOURCE = "vjepa2_tpu_torch/csrc/ln_gemm_hopper.cu"  # B7 and B8
LN_QKV_REPLACES = "vjepa2_tpu/ops/ln_qkv.py:50"
LN_MLP_REPLACES = "vjepa2_tpu/ops/ln_mlp.py:78"

# H100 SXM dense bf16 peak and memory rate (NVIDIA's data sheet), for bounds
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_FP32 = 67e12  # fp32 outside the tensor cores (the LayerNorm kernels' arithmetic)

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

# The pretrain headline's mask configs (`bench.py:56-61`): 578 and 173
# context tokens, 1045 and 1489 targets at 16 frames x 256 px.
MASK_CFGS = [
    {"spatial_scale": (0.15, 0.15), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 8},
    {"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 2},
]
# (name, heads, head width, which sequence) — the shapes B2 takes in the step,
# N stack-padded to a multiple of 8, plus the AC predictor's for coverage
BWD_SHAPES = [
    ("context encoder, mask 0", 16, 64, "ctx0"),
    ("context encoder, mask 1", 16, 64, "ctx1"),
    ("predictor, mask 0", 12, 32, "pred0"),
    ("predictor, mask 1", 12, 32, "pred1"),
    ("ac predictor", 16, 64, "ac"),
]
# B2 against plain: both from the same bf16 inputs, plain in fp32. The kernels
# round at 2**-9 relative where plain does not: q_s and k_rot, q_u, p before
# dV, ds before dK and dQ, out before delta, and the gradients; about five
# independent roundings meet in each entry, so a relative L2 error near
# 5e-3 is expected: tolerance 2e-2, and max abs 3e-2 x max|plain| for the
# largest entries.
BWD_REL_L2, BWD_MAX_ABS = 2e-2, 3e-2
TRAIN_STEPS, TRAIN_WARMUP = 5, 1
# Clip 0's loss and gradients on the initial weights, bf16 on the card
# against fp32 on the CPU. The port's plain path in bf16 on the CPU, full
# depth and widths at 8f@128, differs from fp32 by 1.2e-2 (encoder) and
# 1.6e-2 (predictor) relative L2 in the gradients and 3e-4 in the loss; the
# kernels add their own roundings (B2: ~5e-3 a call), so about 2e-2 is
# expected: tolerance 5e-2 on each flattened gradient, 1e-2 on the loss.
TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2 = 1e-2, 5e-2

# (name, [B, H, N, D], features) — the shapes B3 takes on the main paths
BHND_SHAPES = [
    ("vit_huge target", (8, 16, 2048, 80), {"rope": "shared"}),
    ("vit_huge context, mask 0", (8, 16, 584, 80), {"rope": "ctx0", "kv_valid_len": 578}),
    ("vit_huge context, mask 1", (8, 16, 176, 80), {"rope": "ctx1", "kv_valid_len": 173}),
    ("vit_giant encoder", (8, 16, 2048, 88), {"rope": "shared"}),
    ("segments + seg_kv", (2, 16, 1024, 80), {"seg_kv": True}),
    ("causal", (2, 16, 1024, 80), {"causal": True}),
    # the fused ViT-L step: rope-free (B7 rotated q and k), B1's and B2's shapes
    ("fused vit_large target", (8, 16, 2048, 64), {}),
    ("fused vit_large context, mask 0", (8, 16, 584, 64), {"kv_valid_len": 578}),
    ("fused vit_large context, mask 1", (8, 16, 176, 64), {"kv_valid_len": 173}),
    ("fused predictor, mask 0", (8, 12, 1624, 32), {"kv_valid_len": 1623}),
    ("fused predictor, mask 1", (8, 12, 1664, 32), {"kv_valid_len": 1662}),
]
# the BHND backward's shapes: the context passes, JAX's B5 shape (full N with
# 1024-square blocks), the ViT-g width, and a ring hop
BHND_BWD_SHAPES = [
    ("vit_huge context, mask 0", (8, 16, 584, 80), {"rope": "ctx0", "kv_valid_len": 578}),
    ("vit_huge context, mask 1", (8, 16, 176, 80), {"rope": "ctx1", "kv_valid_len": 173}),
    ("full N (JAX's B5 shape)", (8, 16, 2048, 80), {"rope": "shared"}),
    ("vit_giant width", (2, 16, 2048, 88), {"rope": "shared"}),
    ("ring hop: seg_kv, given lse", (2, 16, 1024, 80), {"seg_kv": True, "global_lse": True}),
    ("fused vit_large context, mask 0", (8, 16, 584, 64), {"kv_valid_len": 578}),
    ("fused vit_large context, mask 1", (8, 16, 176, 64), {"kv_valid_len": 173}),
    ("fused predictor, mask 0", (8, 12, 1624, 32), {"kv_valid_len": 1623}),
    ("fused predictor, mask 1", (8, 12, 1664, 32), {"kv_valid_len": 1662}),
]
# launch counters, in the order `_launch_counts` reads them
KERNEL_COUNTS = ("b1", "b2", "b3", "bhnd_bwd", "b6_fwd", "b6_bwd", "b7", "b8")
# the step of phase 6 per (encoder, fusions): (phase, launches per step in
# the order of KERNEL_COUNTS). ViT-L: 24 target + 2 x (24 + 12) B1; ViT-H: 32
# target + 2 x 32 context B3, 2 x 12 predictor B1; fused ViT-L: B7, B8 and B3
# in all 96 blocks, the backwards in the 72 with gradients, B6's backward
# twice in each (B7's and B8's LayerNorm tail).
TRAIN_CFGS = {
    ("vit_large", ""): ("train", (96, 72, 0, 0, 0, 0, 0, 0)),
    ("vit_huge", ""): ("train_huge", (24, 24, 96, 64, 0, 0, 0, 0)),
    ("vit_large", "qkv,mlp"): ("train_fused", (0, 0, 96, 72, 0, 144, 96, 96)),
}
GIANT_REL_L2 = 5e-2  # bf16 on the card against fp32 on the CPU, 40 layers

# B6 rows: (name, [R, C]); the last three and the predictor's are the fused
# ViT-L step's backward rows (the contexts' 578 and 173 tokens stack-padded)
LN_SHAPES = [
    ("vit_large [8, 2048] rows", (16384, 1024)),
    ("predictor [8, 1664] rows", (13312, 384)),
    ("vit_huge [8, 2048] rows", (16384, 1280)),
    ("vit_giant [8, 2048] rows", (16384, 1408)),
    ("vit_large context [8, 584] rows", (4672, 1024)),
    ("vit_large context [8, 176] rows", (1408, 1024)),
    ("predictor [8, 1624] rows", (12992, 384)),
]
# B6 against plain from the same bf16 inputs: mean within 1e-5, rstd within
# 1e-4 relative (summation order; rsqrtf within 2 ulp); y and dx are bf16
# roundings of one fp32 value, so within one bf16 step (2**-7 relative) plus
# 1e-3; dgamma and dbeta within 1e-4 relative L2 (fp32 sums in another order).
LN_STAT_ATOL, LN_RSTD_RTOL, LN_ATOL, LN_RTOL, LN_PARAM_REL_L2 = 1e-5, 1e-4, 1e-3, 2**-7, 1e-4
# B7/B8: (name, B, N, C, heads, head width, hidden, tables, real tokens)
PROLOGUE_SHAPES = [
    ("vit_large target", 8, 2048, 1024, 16, 64, 4096, "shared", None),
    ("vit_large context, mask 0", 8, 584, 1024, 16, 64, 4096, "ctx0", 578),
    ("vit_large context, mask 1", 8, 176, 1024, 16, 64, 4096, "ctx1", 173),
    ("predictor, mask 0", 8, 1624, 384, 12, 32, 1536, "pred0", 1623),
    ("predictor, mask 1", 8, 1664, 384, 12, 32, 1536, "pred1", 1662),
    ("vit_huge target", 8, 2048, 1280, 16, 80, 5120, "shared", None),
    ("vit_giant target", 8, 2048, 1408, 16, 88, 6144, "shared", None),
]
# B7/B8 against plain from the same bf16 inputs: each output rounds once to
# bf16 (2**-9) and y may round to the neighbouring bf16 value where the
# statistics differ in the last bit: 5e-3 + 1e-2 |plain|.
PROLOGUE_ATOL, PROLOGUE_RTOL = 5e-3, 1e-2


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


FLUSH_BYTES = 64 << 20  # more than the card's 50 MB L2


def device_times(fn, calls: int = 5, cold: bool = True) -> tuple[float, dict[str, float]]:
    """(device ms per call of ``fn``, {kernel: device ms per call}) by
    `torch.profiler`; the first is the time some kernel of the call runs
    (the union of their intervals: a programmatic dependent launch overlaps
    its primary), the second sums each kernel's own time (names cut to the
    kernel's identifier). Cold: a 64 MiB write before each call evicts the
    L2, so the call reads its inputs from device memory, as a train step
    finds them; the write's kernels are left out (they are found by
    profiling the write alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced(body, skip=frozenset()) -> list[tuple[str, float, float]]:
        # the profiler now and then returns a session without its device
        # events: trace again, and fail rather than time nothing
        for _ in range(5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(calls):
                    body(i)
                torch.cuda.synchronize()
            spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == DeviceType.CUDA and e.name not in skip
                     and e.time_range.end > e.time_range.start]
            if spans:
                return spans
        raise RuntimeError("the profiler recorded no device events in five sessions")

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    skip = {name for name, _, _ in traced(lambda i: flush.fill_(1 + i))} if cold else set()
    fn()  # warm-up
    spans = sorted((a, b, name) for name, a, b in
                   traced(lambda i: (flush.fill_(1 + i) if cold else None, fn()), skip))
    by_kernel: dict[str, float] = {}
    busy, end = 0.0, float("-inf")
    for a, b, name in spans:
        m = re.search(r"\w+_kernel(<[\w, <>]*>)?", name.replace("(anonymous namespace)::", ""))
        key = m.group() if m else name[:80]
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a) / 1e3 / calls
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3 / calls, by_kernel


def bound(flops: float, nbytes: int, peak: float = PEAK_FLOPS) -> tuple[float, str]:
    """(least ms the card could take, what bounds it), the operations at the
    ``peak`` rate of their type."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def pair_mask(B, N, M, dev, kv_valid=None, seg_q=None, seg_k=None, causal=False):
    """[B|1, 1, N, M] bool, True where a query attends a key, or None."""
    mask = None
    if kv_valid is not None and kv_valid < M:
        mask = (torch.arange(M, device=dev) < kv_valid)[None, None, None, :]
    if seg_q is not None:
        seg = (seg_q[:, None, :, None] >= seg_k[:, None, None, :])
        mask = seg if mask is None else mask & seg
    if causal:
        tri = torch.ones(N, M, dtype=torch.bool, device=dev).tril()[None, None]
        mask = tri if mask is None else mask & tri
    return mask


def attended_pairs(B, H, N, M, mask) -> int:
    """(query, key) pairs the masks leave, over all batches and heads."""
    if mask is None:
        return B * H * N * M
    return int(mask.expand(B, 1, N, M).sum().item()) * H


def library_fwd_ms(qr, kr, v, mask, causal=False) -> float:
    """`F.scaled_dot_product_attention` on pre-rotated [B, H, N, D] operands
    (timed as a yardstick; the port never calls it)."""
    import torch.nn.functional as F

    if causal:
        return cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, is_causal=True), 20)
    return cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask), 20)


def library_bwd_ms(qr, kr, v, do, mask, causal=False) -> float:
    """The backward of `F.scaled_dot_product_attention` alone: autograd
    through a recorded call, retained, on the same inputs."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (qr, kr, v)]
    with torch.enable_grad():
        if causal:
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        else:
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        return cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 10)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_bhnd_kernel<80,80>`` or ``ln_gemm_wgmma_kernel<QkvEpilogue<64,4>>``
    from a mangled ptxas function name: an identifier ending in ``_kernel``
    whose length is the number just before it (the digits of a hash may run
    into that number), then its template arguments (integers, and a struct
    with integer arguments)."""
    for m in re.finditer(r"[A-Za-z_]+_kernel", mangled):
        digits = re.search(r"\d+$", mangled[:m.start()])
        if digits and digits.group().endswith(str(len(m.group()))):
            rest = mangled[m.end():]
            if a := re.match(r"I((?:L[ib]\d+E)+)", rest):
                return m.group() + f"<{','.join(re.findall(r'L[ib](\d+)E', a.group(1)))}>"
            if a := re.match(r"INS_(\d+)", rest):  # a struct: its name, then its integers
                name = rest[a.end():a.end() + int(a.group(1))]
                b = re.match(r"I((?:L[ib]\d+E)+)", rest[a.end() + len(name):])
                ints = f"<{','.join(re.findall(r'L[ib](\d+)E', b.group(1)))}>" if b else ""
                return f"{m.group()}<{name}{ints}>"
            return m.group()
    return "?"


def phase_build() -> None:
    from vjepa2_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    # per kernel instantiation: registers, spill stores and loads (-Xptxas -v)
    ptxas, name, spill = [], "?", ""
    for ln in _build.build_log().splitlines():
        if "Function properties for" in ln:
            name = _kernel_name(ln)
        elif "spill stores" in ln:
            spill = ", ".join(x.strip() for x in ln.split(",")[1:])
        elif m := re.search(r"Used (\d+) registers", ln):
            ptxas.append(f"{name}: {m.group(1)} registers, {spill}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.library_path().relative_to(_build.BUILD_DIR.parent.parent)),
          "ptxas": ptxas})


def _dn_case(dev, B, H, D, N, feats):
    """(q, k, v, kwargs) for one B1 shape: random bf16 [B, H, D, N]
    operands, shared RoPE tables, and the shape's kv_valid or frame-causal
    segments (equal frames of tokens)."""
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(B, H, D, N).astype(np.float32))
               .to(dev, torch.bfloat16) for _ in range(3))
    (cos, sin), _ = expand_rope_cache(build_rope_cache(torch.arange(N, device=dev), D, 16, 16), D)
    kw = {"rope_expanded": (cos, sin)}
    if "kv_valid_len" in feats:
        kw["kv_valid_len"] = feats["kv_valid_len"]
    if "segments" in feats:
        frames = feats["segments"]
        kw["segment_ids"] = torch.arange(frames, device=dev, dtype=torch.int32) \
            .repeat_interleave(N // frames)
    return q, k, v, kw


def phase_kernels(dev, smi: str) -> dict:
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops.rope import rope_rotate

    first = None
    for name, (B, H, D, N), feats in SHAPES:
        q, k, v, kw = _dn_case(dev, B, H, D, N, feats)
        cos, sin = kw["rope_expanded"]
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
            seg = kw.get("segment_ids")
            seg = None if seg is None else seg[None]
            mask = pair_mask(B, N, N, dev, kw.get("kv_valid_len"), seg, seg)
            qr, kr = (rope_rotate(t.transpose(2, 3).float(), cos[:, None], sin[:, None])
                      .to(torch.bfloat16).contiguous() for t in (q, k))
            library_ms = library_fwd_ms(qr, kr, v.transpose(2, 3).contiguous(), mask)
            flops = 4 * D * attended_pairs(B, H, N, N, mask)
            bound_ms, bound_by = bound(flops, nbytes(q, k, v, cos, sin, seg, out_k, lse_k))
        rec = {"phase": "kernel", "kernel": "flash_fwd_dn", "shape": name, "bhdn": [B, H, D, N],
               "features": sorted(kw), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / ms / 1e9,
               "bound_share": bound_ms / ms,
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
    _reset_launch_counts()
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


def _masks(coll, batch: int):
    """One fresh collator step: (masks_enc, masks_pred) as int32 arrays."""
    coll.step()
    return coll(FRAMES, batch)


def _dn_bwd_case(dev, H, D, seq, seqs):
    """(q, k, v, do, kwargs) for one B2 shape of `BWD_SHAPES`: random bf16
    [8, H, D, N] operands and cotangent, per-example RoPE tables of a
    collator sequence stack-padded to a multiple of 8 with its kv_valid, or
    the AC predictor's frame-causal segments with shared tables."""
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    rng = np.random.RandomState(0)
    kw = {}
    if seq == "ac":  # 7 frames of 2 + 256 tokens, frame-causal, shared tables
        N = 1806
        pos = torch.arange(N, device=dev)
        kw["segment_ids"] = torch.arange(7, device=dev, dtype=torch.int32) \
            .repeat_interleave(N // 7)
    else:  # per-example positions, stack-padded with id 0 as the models pad
        ids = seqs[seq]
        N = ids.shape[1] + (-ids.shape[1]) % 8
        pos = torch.zeros(8, N, dtype=torch.long)
        pos[:, :ids.shape[1]] = torch.from_numpy(ids)
        pos = pos.to(dev)
        kw["kv_valid_len"] = ids.shape[1]
    (cos, sin), _ = expand_rope_cache(build_rope_cache(pos, D, 16, 16), D)
    kw["rope_expanded"] = (cos, sin)
    q, k, v, do = (torch.from_numpy(rng.randn(8, H, D, N).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(4))
    return q, k, v, do, kw


def phase_kernels_bwd(dev, smi: str) -> dict:
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops.rope import rope_rotate

    seqs, first = _mask_seqs(), None
    for name, H, D, seq in BWD_SHAPES:
        q, k, v, do, kw = _dn_bwd_case(dev, H, D, seq, seqs)
        B, N = q.shape[0], q.shape[3]
        cos, sin = kw["rope_expanded"]
        with torch.no_grad():
            out, lse = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
            got = fdn.flash_attention_bhdn_bwd(q, k, v, out, lse, do, **kw)
            q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
            out_p, lse_p = fdn.flash_attention_bhdn_plain(q32, k32, v32, **kw)
            want = fdn.flash_attention_bhdn_bwd_plain(q32, k32, v32, out_p, lse_p, do32, **kw)
            torch.cuda.synchronize()
            errs, ok = {}, True
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                g = g.float()
                rel = ((g - w).norm() / w.norm()).item()
                err = (g - w).abs().max().item()
                scale = w.abs().max().item()
                errs[gname] = {"rel_l2": rel, "max_abs_err": err, "max_abs_plain": scale}
                ok = ok and bool(torch.isfinite(g).all()) and rel <= BWD_REL_L2 \
                    and err <= BWD_MAX_ABS * scale
            ms = cuda_ms(lambda: fdn.flash_attention_bhdn_bwd(q, k, v, out, lse, do, **kw),
                         iters=20)
            plain_ms = cuda_ms(
                lambda: fdn.flash_attention_bhdn_bwd_plain(q, k, v, out, lse, do, **kw), iters=3)
            seg = kw.get("segment_ids")
            seg = None if seg is None else seg[None]
            mask = pair_mask(B, N, N, dev, kw.get("kv_valid_len"), seg, seg)
            qr, kr = (rope_rotate(t.transpose(2, 3).float(), cos[:, None], sin[:, None])
                      .to(torch.bfloat16).contiguous() for t in (q, k))
            library_ms = library_bwd_ms(qr, kr, v.transpose(2, 3).contiguous(),
                                        do.transpose(2, 3).contiguous(), mask)
            flops = 10 * D * attended_pairs(B, H, N, N, mask)  # S, dP, dV, dK, dQ
            bound_ms, bound_by = bound(flops, nbytes(q, k, v, out, do, lse, cos, sin, seg, *got))
        rec = {"phase": "kernel_bwd", "kernel": "flash_bwd_dn", "shape": name,
               "bhdn": [B, H, D, N], "features": sorted(kw),
               "kv_valid": kw.get("kv_valid_len"), "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms, "errors": errs, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "tol": {"rel_l2": BWD_REL_L2, "max_abs": f"{BWD_MAX_ABS}*max|plain|"},
               "ok": ok, "gpu": smi}
        emit(rec)
        if not ok:
            raise AssertionError(f"flash_bwd_dn disagrees with its plain version at {name}")
        first = first or rec
    return first


def _launch_counts() -> tuple[int, ...]:
    """Launches since the last reset, in the order of KERNEL_COUNTS."""
    from vjepa2_tpu_torch.ops import flash_attention as fa
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops import layernorm as ln
    from vjepa2_tpu_torch.ops import ln_mlp, ln_qkv

    return (fdn.LAUNCHES, fdn.LAUNCHES_BWD, fa.LAUNCHES, fa.LAUNCHES_BWD, ln.LAUNCHES,
            ln.LAUNCHES_BWD, ln_qkv.LAUNCHES, ln_mlp.LAUNCHES)


def _reset_launch_counts() -> None:
    from vjepa2_tpu_torch.ops import flash_attention as fa
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops import layernorm as ln
    from vjepa2_tpu_torch.ops import ln_mlp, ln_qkv

    fdn.LAUNCHES = fdn.LAUNCHES_BWD = fa.LAUNCHES = fa.LAUNCHES_BWD = 0
    ln.LAUNCHES = ln.LAUNCHES_BWD = ln_qkv.LAUNCHES = ln_mlp.LAUNCHES = 0


class _Trainer:
    """One masked-pretrain run of phase 6 on the card: the models (random
    weights from a seeded generator), AdamW and the EMA target, the collator
    with fresh masks each step, one bf16 batch of clips."""

    def __init__(self, dev, model: str, fuse_ln: str = ""):
        from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
        from vjepa2_tpu_torch.train import pretrain as tp
        from vjepa2_tpu_torch.train.state import TrainState

        self.dev, self.model, self.fuse_ln, self.tp = dev, model, fuse_ln, tp
        self.phase, self.per_step = TRAIN_CFGS[(model, fuse_ln)]
        t0 = time.perf_counter()
        self.enc, self.pred = self.build(dev, torch.bfloat16)
        tp.init_params(self.enc, self.pred, torch.Generator(device=dev).manual_seed(0))
        self.hp = tp.PretrainHParams(ipe=100, epochs=10)  # as `bench.py:bench_pretrain`
        self.state = TrainState.create(self.enc, self.pred,
                                       tp.make_optimizer(self.hp, self.enc, self.pred))
        self.train_step = tp.make_train_step(self.hp)
        self.coll = MaskCollator(MASK_CFGS, dataset_fpcs=[FRAMES], crop_size=(SIZE, SIZE))
        self.clips = torch.from_numpy(np.random.RandomState(0).rand(CLIPS, FRAMES, SIZE, SIZE, 3)
                                      .astype(np.float32)).to(dev, torch.bfloat16)
        self.setup_s = time.perf_counter() - t0

    def build(self, device, dtype):
        return self.tp.build_models(self.model, crop_size=SIZE, num_frames=FRAMES, pred_depth=12,
                                    pred_embed_dim=384, pred_num_heads=12, use_rope=True,
                                    num_mask_tokens=2, use_flash=True, dtype=dtype,
                                    device=device, fuse_ln=self.fuse_ln)

    def step(self):
        me, mp = _masks(self.coll, CLIPS)
        to_dev = lambda ms: [torch.from_numpy(m).to(self.dev) for m in ms]  # noqa: E731
        metrics = self.train_step(self.state, self.clips, to_dev(me), to_dev(mp))
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"non-finite loss {loss} or grad norm {gnorm}")
        return loss, gnorm, metrics["ema_momentum"], (me, mp)

    def timed_step(self):
        """One step timed on the host clock; its launches must be per_step."""
        before = _launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, gnorm, _, masks = self.step()
        ms = (time.perf_counter() - t1) * 1e3
        launched = tuple(a - b for a, b in zip(_launch_counts(), before))
        if launched != self.per_step:
            raise AssertionError(f"a {self.phase} step launched "
                                 f"{dict(zip(KERNEL_COUNTS, launched))}, want "
                                 f"{dict(zip(KERNEL_COUNTS, self.per_step))}")
        return ms, loss, gnorm, masks

    def clip0(self) -> dict:
        """Clip 0's loss and gradients on the initial weights on the card,
        then in fp32 on the CPU through the plain path with the same fusions
        (after a few Adam steps the encoder's gradient norm falls ~2000x and
        bf16 noise dominates it)."""
        tp = self.tp
        me, mp = _masks(self.coll, CLIPS)
        me0, mp0 = [torch.from_numpy(m[:1]) for m in me], [torch.from_numpy(m[:1]) for m in mp]

        def loss_and_grads(e, p, tgt, x, me_, mp_):
            h = tp.target_features(tgt, x, mp_)
            e.zero_grad(set_to_none=True)
            p.zero_grad(set_to_none=True)
            loss = tp.forward_loss(e, p, x, me_, mp_, h, self.hp.loss_exp)
            loss.backward()
            flat = [torch.cat([q.grad.float().flatten().cpu() for q in m.parameters()])
                    for m in (e, p)]
            return loss.item(), flat

        to_dev = lambda ms: [m.to(self.dev) for m in ms]  # noqa: E731
        loss_gpu, (ge_gpu, gp_gpu) = loss_and_grads(self.enc, self.pred, self.state.target_encoder,
                                                    self.clips[:1], to_dev(me0), to_dev(mp0))
        torch.set_num_threads(os.cpu_count() or 1)
        t2 = time.perf_counter()
        enc_cpu, pred_cpu = self.build("cpu", torch.float32)
        tgt_cpu, _ = self.build("cpu", torch.float32)
        enc_cpu.load_state_dict(self.enc.state_dict())
        pred_cpu.load_state_dict(self.pred.state_dict())
        tgt_cpu.load_state_dict(self.state.target_encoder.state_dict())
        loss_cpu, (ge_cpu, gp_cpu) = loss_and_grads(enc_cpu, pred_cpu, tgt_cpu,
                                                    self.clips[:1].float().cpu(), me0, mp0)
        cpu_s = time.perf_counter() - t2
        del enc_cpu, pred_cpu, tgt_cpu
        return {"loss_gpu": loss_gpu, "loss_cpu_fp32": loss_cpu,
                "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
                "encoder_grad_rel_l2": ((ge_gpu - ge_cpu).norm() / ge_cpu.norm()).item(),
                "predictor_grad_rel_l2": ((gp_gpu - gp_cpu).norm() / gp_cpu.norm()).item(),
                "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel_l2": TRAIN_GRAD_REL_L2},
                "depth": f"full ({len(self.enc.blocks)} + 12 layers)", "cpu_reference_s": cpu_s}

    def warmup_with_ema_check(self) -> tuple[float, str]:
        """The warm-up step, which also checks the EMA on one target leaf."""
        name = "blocks.0.attn.qkv.weight"
        old = self.state.target_encoder.get_parameter(name).detach().clone()
        _, _, momentum, _ = self.step()
        new_online = self.state.encoder.get_parameter(name).detach()
        want = old * momentum + new_online * (1.0 - momentum)
        ema_err = (self.state.target_encoder.get_parameter(name) - want).abs().max().item()
        if ema_err > 1e-6 * want.abs().max().item():
            raise AssertionError(f"EMA target off m*old + (1-m)*online by {ema_err}")
        return ema_err, name

    def finite_grads(self) -> None:
        named = [(f"encoder.{k}", p) for k, p in self.enc.named_parameters()]
        named += [(f"predictor.{k}", p) for k, p in self.pred.named_parameters()]
        bad = [k for k, p in named if p.grad is None or not torch.isfinite(p.grad).all()]
        if bad:
            raise AssertionError(f"parameters without a finite gradient: {bad[:5]}")


def _clip0_ok(c: dict) -> bool:
    return (c["loss_rel_err"] <= TRAIN_LOSS_REL and c["encoder_grad_rel_l2"] <= TRAIN_GRAD_REL_L2
            and c["predictor_grad_rel_l2"] <= TRAIN_GRAD_REL_L2)


def _step_record(tr: _Trainer, times, losses, norms, masks) -> dict:
    med = sorted(times)[len(times) // 2]
    return {"ms_per_step": times, "median_ms_per_step": med, "clips_per_s": CLIPS / (med / 1e3),
            "losses": losses, "grad_norms": norms,
            "mask_lengths": {"ctx": [m.shape[1] for m in masks[0]],
                             "pred": [m.shape[1] for m in masks[1]]},
            "launches_per_step": dict(zip(KERNEL_COUNTS, tr.per_step))}


def phase_train(dev, smi: str, model: str = "vit_large") -> tuple[int, ...]:
    tr = _Trainer(dev, model)
    clip0 = tr.clip0()
    torch.cuda.reset_peak_memory_stats(dev)
    ema_err, leaf = tr.warmup_with_ema_check()
    _reset_launch_counts()
    times, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        ms, loss, gnorm, masks = tr.timed_step()
        times.append(ms)
        losses.append(loss)
        norms.append(gnorm)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    tr.finite_grads()
    ok = _clip0_ok(clip0)
    emit({"phase": tr.phase,
          "model": f"{model} 16f@256 bs8 + predictor (12 x 384, 12 heads) bf16, AdamW fp32",
          "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS, **_step_record(tr, times, losses,
                                                                              norms, masks),
          "peak_memory_gb": peak_gb, "launches": dict(zip(KERNEL_COUNTS, launches)),
          "ema_max_abs_err": ema_err, "ema_leaf": leaf, "clip0": clip0,
          "setup_s": tr.setup_s, "ok": ok, "gpu": smi})
    if not ok:
        raise AssertionError(f"clip-0 loss or gradients off the CPU fp32 reference: {clip0}")
    return launches


def phase_train_fused(dev, smi: str) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The fused ViT-L step (`fuse_ln="qkv,mlp"`) with the checks of phase 6,
    then the unfused step of phase 6 beside it, the two alternating step by
    step. Peak memory is each run's own: the fused one's over its warm-up
    before the unfused run exists, the unfused one's in phase `train`.
    Returns the launches of (the fused steps, the unfused steps)."""
    fused = _Trainer(dev, "vit_large", "qkv,mlp")
    clip0 = fused.clip0()
    torch.cuda.reset_peak_memory_stats(dev)
    ema_err, leaf = fused.warmup_with_ema_check()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    plain = _Trainer(dev, "vit_large")
    plain.step()  # its warm-up
    runs = {"fused": (fused, [], [], []), "unfused": (plain, [], [], [])}
    launches = {name: (0,) * len(KERNEL_COUNTS) for name in runs}
    masks = None
    for _ in range(TRAIN_STEPS):
        for name in ("unfused", "fused"):
            tr, times, losses, norms = runs[name]
            before = _launch_counts()
            ms, loss, gnorm, masks_ = tr.timed_step()
            launches[name] = tuple(t + a - b for t, a, b in
                                   zip(launches[name], _launch_counts(), before))
            times.append(ms)
            losses.append(loss)
            norms.append(gnorm)
            if name == "fused":
                masks = masks_
    fused.finite_grads()
    ok = _clip0_ok(clip0)
    rec = {name: _step_record(tr, times, losses, norms, masks)
           for name, (tr, times, losses, norms) in runs.items()}
    rec["fused"].update(peak_memory_gb=peak_gb,
                        launches=dict(zip(KERNEL_COUNTS, launches["fused"])))
    rec["unfused"]["launches"] = dict(zip(KERNEL_COUNTS, launches["unfused"]))
    emit({"phase": "train_fused",
          "model": "vit_large 16f@256 bs8 + predictor (12 x 384, 12 heads) bf16, AdamW fp32, "
                   "fuse_ln qkv,mlp",
          "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
          "order": f"unfused, fused; x{TRAIN_STEPS}",
          **rec, "fused_over_unfused_median": rec["fused"]["median_ms_per_step"]
          / rec["unfused"]["median_ms_per_step"],
          "ema_max_abs_err": ema_err, "ema_leaf": leaf, "clip0": clip0,
          "setup_s": fused.setup_s, "ok": ok, "gpu": smi})
    if not ok:
        raise AssertionError(f"fused clip-0 loss or gradients off the CPU fp32 reference: {clip0}")
    return launches["fused"], launches["unfused"]


def _bhnd_case(dev, B, H, N, D, feats, seqs):
    """(q, k, v, do, kwargs, mask) for one BHND shape: random bf16 operands,
    RoPE tables (`_rope_tables`), and the shape's masks."""
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, N, D).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(4))
    kw, seg_q, seg_k = {}, None, None
    if feats.get("rope"):
        kw["rope_expanded"] = _rope_tables(dev, B, N, D, feats["rope"], seqs)
    if "kv_valid_len" in feats:
        kw["kv_valid_len"] = feats["kv_valid_len"]
    if feats.get("seg_kv"):  # a ring hop: frames 4-11 of queries, 0-15 of keys
        seg_q = (torch.arange(8, device=dev, dtype=torch.int32) + 4).repeat_interleave(N // 8)
        seg_k = torch.arange(16, device=dev, dtype=torch.int32).repeat_interleave(N // 16)
        seg_q, seg_k = seg_q[None].expand(B, N), seg_k[None].expand(B, N)
        kw["segment_ids"], kw["seg_kv"] = seg_q, seg_k
    if feats.get("causal"):
        kw["causal"] = True
    mask = pair_mask(B, N, N, dev, kw.get("kv_valid_len"), seg_q, seg_k, kw.get("causal", False))
    return q, k, v, do, kw, mask


def _rotated(q, k, kw):
    """q and k rotated and rounded to bf16, for the library call."""
    from vjepa2_tpu_torch.ops.rope import rope_rotate

    if "rope_expanded" not in kw:
        return q, k
    cos, sin = kw["rope_expanded"]
    return tuple(rope_rotate(t.float(), cos[:, None], sin[:, None]).to(torch.bfloat16)
                 for t in (q, k))


def _mask_seqs():
    """Sorted per-example positions of one collator step at batch 8: the
    context (``ctx0``, ``ctx1``) and the predictor's context + targets
    (``pred0``, ``pred1``) of each mask config."""
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator

    me, mp = _masks(MaskCollator(MASK_CFGS, dataset_fpcs=[FRAMES], crop_size=(SIZE, SIZE)), 8)
    seqs = {f"ctx{i}": np.sort(m, axis=1) for i, m in enumerate(me)}
    seqs.update({f"pred{i}": np.sort(np.concatenate([a, b], axis=1), axis=1)
                 for i, (a, b) in enumerate(zip(me, mp))})
    return seqs


def phase_kernels_bhnd(dev, smi: str) -> dict:
    from vjepa2_tpu_torch.ops import flash_attention as fa

    seqs, first = _mask_seqs(), None
    for name, (B, H, N, D), feats in BHND_SHAPES:
        q, k, v, _, kw, mask = _bhnd_case(dev, B, H, N, D, feats, seqs)
        with torch.inference_mode():
            out_k, lse_k = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
            out_p, lse_p = fa.flash_attention_bhnd_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            d_out = (out_k.float() - out_p.float()).abs()
            d_lse = (lse_k - lse_p).abs()
            ok = bool(torch.isfinite(out_k.float()).all() and torch.isfinite(lse_k).all()
                      and (d_out <= OUT_ATOL + OUT_RTOL * out_p.float().abs()).all()
                      and d_lse.max() <= LSE_ATOL)
            ms = cuda_ms(lambda: fa.flash_attention_bhnd(q, k, v, **kw), iters=20)
            plain_ms = cuda_ms(lambda: fa.flash_attention_bhnd_plain(q, k, v, **kw), iters=5)
            library_ms = library_fwd_ms(*_rotated(q, k, kw), v, mask, kw.get("causal", False))
        side = [*kw.get("rope_expanded", ()), kw.get("segment_ids"), kw.get("seg_kv")]
        flops = 4 * D * attended_pairs(B, H, N, N, mask)
        bound_ms, bound_by = bound(flops, nbytes(q, k, v, *side, out_k, lse_k))
        rec = {"phase": "kernel_bhnd", "kernel": "flash_fwd_bhnd", "shape": name,
               "bhnd": [B, H, N, D], "features": sorted(kw), "kv_valid": kw.get("kv_valid_len"),
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
               "max_abs_err_out": d_out.max().item(),
               "max_abs_err_lse": d_lse.max().item(),
               "tol": {"out": f"{OUT_ATOL} + {OUT_RTOL}*|plain|", "lse": LSE_ATOL},
               "ok": ok, "gpu": smi}
        emit(rec)
        if not ok:
            raise AssertionError(f"flash_fwd_bhnd disagrees with its plain version at {name}")
        first = first or rec
    return first


def phase_kernels_bhnd_bwd(dev, smi: str) -> dict:
    from vjepa2_tpu_torch.ops import flash_attention as fa

    seqs, first = _mask_seqs(), None
    for name, (B, H, N, D), feats in BHND_BWD_SHAPES:
        q, k, v, do, kw, mask = _bhnd_case(dev, B, H, N, D, feats, seqs)

        def given_lse(lse):  # a ring's global lse: this hop's mass and another's
            return torch.logaddexp(lse, lse - 0.7) if feats.get("global_lse") else lse

        with torch.no_grad():
            out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
            lse = given_lse(lse)
            got = fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)
            q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
            out_p, lse_p = fa.flash_attention_bhnd_plain(q32, k32, v32, **kw)
            want = fa.flash_attention_bhnd_bwd_plain(q32, k32, v32, out_p, given_lse(lse_p),
                                                     do32, **kw)
            del q32, k32, v32, do32, out_p
            torch.cuda.synchronize()
            errs, ok = {}, True
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                g = g.float()
                rel = ((g - w).norm() / w.norm()).item()
                err = (g - w).abs().max().item()
                scale = w.abs().max().item()
                errs[gname] = {"rel_l2": rel, "max_abs_err": err, "max_abs_plain": scale}
                ok = ok and bool(torch.isfinite(g).all()) and rel <= BWD_REL_L2 \
                    and err <= BWD_MAX_ABS * scale
            del want
            ms = cuda_ms(lambda: fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw),
                         iters=20)
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_bhnd_bwd_plain(q, k, v, out, lse, do, **kw), iters=3)
        library_ms = library_bwd_ms(*_rotated(q, k, kw), v, do, mask, kw.get("causal", False))
        side = [*kw.get("rope_expanded", ()), kw.get("segment_ids"), kw.get("seg_kv")]
        flops = 10 * D * attended_pairs(B, H, N, N, mask)  # S, dP, dV, dK, dQ
        bound_ms, bound_by = bound(flops, nbytes(q, k, v, out, do, lse, *side, *got))
        rec = {"phase": "kernel_bhnd_bwd", "kernel": "flash_bwd_bhnd", "shape": name,
               "bhnd": [B, H, N, D], "features": sorted(kw) + (["global lse"] if
                                                               feats.get("global_lse") else []),
               "kv_valid": kw.get("kv_valid_len"), "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
               "errors": errs, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "tol": {"rel_l2": BWD_REL_L2, "max_abs": f"{BWD_MAX_ABS}*max|plain|"},
               "ok": ok, "gpu": smi}
        emit(rec)
        if not ok:
            raise AssertionError(f"flash_bwd_bhnd disagrees with its plain version at {name}")
        first = first or rec
    return first


def _rope_tables(dev, B, N, D, kind, seqs):
    """Split-half (cos, sin): [1, N, D] for ``"shared"`` positions, else per
    example from a collator mask stack-padded with id 0, as the models pad."""
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    pos = torch.arange(N, device=dev)
    if kind != "shared":
        ids = seqs[kind]
        pos = torch.zeros(B, N, dtype=torch.long)
        pos[:, :ids.shape[1]] = torch.from_numpy(ids)
        pos = pos.to(dev)
    return expand_rope_cache(build_rope_cache(pos, D, 16, 16), D)[0]


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _within(got, want, atol, rtol) -> bool:
    got, want = got.float(), want.float()
    close = (got - want).abs() <= atol + rtol * want.abs()
    return bool(torch.isfinite(got).all() and close.all())


def _ln_case(dev, R, C):
    """(x, dy, gamma, beta) for one B6 shape: random bf16 rows and cotangent,
    a random fp32 affine."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(R, C) * 2 + 0.3).astype(np.float32)).to(dev, torch.bfloat16)
    dy = torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(dev, torch.bfloat16)
    gamma = torch.from_numpy((rng.randn(C) * 0.5 + 1).astype(np.float32)).to(dev)
    beta = torch.from_numpy((rng.randn(C) * 0.5).astype(np.float32)).to(dev)
    return x, dy, gamma, beta


def ln_yardsticks(x, dy, gamma, beta):
    """`F.layer_norm` (bf16 affine) and its autograd backward on B6's inputs:
    the yardsticks, never on the port's path."""
    import torch.nn.functional as F

    C = x.shape[-1]
    g16, b16 = gamma.bfloat16(), beta.bfloat16()
    leaves = [t.detach().requires_grad_() for t in (x, g16, b16)]
    with torch.enable_grad():
        out = F.layer_norm(leaves[0], (C,), leaves[1], leaves[2], 1e-6)
    return (lambda: F.layer_norm(x, (C,), g16, b16, 1e-6),
            lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))


def phase_kernels_ln(dev, smi: str) -> tuple[dict, dict]:
    """B6 forward and backward against their plain versions; `F.layer_norm`
    (bf16 affine) and its autograd backward as the yardsticks. ``ms`` is CUDA
    events around 20 back-to-back calls (host time where it exceeds the
    device's); ``device_ms`` the kernels' own time by the profiler, cold L2."""
    from vjepa2_tpu_torch.ops import layernorm as ln

    firsts = [None, None]
    for name, (R, C) in LN_SHAPES:
        x, dy, gamma, beta = _ln_case(dev, R, C)
        lib_fwd, lib_bwd = ln_yardsticks(x, dy, gamma, beta)
        with torch.no_grad():
            y, mean, rstd = ln.ln_forward(x, gamma, beta)
            grads = ln.ln_backward(x, dy, gamma, mean, rstd)
            y_p, mean_p, rstd_p = ln.ln_forward_f32(x, gamma, beta, 1e-6)
            grads_p = ln.ln_backward_f32(x, dy.float(), gamma, mean_p, rstd_p)
            torch.cuda.synchronize()
            fwd_err = {"y": (y.float() - y_p).abs().max().item(),
                       "mean": (mean - mean_p).abs().max().item(),
                       "rstd_rel": ((rstd - rstd_p).abs() / rstd_p).max().item()}
            ok_fwd = (_within(y, y_p, LN_ATOL, LN_RTOL) and fwd_err["mean"] <= LN_STAT_ATOL
                      and fwd_err["rstd_rel"] <= LN_RSTD_RTOL)
            bwd_err = {"dx": (grads[0].float() - grads_p[0]).abs().max().item(),
                       "dgamma_rel_l2": _rel_l2(grads[1], grads_p[1]),
                       "dbeta_rel_l2": _rel_l2(grads[2], grads_p[2])}
            ok_bwd = (_within(grads[0], grads_p[0], LN_ATOL, LN_RTOL)
                      and bwd_err["dgamma_rel_l2"] <= LN_PARAM_REL_L2
                      and bwd_err["dbeta_rel_l2"] <= LN_PARAM_REL_L2)
            del y_p, grads_p
            run = {"fwd": lambda: ln.ln_forward(x, gamma, beta),
                   "bwd": lambda: ln.ln_backward(x, dy, gamma, mean, rstd)}
            times = {
                "fwd": (cuda_ms(run["fwd"], 20),
                        cuda_ms(lambda: ln.ln_forward_f32(x, gamma, beta, 1e-6)[0].to(x.dtype), 5),
                        cuda_ms(lib_fwd, 20)),
                "bwd": (cuda_ms(run["bwd"], 20),
                        cuda_ms(lambda: ln.ln_backward_f32(x, dy.float(), gamma, mean_p, rstd_p),
                                5),
                        cuda_ms(lib_bwd, 20)),
            }
            dev_times = {part: device_times(fn) for part, fn in run.items()}
            library_dev = {"fwd": device_times(lib_fwd)[0], "bwd": device_times(lib_bwd)[0]}
        del lib_fwd, lib_bwd
        # fp32 work on the CUDA cores, ~8 (forward) and ~13 (backward) operations an element
        bounds = {"fwd": bound(8 * R * C, nbytes(x, gamma, beta, y, mean, rstd), PEAK_FP32),
                  "bwd": bound(13 * R * C, nbytes(x, dy, gamma, mean, rstd, *grads), PEAK_FP32)}
        for i, (kernel, err, ok, tol) in enumerate((
                ("layernorm_fwd", fwd_err, ok_fwd,
                 {"y": f"{LN_ATOL} + {LN_RTOL}*|plain|", "mean": LN_STAT_ATOL,
                  "rstd_rel": LN_RSTD_RTOL}),
                ("layernorm_bwd", bwd_err, ok_bwd,
                 {"dx": f"{LN_ATOL} + {LN_RTOL}*|plain|",
                  "dgamma/dbeta_rel_l2": LN_PARAM_REL_L2}))):
            part = kernel[-3:]
            dev_ms, by_kernel = dev_times[part]
            rec = {"phase": "kernel_ln", "kernel": kernel, "shape": name, "rows": [R, C],
                   "ms": times[part][0], "plain_ms": times[part][1], "library_ms": times[part][2],
                   "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
                   "library_device_ms": library_dev[part],
                   "library": "F.layer_norm (bf16 affine)" + (" backward" if i else ""),
                   "bound_ms": bounds[part][0], "bound_by": bounds[part][1],
                   "bound_share": bounds[part][0] / dev_ms, "errors": err,
                   "max_abs_err": err["y" if i == 0 else "dx"], "tol": tol, "ok": ok, "gpu": smi}
            emit(rec)
            if not ok:
                raise AssertionError(f"{kernel} disagrees with its plain version at {name}")
            firsts[i] = firsts[i] or rec
    return firsts[0], firsts[1]


def _prologue_case(dev, B, N, C, H, D, hidden, tables, real, seqs, kernel):
    """(x, gamma, beta, w, bias, rope) for one B7 or B8 shape: random bf16 x
    with the stack-pad rows zero, a random LayerNorm affine, W scaled by
    1/sqrt(C), a random fp32 bias, the RoPE tables of the shape (B7)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(B, N, C) * 1.5 + 0.2).astype(np.float32))
    if real is not None:
        x[:, real:] = 0.0
    x = x.to(dev, torch.bfloat16)
    gamma = torch.from_numpy((rng.randn(C) * 0.5 + 1).astype(np.float32)).to(dev)
    beta = torch.from_numpy((rng.randn(C) * 0.5).astype(np.float32)).to(dev)
    n_out = 3 * H * D if kernel == "ln_qkv" else hidden
    w = torch.from_numpy((rng.randn(n_out, C) / np.sqrt(C)).astype(np.float32))
    w = w.to(dev, torch.bfloat16)
    bias = torch.from_numpy((rng.randn(n_out) * 0.5).astype(np.float32)).to(dev)
    rope = _rope_tables(dev, B, N, D, tables, seqs) if kernel == "ln_qkv" else None
    return x, gamma, beta, w, bias, rope


def phase_kernels_prologue(dev, smi: str, kernel: str) -> dict:
    """B7 (``kernel="ln_qkv"``) or B8 (``"ln_mlp"``) against its plain
    version; the unfused chain `F.layer_norm` -> `F.linear` -> RoPE or
    `F.gelu` as the yardstick (there is no single PyTorch call for either)."""
    import torch.nn.functional as F

    from vjepa2_tpu_torch.ops import ln_mlp, ln_qkv
    from vjepa2_tpu_torch.ops.rope import rope_rotate

    seqs, first = _mask_seqs(), None
    for name, B, N, C, H, D, hidden, tables, real in PROLOGUE_SHAPES:
        x, gamma, beta, w, bias, rope = _prologue_case(dev, B, N, C, H, D, hidden, tables, real,
                                                       seqs, kernel)
        g16, b16, bias16 = gamma.bfloat16(), beta.bfloat16(), bias.bfloat16()
        if kernel == "ln_qkv":
            run = lambda: ln_qkv.ln_qkv(x, gamma, beta, w, bias, rope, num_heads=H,  # noqa: E731
                                        head_dim=D)
            plain = lambda: ln_qkv.ln_qkv_plain(x, gamma, beta, w, bias, rope,  # noqa: E731
                                                num_heads=H, head_dim=D)
            c, s = rope[0][:, None], rope[1][:, None]

            def chain():
                qkv = F.linear(F.layer_norm(x, (C,), g16, b16, 1e-6), w, bias16)
                q, k, v = qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
                return (rope_rotate(q.float(), c, s).to(x.dtype),
                        rope_rotate(k.float(), c, s).to(x.dtype), v)
            library = "chain: F.layer_norm -> F.linear -> split-half RoPE (fp32)"
        else:
            run = lambda: (ln_mlp.ln_mlp(x, gamma, beta, w, bias),)  # noqa: E731
            plain = lambda: (ln_mlp.ln_mlp_plain(x, gamma, beta, w, bias),)  # noqa: E731
            def chain():
                return F.gelu(F.linear(F.layer_norm(x, (C,), g16, b16, 1e-6), w, bias16))

            library = "chain: F.layer_norm -> F.linear -> F.gelu"
        with torch.no_grad():
            got, want = run(), plain()
            torch.cuda.synchronize()
            errs = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
            ok = all(_within(g, p, PROLOGUE_ATOL, PROLOGUE_RTOL) for g, p in zip(got, want))
            ms = cuda_ms(run, 20)
            plain_ms = cuda_ms(plain, 3)
            library_ms = cuda_ms(chain, 20)
        R, n_out = B * N, w.shape[0]
        # the product on the tensor cores; mean and rstd [R] fp32 are written too
        bound_ms, bound_by = bound(2 * R * C * n_out,
                                   nbytes(x, gamma, beta, w, bias, *(rope or ()), *got) + 8 * R)
        rec = {"phase": f"kernel_{kernel}", "kernel": kernel, "shape": name,
               "bnc": [B, N, C], "out_features": n_out,
               **({"heads": H, "head_dim": D, "tables": tables} if kernel == "ln_qkv" else {}),
               "real_tokens": real, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": library, "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": 2 * R * C * n_out / ms / 1e9, "bound_share": bound_ms / ms,
               "max_abs_err": max(errs),
               "tol": f"{PROLOGUE_ATOL} + {PROLOGUE_RTOL}*|plain|", "ok": ok, "gpu": smi}
        emit(rec)
        if not ok:
            raise AssertionError(f"{kernel} disagrees with its plain version at {name}")
        first = first or rec
        del x, w, got, want
    return first


def phase_encode_giant(dev, smi: str) -> int:
    from vjepa2_tpu_torch.evals.wrappers import encode_clips
    from vjepa2_tpu_torch.models.vision_transformer import vit_giant

    def build(device, dtype, generator=None):
        enc = vit_giant(img_size=(SIZE, SIZE), num_frames=FRAMES, tubelet_size=2, use_rope=True,
                        uniform_power=True, use_flash=True, dtype=dtype, device=device)
        if generator is not None:
            enc.reset_parameters(generator)
        return enc.eval()

    t0 = time.perf_counter()
    enc = build(dev, torch.bfloat16, torch.Generator(device=dev).manual_seed(0))
    rs = np.random.RandomState(1)
    requests = [torch.from_numpy(rs.rand(CLIPS, 1, FRAMES, SIZE, SIZE, 3).astype(np.float32))
                for _ in range(REQUESTS)]
    setup_s = time.perf_counter() - t0
    tokens = (FRAMES // 2) * (SIZE // 16) ** 2

    def answer(clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return encode_clips(enc, clips.to(dev)).cpu()

    answer(requests[0])  # warm-up, outside the counted run
    _reset_launch_counts()
    times, answers = [], []
    for clips in requests:
        before = _launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = answer(clips)
        times.append((time.perf_counter() - t1) * 1e3)
        launched = tuple(a - b for a, b in zip(_launch_counts(), before))
        if launched != (0, 0, len(enc.blocks)) + (0,) * 5:
            raise AssertionError(f"a request launched {dict(zip(KERNEL_COUNTS, launched))}, "
                                 f"want B3 {len(enc.blocks)} times only")
        if feats.shape != (CLIPS, tokens, enc.embed_dim) or not torch.isfinite(feats).all():
            raise AssertionError(f"bad features {tuple(feats.shape)}")
        answers.append(feats)
    launches = _launch_counts()[2]

    on_device = requests[0].to(dev)
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: encode_clips(enc, on_device), iters=3, warmup=1)

    # the same weights in fp32 on the CPU: the wrappers take the plain path there
    torch.set_num_threads(os.cpu_count() or 1)
    t2 = time.perf_counter()
    enc_cpu = build("cpu", torch.float32)
    enc_cpu.load_state_dict(enc.state_dict())
    with torch.inference_mode():
        ref = encode_clips(enc_cpu, requests[0][:1])[0]
    cpu_s = time.perf_counter() - t2
    del enc_cpu
    got = answers[0][0].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    ok = rel <= GIANT_REL_L2
    med = sorted(times)[len(times) // 2]
    emit({"phase": "encode_giant",
          "model": "vit_giant (40 layers, 1408 wide, 16 heads of 88) 16f@256 bf16, RoPE",
          "requests": REQUESTS, "clips_per_request": CLIPS, "warmup_requests": 1,
          "ms_per_request": times, "median_ms_per_request": med,
          "clips_per_s": CLIPS / (med / 1e3), "device_ms_per_request": device_ms,
          "b3_launches": launches, "b3_launches_per_request": len(enc.blocks),
          "features_rel_l2_vs_cpu_fp32": rel, "tol_rel_l2": GIANT_REL_L2,
          "reference_depth": f"full ({len(enc.blocks)} layers)",
          "setup_s": setup_s, "cpu_reference_s": cpu_s, "ok": ok, "gpu": smi})
    if not ok:
        raise AssertionError(f"vit_giant features off the CPU fp32 reference: rel L2 {rel}")
    return launches


def phase_entry(dev, smi: str) -> None:
    """`vjepa2_vit_huge()` and `vjepa2_vit_large()` with no argument build on
    the card in bf16 and run a clip through their flash kernels."""
    from vjepa2_tpu_torch.hub import backbones

    clip = torch.from_numpy(np.random.RandomState(2).rand(1, FRAMES, SIZE, SIZE, 3)
                            .astype(np.float32)).to(dev)
    rec = {"phase": "entry"}
    # (factory, index of its kernel in `_launch_counts`: B3 for Dh 80, B1 for Dh 64)
    for name, slot in (("vjepa2_vit_huge", 2), ("vjepa2_vit_large", 0)):
        torch.manual_seed(0)
        enc = getattr(backbones, name)()
        _reset_launch_counts()
        with torch.inference_mode():
            out = enc(clip)
        launched = _launch_counts()
        want = tuple(len(enc.blocks) if i == slot else 0 for i in range(len(KERNEL_COUNTS)))
        tokens = (FRAMES // 2) * (SIZE // 16) ** 2
        ok = (launched == want and enc.dtype == torch.bfloat16 and out.dtype == torch.bfloat16
              and out.shape == (1, tokens, enc.embed_dim) and bool(torch.isfinite(out.float()).all()))
        rec[name] = {"dtype": str(enc.dtype), "device": str(next(enc.parameters()).device),
                     "layers": len(enc.blocks), "launches": dict(zip(KERNEL_COUNTS, launched)),
                     "ok": ok}
        del enc, out
        if not ok:
            emit(rec)
            raise AssertionError(f"{name}() launched {dict(zip(KERNEL_COUNTS, launched))}, "
                                 f"want {dict(zip(KERNEL_COUNTS, want))}, or gave bad features")
    rec.update(ok=True, gpu=smi)
    emit(rec)


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
    serve_launches = phase_slice(dev, smi)
    rec_bwd = phase_kernels_bwd(dev, smi)
    train_l = phase_train(dev, smi, "vit_large")
    rec_bhnd = phase_kernels_bhnd(dev, smi)
    rec_bhnd_bwd = phase_kernels_bhnd_bwd(dev, smi)
    train_h = phase_train(dev, smi, "vit_huge")
    giant_launches = phase_encode_giant(dev, smi)
    phase_entry(dev, smi)
    rec_ln_fwd, rec_ln_bwd = phase_kernels_ln(dev, smi)
    rec_qkv = phase_kernels_prologue(dev, smi, "ln_qkv")
    rec_mlp = phase_kernels_prologue(dev, smi, "ln_mlp")
    fused_l, unfused_l = phase_train_fused(dev, smi)
    # every main-path run's launches, in the order of KERNEL_COUNTS
    total = [sum(c) for c in zip(train_l, train_h, fused_l, unfused_l)]
    total[0] += serve_launches
    total[2] += giant_launches

    def entry(name, source, replaces, launches, r, err_key, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r[err_key], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["shape"], **extra}

    emit({"kernels": [
        entry("flash_fwd_dn", KERNEL_SOURCE, KERNEL_REPLACES, total[0], rec, "max_abs_err_out"),
        entry("flash_bwd_dn", BWD_SOURCE, BWD_REPLACES, total[1], rec_bwd, "max_abs_err"),
        entry("flash_fwd_bhnd", BHND_SOURCE, BHND_REPLACES, total[2], rec_bhnd,
              "max_abs_err_out"),
        entry("flash_bwd_bhnd", BHND_BWD_SOURCE, BHND_BWD_REPLACES, total[3], rec_bhnd_bwd,
              "max_abs_err"),
        entry("layernorm_fwd", LN_SOURCE, LN_FWD_REPLACES, total[4], rec_ln_fwd, "max_abs_err",
              device_ms=rec_ln_fwd["device_ms"],
              note="off the model paths, as in JAX (layernorm.py:20-26); the forward "
                   "writing mean and rstd only (ln_stats_kernel, ln_common.cuh) is the first "
                   "launch of every ln_qkv and ln_mlp call (192 a fused ViT-L step)"),
        entry("layernorm_bwd", LN_SOURCE, LN_BWD_REPLACES, total[5], rec_ln_bwd, "max_abs_err",
              device_ms=rec_ln_bwd["device_ms"]),
        entry("ln_qkv", LN_GEMM_SOURCE, LN_QKV_REPLACES, total[6], rec_qkv, "max_abs_err",
              library=rec_qkv["library"]),
        entry("ln_mlp", LN_GEMM_SOURCE, LN_MLP_REPLACES, total[7], rec_mlp, "max_abs_err",
              library=rec_mlp["library"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
