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
   plain path on the CPU;
5. kernel_bwd — the DN flash backward (B2) against its plain PyTorch version
   at the training shapes, with RoPE tables per example from real collator
   masks: dq, dk and dv, each with its tolerance, both timed;
6. train   — the masked-pretrain train step: ViT-L/16 (RoPE, bf16, fp32
   parameters and AdamW state), the 12-layer predictor (width 384, 12 heads),
   16 frames at 256 px, batch 8, the two mask configs of `bench.py:56-61`
   with fresh masks each step; 1 warm-up and 5 timed steps, each launching
   B1 96 times and B2 72 times; finite loss and gradients, the EMA of the
   target, and clip 0's loss and gradients against the port's fp32 plain path
   on the CPU from the same weights.

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
BWD_SOURCE = "vjepa2_tpu_torch/csrc/flash_bwd_dn.cu"
BWD_REPLACES = "vjepa2_tpu/ops/flash_attention_dn.py:298"

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
B1_PER_STEP, B2_PER_STEP = 96, 72  # 24 target + 2 x (24 + 12); 2 x (24 + 12)
# Clip 0's loss and gradients on the initial weights, bf16 on the card
# against fp32 on the CPU. The port's plain path in bf16 on the CPU, full
# depth and widths at 8f@128, differs from fp32 by 1.2e-2 (encoder) and
# 1.6e-2 (predictor) relative L2 in the gradients and 3e-4 in the loss; the
# kernels add their own roundings (B2: ~5e-3 a call), so about 2e-2 is
# expected: tolerance 5e-2 on each flattened gradient, 1e-2 on the loss.
TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2 = 1e-2, 5e-2


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


def _masks(coll, batch: int):
    """One fresh collator step: (masks_enc, masks_pred) as int32 arrays."""
    coll.step()
    return coll(FRAMES, batch)


def phase_kernels_bwd(dev, smi: str) -> dict:
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    me, mp = _masks(MaskCollator(MASK_CFGS, dataset_fpcs=[FRAMES], crop_size=(SIZE, SIZE)), 8)
    seqs = {f"ctx{i}": np.sort(m, axis=1) for i, m in enumerate(me)}
    seqs.update({f"pred{i}": np.sort(np.concatenate([a, b], axis=1), axis=1)
                 for i, (a, b) in enumerate(zip(me, mp))})
    first = None
    for name, H, D, seq in BWD_SHAPES:
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
        B = 8
        (cos, sin), _ = expand_rope_cache(build_rope_cache(pos, D, 16, 16), D)
        kw["rope_expanded"] = (cos, sin)
        q, k, v, do = (torch.from_numpy(rng.randn(B, H, D, N).astype(np.float32))
                       .to(dev, torch.bfloat16) for _ in range(4))
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
        rec = {"phase": "kernel_bwd", "kernel": "flash_bwd_dn", "shape": name,
               "bhdn": [B, H, D, N], "features": sorted(kw),
               "kv_valid": kw.get("kv_valid_len"), "ms": ms, "plain_ms": plain_ms,
               "errors": errs, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "tol": {"rel_l2": BWD_REL_L2, "max_abs": f"{BWD_MAX_ABS}*max|plain|"},
               "ok": ok, "gpu": smi}
        emit(rec)
        if not ok:
            raise AssertionError(f"flash_bwd_dn disagrees with its plain version at {name}")
        first = first or rec
    return first


def phase_train(dev, smi: str) -> tuple[int, int]:
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.train import pretrain as tp
    from vjepa2_tpu_torch.train.state import TrainState

    def build(device, dtype):
        return tp.build_models("vit_large", crop_size=SIZE, num_frames=FRAMES, pred_depth=12,
                               pred_embed_dim=384, pred_num_heads=12, use_rope=True,
                               num_mask_tokens=2, use_flash=True, dtype=dtype, device=device)

    t0 = time.perf_counter()
    enc, pred = build(dev, torch.bfloat16)
    tp.init_params(enc, pred, torch.Generator(device=dev).manual_seed(0))
    hp = tp.PretrainHParams(ipe=100, epochs=10)  # as `bench.py:bench_pretrain`
    state = TrainState.create(enc, pred, tp.make_optimizer(hp, enc, pred))
    train_step = tp.make_train_step(hp)
    coll = MaskCollator(MASK_CFGS, dataset_fpcs=[FRAMES], crop_size=(SIZE, SIZE))
    clips = torch.from_numpy(np.random.RandomState(0).rand(CLIPS, FRAMES, SIZE, SIZE, 3)
                             .astype(np.float32)).to(dev, torch.bfloat16)
    setup_s = time.perf_counter() - t0

    def step():
        me, mp = _masks(coll, CLIPS)
        to_dev = lambda ms: [torch.from_numpy(m).to(dev) for m in ms]  # noqa: E731
        metrics = train_step(state, clips, to_dev(me), to_dev(mp))
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"non-finite loss {loss} or grad norm {gnorm}")
        return loss, gnorm, metrics["ema_momentum"]

    # clip 0, on the initial weights: loss and gradients on the card, then in
    # fp32 on the CPU through the plain path (after a few Adam steps the
    # encoder's gradient norm falls ~2000x and bf16 noise dominates it)
    me, mp = _masks(coll, CLIPS)
    me0, mp0 = [torch.from_numpy(m[:1]) for m in me], [torch.from_numpy(m[:1]) for m in mp]

    def loss_and_grads(e, p, tgt, x, me_, mp_):
        h = tp.target_features(tgt, x, mp_)
        e.zero_grad(set_to_none=True)
        p.zero_grad(set_to_none=True)
        loss = tp.forward_loss(e, p, x, me_, mp_, h, hp.loss_exp)
        loss.backward()
        flat = [torch.cat([q.grad.float().flatten().cpu() for q in m.parameters()])
                for m in (e, p)]
        return loss.item(), flat

    to_dev = lambda ms: [m.to(dev) for m in ms]  # noqa: E731
    loss_gpu, (ge_gpu, gp_gpu) = loss_and_grads(enc, pred, state.target_encoder, clips[:1],
                                                to_dev(me0), to_dev(mp0))
    torch.set_num_threads(os.cpu_count() or 1)
    t2 = time.perf_counter()
    enc_cpu, pred_cpu = build("cpu", torch.float32)
    tgt_cpu, _ = build("cpu", torch.float32)
    enc_cpu.load_state_dict(enc.state_dict())
    pred_cpu.load_state_dict(pred.state_dict())
    tgt_cpu.load_state_dict(state.target_encoder.state_dict())
    loss_cpu, (ge_cpu, gp_cpu) = loss_and_grads(enc_cpu, pred_cpu, tgt_cpu,
                                                clips[:1].float().cpu(), me0, mp0)
    cpu_s = time.perf_counter() - t2
    del enc_cpu, pred_cpu, tgt_cpu

    # warm-up step, which also checks the EMA on one target leaf
    torch.cuda.reset_peak_memory_stats(dev)
    name = "blocks.0.attn.qkv.weight"
    old = state.target_encoder.get_parameter(name).detach().clone()
    _, _, momentum = step()
    new_online = state.encoder.get_parameter(name).detach()
    want = old * momentum + new_online * (1.0 - momentum)
    ema_err = (state.target_encoder.get_parameter(name) - want).abs().max().item()
    if ema_err > 1e-6 * want.abs().max().item():
        raise AssertionError(f"EMA target off m*old + (1-m)*online by {ema_err}")

    fdn.LAUNCHES = fdn.LAUNCHES_BWD = 0
    times, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        before = (fdn.LAUNCHES, fdn.LAUNCHES_BWD)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, gnorm, _ = step()
        times.append((time.perf_counter() - t1) * 1e3)
        launched = (fdn.LAUNCHES - before[0], fdn.LAUNCHES_BWD - before[1])
        if launched != (B1_PER_STEP, B2_PER_STEP):
            raise AssertionError(f"a step launched B1, B2 {launched} times, want "
                                 f"{(B1_PER_STEP, B2_PER_STEP)}")
        losses.append(loss)
        norms.append(gnorm)
    launches = (fdn.LAUNCHES, fdn.LAUNCHES_BWD)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    named = [(f"encoder.{k}", p) for k, p in enc.named_parameters()]
    named += [(f"predictor.{k}", p) for k, p in pred.named_parameters()]
    bad = [k for k, p in named if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad:
        raise AssertionError(f"parameters without a finite gradient: {bad[:5]}")

    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    enc_rel = ((ge_gpu - ge_cpu).norm() / ge_cpu.norm()).item()
    pred_rel = ((gp_gpu - gp_cpu).norm() / gp_cpu.norm()).item()
    ok = loss_rel <= TRAIN_LOSS_REL and enc_rel <= TRAIN_GRAD_REL_L2 \
        and pred_rel <= TRAIN_GRAD_REL_L2
    med = sorted(times)[len(times) // 2]
    emit({"phase": "train",
          "model": "vit_large 16f@256 bs8 + predictor (12 x 384, 12 heads) bf16, AdamW fp32",
          "mask_lengths": {"ctx": [m.shape[1] for m in me], "pred": [m.shape[1] for m in mp]},
          "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS, "ms_per_step": times,
          "median_ms_per_step": med, "clips_per_s": CLIPS / (med / 1e3),
          "peak_memory_gb": peak_gb, "losses": losses, "grad_norms": norms,
          "b1_launches": launches[0], "b2_launches": launches[1],
          "b1_per_step": B1_PER_STEP, "b2_per_step": B2_PER_STEP,
          "ema_max_abs_err": ema_err, "ema_leaf": name,
          "clip0": {"loss_gpu": loss_gpu, "loss_cpu_fp32": loss_cpu, "loss_rel_err": loss_rel,
                    "encoder_grad_rel_l2": enc_rel, "predictor_grad_rel_l2": pred_rel,
                    "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel_l2": TRAIN_GRAD_REL_L2},
                    "depth": "full (24 + 12 layers)"},
          "setup_s": setup_s, "cpu_reference_s": cpu_s, "ok": ok, "gpu": smi})
    if not ok:
        raise AssertionError(f"clip-0 loss or gradients off the CPU fp32 reference: loss "
                             f"{loss_rel}, encoder {enc_rel}, predictor {pred_rel}")
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
    serve_launches = phase_slice(dev, smi)
    rec_bwd = phase_kernels_bwd(dev, smi)
    train_b1, train_b2 = phase_train(dev, smi)
    emit({"kernels": [
        {"name": "flash_fwd_dn", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": serve_launches + train_b1,
         "max_abs_err": rec["max_abs_err_out"], "ms": rec["ms"], "plain_ms": rec["plain_ms"]},
        {"name": "flash_bwd_dn", "route": "cuda", "source": BWD_SOURCE,
         "replaces": BWD_REPLACES, "launches": train_b2, "max_abs_err": rec_bwd["max_abs_err"],
         "ms": rec_bwd["ms"], "plain_ms": rec_bwd["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
