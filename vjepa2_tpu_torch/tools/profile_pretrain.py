"""Where the time of the masked-pretrain train step goes, on one CUDA card.

    python -m vjepa2_tpu_torch.tools.profile_pretrain [--model vit_huge] [--fuse-ln qkv,mlp]
        [--steps 2] [--out DIR]

Builds the step of `chip_smoke.py` phase ``train`` (``--model vit_large``,
the default), ``train_huge`` (``--model vit_huge``) or, with ``--fuse-ln
qkv,mlp``, ``train_fused`` (every block's LayerNorms fused into B7 and B8,
as `bench.py --fuse-ln` takes the list): the encoder at
16f@256 bs8, the 12-layer predictor, bf16 with fp32 AdamW, fresh masks each
step. Runs two warm-up steps, then:

* times ``--steps`` steps three ways: host wall clock, the device time
  between CUDA events around each step, and the mask sampling alone;
* traces the same number of steps with `torch.profiler` and sums the device
  time of every kernel into categories (B1, B2, B3, the BHND backward, B6,
  B7, B8, matmul, elementwise, reductions, copies and casts, gathers, optimizer,
  other); a kernel counts only the time no earlier kernel already covers, so
  that a programmatic dependent launch, resident while its primary runs,
  counts its tail.

Prints one JSON object; with ``--out`` it also writes it and the gzipped
Chrome trace there. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gzip
import json
import shutil
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

MASK_CFGS = [
    {"spatial_scale": (0.15, 0.15), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 8},
    {"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 2},
]
FRAMES, SIZE, CLIPS = 16, 256, 8

# first match wins (the BHND names contain B1's prologue name); B7 and B8 are
# one GEMM kernel told apart by its epilogue;
# names are CUDA kernel names as the profiler reports them
CATEGORIES = [
    ("B7 ln_qkv", ("QkvEpilogue",)),
    ("B8 ln_mlp", ("GeluEpilogue",)),
    ("B6 layernorm fwd (B7/B8 statistics)", ("ln_stats_kernel", "ln_fwd_kernel")),
    ("B6 layernorm bwd", ("ln_bwd_kernel", "ln_bwd_sum_kernel")),
    ("B3 flash_fwd_bhnd", ("flash_fwd_bhnd_kernel", "bhnd_rope_pack_kernel")),
    ("B4/B5 flash_bwd_bhnd", ("flash_bwd_bhnd_dkdv_kernel", "flash_bwd_bhnd_dq_kernel",
                              "bhnd_bwd_prologue_kernel")),
    ("B1 flash_fwd_dn", ("flash_fwd_dn_kernel", "rope_pack_kernel")),
    ("B2 flash_bwd_dn", ("flash_bwd_dn_dkdv_kernel", "flash_bwd_dn_dq_kernel",
                         "dn_bwd_prologue_kernel")),
    ("optimizer (AdamW, EMA, grad norm)", ("multi_tensor_apply", "foreach", "fused_adam")),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "nvjet", "ampere_", "splitk", "sm80_xmma")),
    ("reductions", ("reduce_kernel", "Reduce", "norm_kernel")),
    ("gathers and scatters", ("index", "gather", "scatter", "sort", "radix")),
    ("copies and casts", ("copy", "Memcpy", "Memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Loops")),
]


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def build(device, model: str = "vit_large", fuse_ln: str = ""):
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
    from vjepa2_tpu_torch.train import pretrain as tp
    from vjepa2_tpu_torch.train.state import TrainState

    enc, pred = tp.build_models(model, crop_size=SIZE, num_frames=FRAMES, pred_depth=12,
                                pred_embed_dim=384, pred_num_heads=12, use_rope=True,
                                num_mask_tokens=2, use_flash=True, dtype=torch.bfloat16,
                                device=device, fuse_ln=fuse_ln)
    tp.init_params(enc, pred, torch.Generator(device=device).manual_seed(0))
    hp = tp.PretrainHParams(ipe=100, epochs=10)
    state = TrainState.create(enc, pred, tp.make_optimizer(hp, enc, pred))
    train_step = tp.make_train_step(hp)
    coll = MaskCollator(MASK_CFGS, dataset_fpcs=[FRAMES], crop_size=(SIZE, SIZE))
    clips = torch.from_numpy(np.random.RandomState(0).rand(CLIPS, FRAMES, SIZE, SIZE, 3)
                             .astype(np.float32)).to(device, torch.bfloat16)

    def masks():
        coll.step()
        me, mp = coll(FRAMES, CLIPS)
        return ([torch.from_numpy(m).to(device) for m in me],
                [torch.from_numpy(m).to(device) for m in mp])

    def step():
        metrics = train_step(state, clips, *masks())
        return metrics["loss"].item()

    return step, masks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("vit_large", "vit_huge"), default="vit_large")
    ap.add_argument("--fuse-ln", default="", help="comma list drawn from 'qkv','mlp'")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pretrain needs a CUDA device")
    dev = torch.device("cuda", 0)
    step, masks = build(dev, args.model, args.fuse_ln)
    for _ in range(2):
        step()

    wall, device_ms = [], []
    for _ in range(args.steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(args.steps):
        masks()
    mask_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = defaultdict(lambda: [0.0, 0])
    spans = []
    for evt in prof.events():
        # device-side ranges of user annotations (``Optimizer.step#AdamW.step``)
        # span kernels counted on their own
        annotation = (getattr(evt, "is_user_annotation", False)
                      or evt.name.startswith(("Optimizer.", "ProfilerStep#")))
        if evt.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            spans.append((evt.time_range.start, evt.time_range.end, evt.name))
    # each kernel adds to the busy time what earlier kernels do not already
    # cover: a programmatic dependent launch (B6's partial-row sum) is
    # resident, waiting, while its primary runs, and only its tail counts
    covered = float("-inf")
    for start, end, name in sorted(spans):
        kernels[name][0] += max(0.0, end - max(start, covered)) / 1e3 / args.steps
        kernels[name][1] += 1
        covered = max(covered, end)
    cats = defaultdict(float)
    for name, (ms, _) in kernels.items():
        cats[category(name)] += ms
    busy = sum(cats.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    result = {
        "gpu": torch.cuda.get_device_name(0), "model": args.model, "fuse_ln": args.fuse_ln,
        "steps": args.steps,
        "wall_ms_per_step": wall, "device_ms_per_step": device_ms,
        "mask_sampling_ms_per_step": mask_ms, "traced_wall_ms_per_step": traced_ms,
        "kernel_busy_ms_per_step": busy,
        # share of the untraced step's device span (CUDA events) with no kernel running
        "idle_share": 1.0 - busy / (sum(device_ms) / len(device_ms)),
        "categories_ms_per_step": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "kernel_launches_per_step": sum(n for _, n in kernels.values()) / args.steps,
        "top_kernels_ms_per_step": [[n[:120], round(ms, 4), c // args.steps]
                                    for n, (ms, c) in top],
    }
    print(json.dumps(result))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "profile_pretrain.json").write_text(json.dumps(result, indent=1))
        trace = args.out / "profile_pretrain_trace.json"
        prof.export_chrome_trace(str(trace))
        with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        trace.unlink()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
