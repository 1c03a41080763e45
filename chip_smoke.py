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
   (depth 4, 16 heads, 174 classes; fp32 on the flash route, as the evals'
   probes), random weights from a seeded generator, answering 3 requests of
   8 clips; every request must launch B1 once per encoder layer and B1 at
   fp32 once per probe self-attention block (3: the probe's heads of 64 take
   the DN route), and the logits of one clip must match the port's fp32
   plain path on the CPU;
5. kernel_bwd — the DN flash backward (B2, wgmma and TMA) against its plain
   PyTorch version at the training shapes, with RoPE tables per example from
   real collator masks: dq, dk and dv, each with its tolerance, both timed,
   with the achieved TFLOP/s (10*Dh FLOPs a score) and the share of the
   bound;
6. train   — the masked-pretrain train step: ViT-L/16 (RoPE, bf16, fp32
   parameters and AdamW state), the 12-layer predictor (width 384, 12 heads),
   16 frames at 256 px, batch 8, the two mask configs of `bench.py:56-61`
   with fresh masks each step; 1 warm-up and 3 timed steps, each launching
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
   layers, width 1280, 16 heads of 80): 1 + 3 steps, each launching B3 96
   times, the BHND backward 64, B1 24 and B2 24 times; the same checks (its
   clip-0 CPU reference runs on the worker thread once the run reaches phase
   26, and its record prints when that ends);
10. encode_giant — the 16-head ViT-g (40 layers, width 1408, heads of 88,
   `bench.py:369`'s headline encoder) answering 3 requests of 8 clips at
   16f@256, 40 B3 launches each, one clip's features against the fp32 CPU
   path;
11. entry  — the hub factories `vjepa2_vit_huge()` and `vjepa2_vit_large()`
   called with no argument, as a user calls them: the (encoder, predictor)
   pair on the card in bf16, one clip through the encoder, one B3 (ViT-H) or
   B1 (ViT-L) launch per layer, then 578 of its tokens through the predictor
   to 1045 targets, one B1 launch per predictor layer (Dh 32);
12. kernel_ln — the LayerNorm kernels (B6 forward and backward) against
   their plain versions at [16384, 1024], [13312, 384], [16384, 1280] and
   [16384, 1408] rows and at the fused step's other backward rows, [4672,
   1024], [1408, 1024] and [12992, 384]: y, mean and rstd; dx, dgamma and
   dbeta; each timed by CUDA events around back-to-back calls (``ms``) and by
   the profiler with a cold L2 (``device_ms``, and its share of the bound),
   beside the yardsticks' device time; then kernel_ln_fp32, the same rows
   on fp32 operands (the `_f32` kernels of the same source) at fp32's
   tolerances, `F.layer_norm` at fp32 beside them;
13. kernel_ln_qkv / kernel_ln_mlp — the fused LayerNorm prologues (B7: LN +
   qkv + RoPE; B8: LN + fc1 + GELU; one wgmma and TMA mainloop) against their
   plain versions at the fused step's shapes (ViT-L target and contexts, the
   predictor) and at ViT-H and the 16-head ViT-g widths, [8, 2048] rows,
   with TFLOP/s and the share of the bound; then kernel_ln_qkv_fp32 /
   kernel_ln_mlp_fp32, the same shapes on fp32 operands
   (`csrc/ln_gemm_fp32.cu`: 3xTF32 on wgmma after a split of W) against the
   plain versions at the fp32 flash kernels' tolerances, the chain at fp32
   (TF32 off) beside them, the bound at 495/3 TFLOP/s;
14. train_fused — the ViT-L step of phase 6 with ``fuse_ln="qkv,mlp"``
   (`bench.py --fuse-ln qkv,mlp`): every block's LayerNorms fused into B7
   and B8, attention on the BHND kernels; 1 + 3 steps, each launching B7 96,
   B8 96, B3 96, the BHND backward 72, the B6 backward 144 and B1/B2 0
   times; the checks of phase 6 against the fp32 CPU path with the same
   fusions; and, interleaved step by step in the same phase, the unfused
   step of phase 6 beside it (the A/B; nothing is claimed from it); then
   train_fused_fp32, the same fused step at fp32 (TF32 off; JAX's
   `bench.py --fuse-ln qkv,mlp` step at its default precision): 1 warm-up
   and 3 timed steps, each launching B7 and B8 at fp32 96 times, B3 at fp32
   96, the BHND fp32 backward 72 and the B6 fp32 backward 144, and B1/B2
   and every bf16 kernel 0 times; finite loss and gradients, the EMA, and
   clip 0's loss and gradients on train_fused's weights, clip and masks
   against train_fused's fp32 CPU result (computed once for both phases)
   within phase 25's fp32 tolerances; its ms a step beside phase 25's
   unfused fp32 step (nothing is claimed from it);
15. train_loop — the pretraining loop: `vjepa2_tpu_torch.cli.main`'s
   `run_vjepa` (the `Pretrainer`: prefetch to the card, CSV log, rolling
   checkpoint) on the shipped ViT-H config (`LOOP_CONFIG`, equal to
   `configs/train/vith16/pretrain-256px-16f.yaml`: vit_huge, batch 16,
   16f@256, full remat, bf16, synthetic clips), overriding only the run
   folder, ``optimization.ipe`` (3) and the epochs (1; the resumed epoch 1
   and its checks moved to phase 29 in PR 20), as printed. Every step
   launches B3 160, the BHND backward 64, B1 48 and B2 24 times; finite
   losses; the CSV holds 3 rows. Prints the loop's ms a step as it runs (no
   added sync: from its second step to its checkpoint save), clips/s, peak
   memory, the checkpoint's bytes and save seconds, and the wall,
   device-busy time and idle share of one more step, all three from one
   traced call;
16. train_accum — `run_vjepa` on the shipped ViT-L 64-frame cooldown
   (`ACCUM_CONFIG`: batch 12 as 6 microbatches of 2, save_attn_qkv_h),
   overriding ``mesh.model`` 4 -> 1 (one card), the folder, ipe (2) and
   the epochs: 1 warm-up and 1 timed step, each launching B1 576 and B2
   432 times; then, on one microbatch of 2 clips, the loss and gradients
   under save_attn_qkv_h against no remat on the card, bit-equal (the
   recompute runs the same kernels on the same inputs, and no kernel on the
   path adds in a varying order), and the microbatch under no remat, full,
   save_attn, save_attn_qkv and save_attn_qkv_h: peak memory, and the wall,
   device-busy time and idle share of one traced call each; the loop's ms a
   step as in phase 15, and one more step traced;
17. train_droid — V-JEPA 2-AC post-training: `cli.main`'s `run_vjepa_droid`
   (the `DroidTrainer`) on the shipped ViT-g DROID config (`DROID_CONFIG`:
   batch 8, 8 frames at 256 px, the frozen ViT-g target at depth 40, the AC
   predictor at depth 24, auto_steps 2, bf16, synthetic trajectories),
   overriding the folder, ipe (4) and the epochs: epoch 0, then a resumed
   epoch 1. Every step launches B1 88 times (40 target, 24 teacher forcing,
   24 rollout) and B2 48; before the first step, trajectory 0's loss and
   predictor gradients on the initial weights (phase 26's parameters, bit
   for bit) against the fp32 CPU path (the tolerances of phase 6; the CPU
   trajectory runs on a worker thread beside the later phases, and serves
   phase 26 too); the restored state bit-equal to the saved
   one, the resumed first step at step 4 with the schedules' lr and weight
   decay there, the target bit-equal before and after the steps, 8 CSV
   rows; the loop's ms a step, clips/s, peak memory, the checkpoints, and
   one more step traced, as in phase 15;
18. plan   — latent planning: the hub's `vjepa2_ac_vit_giant()` called with
   no argument (the 22-head ViT-g and the 24 x 1024 AC predictor on the
   card in bf16) in a `planning.WorldModel`: a start and a goal frame
   encoded (256 px, 40 B1 launches each), then 1 warm-up and 1 timed CEM
   plan at `CEMConfig()` (400 samples, rollout 2, 10 steps, top-k 10: 480
   B1 launches each at [400, 16, 64, 264] and [400, 16, 64, 520]), one more
   plan traced; the plans finite, [2, 7], within the CEM's clips, a repeat
   with the same seed bit-equal; encode and step_fn (4 candidates at 1 and
   2 frames) against the fp32 CPU path (on the worker thread; the CPU world
   model serves phase 27 too), and the CEM update on a linear world model on
   the card against the CPU's. Prints ms per encode and per plan, peak
   memory, and the traced plan's wall, device-busy time and idle share;
19. eval_video — the frozen SSv2 probe eval: `cli.eval.run_video_classification`
   on the shipped ViT-L config (`EVAL_VIDEO_CONFIG`, equal to
   `configs/eval/vitl/ssv2.yaml`: 2 segments x batch 4 of 16f@256 clips, the
   encoder in bf16 into features [4, 4096, 1024], 10 fp32 probes of depth 4
   with 16 heads trained one at a time), overriding ipe (2), the epochs (1)
   and ``dataset_train`` / ``dataset_val`` (phase 28's 72- and 4-row
   manifests: clips read from disk through the port's `VideoDataset` and
   spawned loader workers), as printed: 2 train steps and 1 val batch,
   each launching B1 24 times and B1 at fp32 30 times (3 blocks x 10
   probes, heads of 64: the DN route; and B2 at fp32 30 times a train
   step), nothing else;
   finite losses; a probe save
   and restore bit-equal; example 0's features and probe 0's logits on them
   against the fp32 CPU path end to end, every probe's logits and loss and
   probe 0's gradients on the card's features of example 0 against the CPU's,
   and on the card the step's losses and gradients against the same
   recomputed (`_eval_cpu_checks`). Prints ms a train step and val batch
   (host; encode and probes apart by CUDA events), the probe chunk, peak
   memory, one more traced step's wall, device-busy time, idle share and
   kernel time by category, and each probe's top-1 (a smoke signal on
   random weights);
20. eval_anticipation — the EK100 anticipation eval: `run_action_anticipation`
   on the shipped ViT-L config (`EVAL_ANTICIPATION_CONFIG`: batch 16, the
   encoder and the 12 x 384 predictor in bf16, the predictor's 256 targets 1 s
   ahead, features [16, 2304, 1024], 10 fp32 three-head probes of depth 1),
   the same overrides, checks and prints, each step and val batch launching
   B1 36 times (24 encoder, 12 predictor with per-example RoPE tables), and
   each probe's recall per head;
21. kernel_fp32 (run after phase 8) — the fp32 BHND flash kernels
   (`csrc/flash_fp32.cuh`: B3 and B4/B5 on fp32 operands, 3xTF32 on wgmma
   after a split pre-pass that also rotates q and k; the masks on the
   scores)
   against their plain versions at the probes' shapes [64,16,2048,64]
   (IN1K), [4,16,4096,64] (SSv2), [8,16,2048,64] (the serving slice) and
   [1,16,36864,88] (ViT-g/384 K400), and at the fp32 ViT-L step's: the
   target [8,16,2048,64] with shared RoPE, the contexts [8,16,584,64]
   (kv_valid 578) and [8,16,176,64] (173) and the predictor [8,12,1664,32]
   (1662) and [8,12,1624,32] (1623) on per-example tables of real collator
   masks, and with the masks: the fp32 DROID step's AC rows
   [8,16,1808,64] and the fp32 plan's [400,16,264,64] and [400,16,520,64]
   (forward only), frame-causal with the pad keys on int32-max, a ring hop
   [2,16,1024,80] (key-side ids, a global lse given to the backward), the
   causal mask [2,16,1024,80], ids 2**24 and 2**24 + 1 (which must stay
   apart) and rows with no key (out 0, lse -inf, dq 0) at [2,16,1024,64];
   forward (out, lse) and backward (dq,
   dk, dv given the kernel's out and lse; dk and dv exactly zero past
   kv_valid), the plain version over chunks of
   queries where its [B, H, N, N] scores do not fit (256 rows at IN1K, 512
   at K400: dk and dv summed over the chunks); ms by CUDA events, TFLOP/s
   (4*Dh and 10*Dh FLOPs a score the masks leave), the bound at 495/3 = 165
   TFLOP/s (an fp32-accurate product is three TF32 products) or the bytes',
   whichever is larger, the plain
   version's ms and `F.scaled_dot_product_attention`'s on the same fp32
   operands (q and k pre-rotated, k and v cut to kv_valid, segment ids as
   the equivalent boolean mask) with the backend it picked; then B1 and B2
   on fp32 operands (the same kernels on the DN layout [B, H, D, N]: the
   split pre-pass reads it in place, the epilogues store D-major) against
   their plain versions at the same tolerances, at `FP32_DN_SHAPES`: the
   fp32 ViT-L step's target [8,16,64,2048] (shared RoPE, forward), a context
   [8,16,64,584] (kv_valid 578) and a predictor [8,12,32,1664] (1662) on
   per-example tables, the DROID AC rows [8,16,64,1808] (frame-causal, pad
   keys on int32-max), the DROID target's frames [64,22,64,256] (forward),
   the CEM's [400,16,64,264|520] (forward), and heads of 16 and 48; each
   row also runs the BHND fp32 kernels on the same data transposed (their
   ms, and whether their bits are the DN call's);
25. train_fp32 (run after phase 21) — the fp32 pretraining path: (a) the
   shipped `configs/train/smoke-tiny.yaml` (`SMOKE_CONFIG`: vit_tiny, a
   depth-2 predictor, heads of 64, RoPE, fp32, batch 4 of 4f@64, ipe 8)
   through `cli.main`'s `run_vjepa` on the card, overriding only the run
   folder and ``meta.load_checkpoint`` (the resume reads epoch 0's
   checkpoint): epoch 0, then a resumed epoch 1; every step launches B1 at
   fp32 40 times and B2 at fp32 28 (`SMOKE_LAUNCHES`: heads of 64 take the
   DN route, as in JAX) and no bf16 attention kernel and no BHND one
   (`fp32_route`); finite losses, the restored state bit-equal to the
   saved one, 16 CSV rows, and the first 3 losses against the same config
   and seed on the CPU from the card's initial weights (`SMOKE_LOSS_RTOL`);
   (b) phase 6's ViT-L step at fp32 (the model of
   `configs/train/vitl16/pretrain-256px-16f.yaml` with meta.dtype float32,
   TF32 off): 1 warm-up and 3 timed steps, each launching B1 at fp32 96
   times and B2 at fp32 72 (the BHND kernels none); clip 0's loss and
   gradients against phase 6's fp32 CPU path on the same weights, clip and
   masks, to tolerances phase 6's bf16 step misses (checked in the run); ms
   a step, clips/s, peak memory, one more step traced (wall, device-busy
   time, idle share);
22. eval_image — the IN1K probe eval: `run_image_classification` on the
   shipped ViT-L config (`EVAL_IMAGE_CONFIG`: 64 images a batch as 16 fake
   frames, features [64, 2048, 1024], 6 fp32 probes of depth 4), ipe 2 and
   1 epoch: each train step launches B1 24 times and B1 and B2 at fp32 18
   times each, a val batch B1 24 and B1 at fp32 18; the checks
   of phase 19 with the CPU's share cut to the first 4 examples, but the
   probe save and restore (phase 19's code; cut in PR 20 for time);
23. eval_video_384 — the ViT-g/384 K400 probe eval: `run_video_classification`
   on the shipped config (`EVAL_VIDEO_384_CONFIG`: batch 1 of 8 segments of
   16f@384, the 22-head ViT-g into features [1, 36864, 1408], 10 fp32
   probes of depth 4 with 16 heads of 88), ipe 1 and 1 epoch: each train
   step launches B1 40 times at [8,22,64,4608] and the fp32 forward and
   backward 30 times each at [1,16,36864,88], a val batch B1 40 and the
   forward 30; finite losses (the probe save and restore is phase 19's
   code: cut here in PR 20 for time), and,
   forward only against fp32 on the plain route on the card (the host's
   CPU cannot hold a 36,864-token probe or a 384-px ViT-g clip in the
   script's time): segment 0's features and probe 0's logits (the plain
   forward over 512-query chunks), the step's losses and probe 0's
   gradients recomputed;
24. export (run after phase 18) — the serving export (`hub.export`). A
   child process started right after the build exports, beside the phases
   before this one (the traces are host work on one core):
   `vjepa2_vit_large(num_frames=16)` and `vjepa2_vit_huge(num_frames=16)`
   with a symbolic batch (`torch.export`, the weights in the program), and
   `vjepa2_ac_vit_giant()` in a `WorldModel` with the hub preprocessor at
   `CEMConfig()` as its encode and plan programs (the CEM steps one
   while_loop). Then a fresh process that loads the ViT-L program and
   imports no `vjepa2_tpu_torch.models` module answers requests of 1 and 8
   clips at 16f@256 (24 B1 each), and the program loaded here is timed
   against the eager encoder, 5 repeats interleaved; ViT-H answers one clip
   (32 B3); the world model, loaded as a `ServingWorldModel`, two encodes of
   480 x 640 uint8 frames (40 B1 each) and one plan at seed 0 (480 B1), each
   beside eager's (every eager copy built as the child built it). Every answer must equal
   eager's (`torch.equal`; where they part, the record says where and holds
   the answer within 5e-2 relative L2 of the fp32 CPU path, and the plan to
   [2, 7], finite, in the CEM's clips). Prints trace, save and load seconds,
   artifact bytes, and ms per request, encode and plan, loaded and eager.
26. train_droid_fp32 (run before phase 17) — the DROID trainer at JAX's
   default precision: `run_vjepa_droid` on `DROID_CONFIG` with
   ``meta.dtype: float32`` (TF32 off), one epoch of 4 steps (phase 17 covers
   the resume): every step launches B1 at fp32 88 times and B2 at fp32 48,
   no bf16 attention kernel and no BHND one; trajectory 0's loss and predictor
   gradients on the initial weights, no op of it making a bf16 tensor,
   against phase 17's fp32 CPU trajectory (the same weights) within phase
   25's fp32 tolerances; ms a step, clips/s, peak, one traced step;
27. plan_fp32 (run after phase 18) — `vjepa2_ac_vit_giant(dtype=
   torch.float32)` after `torch.manual_seed(0)` (phase 18's weights, bit for
   bit) in a `WorldModel`: two encodes (40 B1 launches at fp32 each), a warm-up
   plan at 1 CEM step (both rollout lengths), one timed plan at
   `CEMConfig()` but for 3 of its 10 CEM steps (144 B1 launches at fp32 at
   [400,16,64,264] and [400,16,64,520] with frame-causal ids, no bf16
   kernel and no BHND one; cut to keep the script within its time limit), the warm-up's
   repeat traced and bit-equal; no op of an encode or a step_fn makes a bf16 tensor; encode
   and step_fn against phase 18's fp32 CPU world model within 1e-4
   relative L2; ms per encode and plan, peak, the traced plan's idle share
   and kernel time by category;
28. disk_data (on a thread from the build on) — the card host's decoders
   (cv2, imageio, the libav headers of the native decoder; the port's
   `data.video.available_backends`), then 8 source videos of 300 frames at
   256 x 340: mp4 files written with cv2 where cv2 is present (each read
   back through the port's `VideoReader`, its length, fps and frames
   checked), else uint8 `.npy` arrays read by `NpyVideoDataset`, a reader
   double defined here and no part of the package; a 72-row manifest (each
   video 9 times), a 192-row one and a 4-row one. Prints ``{"decoder":
   ...}`` on a line of its own;
29. train_disk (last) — `run_vjepa` on
   the shipped ViT-L config (`TRAIN_DISK_CONFIG`, equal to
   `configs/train/vitl16/pretrain-256px-16f.yaml`: batch 24, 16f@256, fps
   4, 8 spawned loader workers, full remat, bf16) with ``data.datasets`` the
   72-row manifest, overriding the folder, ipe (3) and the epochs (2):
   epoch 0, then a new trainer resumes and runs epoch 1. Every step
   launches B1 168 (96 forwards, 72 recomputed) and B2 72 times; finite
   losses; the restored state bit-equal to the saved one, the resumed
   first step (step 3) with the schedules' lr, weight decay and EMA
   momentum there and the masks of an uninterrupted run, 6 CSV rows; each
   epoch's sample indices equal to the sampler's for that epoch (an
   uninterrupted run's), epoch 1's order not epoch 0's. Prints the loop's
   ms a step from disk beside the same trainer's epoch 2 on synthetic
   clips (no checkpoint written), the loader alone over 5 of the 192-row
   manifest's 8 batches (seconds to the first batch, clips/s), then two
   traced steps from disk on the same loader (wall, device-busy, idle
   share, the wait for each batch), peak memory and the decoder.
Phases 19, 20, 22 and 23 run in the order eval_anticipation, eval_video,
eval_image, eval_video_384; each eval phase's CPU reference, like those of
phases 4, 6, 9, 10, 14, 17, 18, 26 and 27, runs on a worker thread beside
the card work of the phases after it (phase 6's beside the kernel phases,
and train_fp32 waits for it; phases 9's and 14's from train_droid_fp32 on),
and its record prints when that reference ends; the script waits for all
of them before its summary.
The kernel phases 3 and 5 also hold B1 and B2 at the cooldown's shapes
([2,16,64,8192] target, the contexts of 2302 and 568 tokens, the predictor
sequences of 6479 and 6471), with per-example RoPE tables of real collator
masks, and at the DROID step's: B1 over the ViT-g target's single frames
[64,22,64,256], B1 and B2 over the AC sequences (1806 and 516 tokens,
frame-causal) as they come and stack-padded to 1808 and 520 with the pad
keys on segment int32-max, as the AC predictor runs them; phase 3 also
at a CEM plan's [400, 16, 64, 264] and [400, 16, 64, 520], at the EK100
eval's [16, 16, 64, 2048] and [16, 12, 32, 2304] (per-example tables), and
at the ViT-g/384 encoder's [8, 22, 64, 4608] (a RoPE grid of 8 x 24 x 24). A ``seconds``
line gives each phase's time and the script's total.

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

import concurrent.futures
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

try:  # the base of the `.npy` reader double (`NpyVideoDataset`)
    from vjepa2_tpu_torch.data.video_dataset import VideoDataset as _VideoDataset
except ImportError:  # chip_smoke.py alone: `main` stops before any phase
    _VideoDataset = object

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
LN_GEMM_FP32_SOURCE = "vjepa2_tpu_torch/csrc/ln_gemm_fp32.cu"  # B7 and B8 on fp32 operands
# B3, and B4/B5, on fp32 operands: 3xTF32 on wgmma (`flash_fp32.cuh`), after the
# split pre-pass (`flash_fp32_split.cu`); the backward is dQ, then dK/dV (`_dkdv.cu`)
FP32_FWD_SOURCE = "vjepa2_tpu_torch/csrc/flash_fp32_fwd.cu"
FP32_BWD_SOURCE = "vjepa2_tpu_torch/csrc/flash_fp32_dq.cu"
FP32_FWD_REPLACES = "vjepa2_tpu/ops/flash_attention.py:166"
# B4 (one pass) and B5 (`_dq_kernel:361`, `_dkv_kernel:434`): one fp32 backward
FP32_BWD_REPLACES = "vjepa2_tpu/ops/flash_attention.py:511"
LN_QKV_REPLACES = "vjepa2_tpu/ops/ln_qkv.py:50"
LN_MLP_REPLACES = "vjepa2_tpu/ops/ln_mlp.py:78"

# H100 SXM dense bf16 peak and memory rate (NVIDIA's data sheet), for bounds
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_FP32 = 67e12  # fp32 outside the tensor cores (the LayerNorm kernels' arithmetic)
# fp32-accurate products on the tensor cores: three TF32 products each (495 TFLOP/s
# TF32 dense): the fp32 attention kernels' bound, whatever implements them
PEAK_3XTF32 = 495e12 / 3

# (name, [B, H, D, N], features) — the shapes B1 takes on the main paths;
# the cooldown's (phase train_accum, one microbatch of 2 clips at 64f) take
# per-example tables of real collator masks ("seq", `_cooldown_seqs`), N
# stack-padded to a multiple of 8 with the real length as kv_valid
SHAPES = [
    ("vit_large encoder", (8, 16, 64, 2048), {}),
    ("pretrain predictor", (8, 12, 32, 1664), {"kv_valid_len": 1623}),
    ("ac predictor", (8, 16, 64, 1806), {"segments": 7}),
    # the DROID step (phase train_droid): the ViT-g target over single frames,
    # and the AC predictor's teacher forcing (7 frames of 2 + 256 tokens) and
    # rollout (2 frames), each also stack-padded to a multiple of 8 with the
    # pad keys on segment int32-max, as the model runs them
    ("ac encoder frames", (64, 22, 64, 256), {}),
    ("ac predictor, stack-padded", (8, 16, 64, 1808), {"segments": 7, "pad": 2}),
    ("ac rollout", (8, 16, 64, 516), {"segments": 2}),
    ("ac rollout, stack-padded", (8, 16, 64, 520), {"segments": 2, "pad": 4}),
    ("vit_giant_xformers encoder", (2, 22, 64, 2048), {}),
    ("cooldown target", (2, 16, 64, 8192), {}),
    ("cooldown context, mask 0", (2, 16, 64, 2304), {"seq": "cool_ctx0"}),
    ("cooldown context, mask 1", (2, 16, 64, 568), {"seq": "cool_ctx1"}),
    ("cooldown predictor, mask 0", (2, 12, 32, 6480), {"seq": "cool_pred0"}),
    ("cooldown predictor, mask 1", (2, 12, 32, 6472), {"seq": "cool_pred1"}),
    # a CEM plan (phase plan): 400 candidates of 1 and 2 frames of 2 + 256
    # tokens, stack-padded to 264 and 520 with the pad keys on int32-max
    ("cem rollout, 1 frame", (400, 16, 64, 264), {"segments": 1, "pad": 6}),
    ("cem rollout, 2 frames", (400, 16, 64, 520), {"segments": 2, "pad": 4}),
    # the EK100 eval (phase eval_anticipation): the encoder over 16 clips, and
    # the predictor over the clip's 2048 tokens plus 256 targets at positions
    # 2560-2815 (1 s ahead at 4 fps), RoPE tables per example
    ("ek100 encoder", (16, 16, 64, 2048), {}),
    ("ek100 predictor, per-example tables", (16, 12, 32, 2304), {"seq": "ek100_pred"}),
    # the ViT-g/384 K400 eval (phase eval_video_384): the 22-head encoder over
    # 8 clips of 16f@384, a RoPE grid of 8 x 24 x 24
    ("vit_giant_xformers/384 encoder", (8, 22, 64, 4608), {"grid": (24, 24)}),
]
# operands above this many elements (the plan's 108 M and 213 M) are drawn on
# the card: numpy takes seconds for each
DEVICE_RNG_ELEMENTS = 1 << 26
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
    ("ac predictor, stack-padded", 16, 64, "ac_pad"),
    ("ac rollout", 16, 64, "ac_rollout"),
    ("ac rollout, stack-padded", 16, 64, "ac_rollout_pad"),
    ("cooldown context, mask 0", 16, 64, "cool_ctx0"),
    ("cooldown context, mask 1", 16, 64, "cool_ctx1"),
    ("cooldown predictor, mask 0", 12, 32, "cool_pred0"),
    ("cooldown predictor, mask 1", 12, 32, "cool_pred1"),
]
# B2 against plain: both from the same bf16 inputs, plain in fp32. The kernels
# round at 2**-9 relative where plain does not: q_s and k_rot, q_u, p before
# dV, ds before dK and dQ, out before delta, and the gradients; about five
# independent roundings meet in each entry, so a relative L2 error near
# 5e-3 is expected: tolerance 2e-2, and max abs 3e-2 x max|plain| for the
# largest entries.
BWD_REL_L2, BWD_MAX_ABS = 2e-2, 3e-2
TRAIN_STEPS, TRAIN_WARMUP = 3, 1  # cut from 5 to keep the script within its time limit
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
# the AC sequences of `BWD_SHAPES`: (frames of 2 + 256 tokens, stack pad)
AC_SEQUENCES = {"ac": (7, 0), "ac_pad": (7, 2), "ac_rollout": (2, 0), "ac_rollout_pad": (2, 4)}
# launch counters, in the order `_launch_counts` reads them (the fp32 calls
# of the BHND and DN wrappers, both on `csrc/flash_fp32.cuh`, count apart, as
# do B6's, B7's and B8's fp32 calls)
KERNEL_COUNTS = ("b1", "b2", "b3", "bhnd_bwd", "b6_fwd", "b6_bwd", "b7", "b8", "b3_fp32",
                 "bhnd_bwd_fp32", "b1_fp32", "b2_fp32", "b6_fwd_fp32", "b6_bwd_fp32", "b7_fp32",
                 "b8_fp32")


def _counts(**launches) -> tuple[int, ...]:
    """Launches by KERNEL_COUNTS name, the others 0, in that order."""
    unknown = set(launches) - set(KERNEL_COUNTS)
    if unknown:
        raise KeyError(f"no launch counter {sorted(unknown)}")
    return tuple(launches.get(name, 0) for name in KERNEL_COUNTS)


# the step of phase 6 per (encoder, fusions): (phase, launches per step in
# the order of KERNEL_COUNTS). ViT-L: 24 target + 2 x (24 + 12) B1; ViT-H: 32
# target + 2 x 32 context B3, 2 x 12 predictor B1; fused ViT-L: B7, B8 and B3
# in all 96 blocks, the backwards in the 72 with gradients, B6's backward
# twice in each (B7's and B8's LayerNorm tail).
TRAIN_CFGS = {
    ("vit_large", ""): ("train", _counts(b1=96, b2=72)),
    ("vit_huge", ""): ("train_huge", _counts(b1=24, b2=24, b3=96, bhnd_bwd=64)),
    ("vit_large", "qkv,mlp"): ("train_fused", _counts(b3=96, bhnd_bwd=72, b6_bwd=144, b7=96,
                                                      b8=96)),
}
# The same ViT-L steps at fp32 (phases train_fp32 and train_fused_fp32), per
# fusions: unfused, every attention on the DN route, as in JAX, through B1
# and B2 at fp32 (the BHND fp32 kernels none); fused, B7 and B8 at fp32 in
# all 96 blocks, the BHND fp32 kernels rope-free, B6's fp32 backward twice
# in each of the 72 blocks with gradients, and no bf16 kernel
FP32_STEPS = {
    ("vit_large", ""): ("train_fp32", _counts(b1_fp32=96, b2_fp32=72)),
    ("vit_large", "qkv,mlp"): ("train_fused_fp32", _counts(b3_fp32=96, bhnd_bwd_fp32=72,
                                                           b6_bwd_fp32=144, b7_fp32=96,
                                                           b8_fp32=96)),
}
# Clip 0's loss and gradients of the fp32 step on the card against the fp32
# CPU path of phase 6 (the same weights, clip and masks): fp32 on both
# sides, the GEMMs in another summation order (cuBLAS, TF32 off), the
# attention's products 3xTF32 (within 2e-5 of plain, phase kernel_fp32),
# over 24 + 12 layers forward and back. Measured on an H100: 6.9e-8 on the
# loss, 4.8e-5 and 5.0e-5 relative L2 on the encoder's and the predictor's
# gradients (the summation orders' differences compound through the
# backward). Tolerances 1e-5 on the loss and 1e-3 on each flattened
# gradient; phase 6's bf16 step (1.1e-4 and 1.3e-2 there) misses both by
# an order of magnitude, which the phase checks.
FP32_TRAIN_LOSS_REL, FP32_TRAIN_GRAD_REL_L2 = 1e-5, 1e-3
# The shipped smoke config (phase train_fp32): vit_tiny (12 x 192, heads of
# 64) and a 2 x 192 predictor (heads of 64), RoPE, fp32, 4 frames at 64 px,
# batch 4, ipe 8. A step launches B1 at fp32 12 (target) + 2 x 12
# (contexts) + 2 x 2 (predictor) times and B2 at fp32 2 x (12 + 2).
SMOKE_CONFIG_FILE = "configs/train/smoke-tiny.yaml"
SMOKE_CONFIG = {
    "app": "vjepa", "folder": "/tmp/vjepa2_tpu_smoke",
    "mesh": {"data": -1, "fsdp": 1, "model": 1},
    "data": {"datasets": [], "batch_size": 4, "crop_size": 64, "patch_size": 16,
             "dataset_fpcs": [4], "tubelet_size": 2, "num_workers": 0},
    "loss": {"loss_exp": 1.0},
    "mask": [
        {"aspect_ratio": [0.75, 1.5], "num_blocks": 4, "spatial_scale": [0.15, 0.15],
         "temporal_scale": [1.0, 1.0]},
        {"aspect_ratio": [0.75, 1.5], "num_blocks": 2, "spatial_scale": [0.7, 0.7],
         "temporal_scale": [1.0, 1.0]},
    ],
    "meta": {"dtype": "float32", "seed": 0, "load_checkpoint": False},
    "model": {"model_name": "vit_tiny", "pred_depth": 2, "pred_embed_dim": 192,
              "pred_num_heads": 3, "uniform_power": True, "use_mask_tokens": True,
              "use_rope": True},
    "optimization": {"ema": [0.998, 1.0], "epochs": 2, "final_lr": 1.0e-06,
                     "final_weight_decay": 0.4, "ipe": 8, "lr": 0.001, "start_lr": 0.0002,
                     "warmup": 0, "weight_decay": 0.04},
}
# the shipped file keeps load_checkpoint off; the resumed epoch 1 reads the
# checkpoint epoch 0 saved (epoch 0 finds none in its fresh folder)
SMOKE_OVERRIDES = {"meta.load_checkpoint": True}
SMOKE_LAUNCHES = _counts(b1_fp32=12 + 2 * 12 + 2 * 2, b2_fp32=2 * (12 + 2))
# the smoke loop's first 3 losses on the card against the same config and
# seed on the CPU (fp32 plain path) from the card's initial weights: fp32 on
# both sides through 12 + 2 layers and 2 Adam steps (the CPU loop's parity
# with JAX is held to the same, `tests/test_torch_loop.py`; measured on an
# H100: 7e-8 to 3.2e-7)
SMOKE_LOSS_RTOL = 1e-5
GIANT_REL_L2 = 5e-2  # bf16 on the card against fp32 on the CPU, 40 layers
# launches a step of the loop phases, in the order of KERNEL_COUNTS. ViT-H at
# batch 16 under full remat: B3 32 target + 2 x 32 context + 64 recomputed,
# the BHND backward 64, B1 2 x 12 predictor + 24 recomputed, B2 24. The
# cooldown under save_attn_qkv_h (nothing recomputes the attention forward),
# 6 microbatches of 24 target + 2 x 24 context + 2 x 12 predictor B1 and
# 2 x (24 + 12) B2.
LOOP_LAUNCHES = _counts(b1=48, b2=24, b3=160, bhnd_bwd=64)
ACCUM_LAUNCHES = _counts(b1=6 * 96, b2=6 * 72)

# The shipped configs the loop phases run, held here as `yaml.safe_load`
# gives them (the card's host may lack PyYAML; `tests/test_torch_loop.py`
# checks them against the files). Each phase overrides only what it prints:
# the run folder (a temporary directory), `optimization.ipe` and the epochs;
# the cooldown also `mesh.model` 4 -> 1 (one card has no context-parallel
# axis; JAX too turns context parallelism off at 1, `loop.py:124-127`).
_MASKS_8_2 = [
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 8, "spatial_scale": [0.15, 0.15],
     "temporal_scale": [1.0, 1.0]},
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 2, "spatial_scale": [0.7, 0.7],
     "temporal_scale": [1.0, 1.0]},
]
LOOP_CONFIG_FILE = "configs/train/vith16/pretrain-256px-16f.yaml"
LOOP_CONFIG = {
    "app": "vjepa", "folder": "./runs/vith16-pretrain-256px-16f",
    "mesh": {"data": -1, "fsdp": 1, "model": 1},
    "data": {"datasets": [], "batch_size": 16, "crop_size": 256, "patch_size": 16,
             "dataset_fpcs": [16], "tubelet_size": 2, "fps": 4, "num_workers": 8},
    "data_aug": {"random_resize_aspect_ratio": [0.75, 1.35], "random_resize_scale": [0.3, 1.0]},
    "loss": {"loss_exp": 1.0},
    "mask": _MASKS_8_2,
    "meta": {"dtype": "bfloat16", "seed": 239, "load_checkpoint": True},
    "model": {"model_name": "vit_huge", "pred_depth": 12, "pred_embed_dim": 384,
              "pred_num_heads": 12, "uniform_power": True, "use_activation_checkpointing": True,
              "use_mask_tokens": True, "use_rope": True, "zero_init_mask_tokens": True},
    "optimization": {"ema": [0.99925, 0.99925], "epochs": 10, "final_lr": 0.000425,
                     "final_weight_decay": 0.04, "ipe": 300, "ipe_scale": 1.25, "lr": 0.000425,
                     "start_lr": 0.0001, "warmup": 40, "weight_decay": 0.04},
}
LOOP_IPE = 3  # cut from 4 to keep the script within its time limit
# one epoch: cut from 2 (a resumed epoch 1) in PR 20, whose train_disk resumes
LOOP_OVERRIDES = {"optimization.ipe": LOOP_IPE, "optimization.epochs": 1}
ACCUM_CONFIG_FILE = "configs/train/vitl16/cooldown-256px-64f.yaml"
ACCUM_CONFIG = {
    "app": "vjepa", "folder": "./runs/vitl16-cooldown-256px-64f",
    "mesh": {"data": -1, "fsdp": 1, "model": 4},
    "data": {"datasets": [], "batch_size": 12, "crop_size": 256, "patch_size": 16,
             "dataset_fpcs": [64], "tubelet_size": 2, "fps": 4, "num_workers": 8},
    "loss": {"loss_exp": 1.0},
    "mask": _MASKS_8_2,
    "meta": {"dtype": "bfloat16", "seed": 239, "load_checkpoint": True, "read_checkpoint": None},
    "model": {"model_name": "vit_large", "pred_depth": 12, "pred_embed_dim": 384,
              "pred_num_heads": 12, "uniform_power": True, "use_activation_checkpointing": True,
              "remat_policy": "save_attn_qkv_h", "use_mask_tokens": True, "use_rope": True,
              "context_parallel": True},
    "optimization": {"ema": [0.99925, 0.99925], "epochs": 4, "final_lr": 1.0e-06,
                     "final_weight_decay": 0.04, "grad_accum": 6, "ipe": 300, "ipe_scale": 1.25,
                     "lr": 0.000525, "start_lr": 0.000525, "warmup": 0, "weight_decay": 0.04},
}
ACCUM_OVERRIDES = {"mesh.model": 1, "optimization.ipe": 2, "optimization.epochs": 1}
# V-JEPA 2-AC post-training (phase train_droid): the ViT-g target over 64
# single frames (40 B1 forwards), then the AC predictor's teacher forcing and
# one rollout call (24 B1 and 24 B2 each); batch 8, 8 frames at 256 px
DROID_CONFIG_FILE = "configs/train/vitg16/droid-256px-8f.yaml"
DROID_CONFIG = {
    "app": "vjepa_droid", "folder": "./runs/vitg16-droid-256px-8f",
    "mesh": {"data": -1, "fsdp": 1, "model": 1},
    "data": {"datasets": [], "batch_size": 8, "crop_size": 256, "patch_size": 16,
             "dataset_fpcs": [8], "tubelet_size": 2, "fps": 4, "num_workers": 8},
    "loss": {"loss_exp": 1.0, "auto_steps": 2, "normalize_reps": True},
    "mask": [],
    "meta": {"dtype": "bfloat16", "seed": 234, "load_checkpoint": True, "read_checkpoint": None},
    "model": {"model_name": "vit_giant_xformers", "pred_depth": 24, "pred_embed_dim": 1024,
              "pred_num_heads": 16, "uniform_power": False, "use_rope": True,
              "use_extrinsics": False, "max_num_frames": 512},
    "optimization": {"epochs": 12, "ipe": 300, "ipe_scale": 1.0, "lr": 4.25e-05,
                     "start_lr": 2e-05, "final_lr": 0.0, "warmup": 1, "anneal": 2,
                     "weight_decay": 0.04, "final_weight_decay": 0.4, "enc_lr_scale": 1.0},
}
DROID_IPE = 4
DROID_OVERRIDES = {"optimization.ipe": DROID_IPE, "optimization.epochs": 2}
DROID_LAUNCHES = _counts(b1=40 + 2 * 24, b2=2 * 24)
# The same config at meta.dtype float32 (phase train_droid_fp32, one epoch):
# every attention on B1 and B2 at fp32 (heads of 64: the DN route, the AC
# rows' frame-causal ids and pad keys too), the BHND fp32 kernels none
DROID_FP32_OVERRIDES = {"meta.dtype": "float32", "optimization.ipe": DROID_IPE,
                        "optimization.epochs": 1}
DROID_FP32_LAUNCHES = _counts(b1_fp32=40 + 2 * 24, b2_fp32=2 * 24)
# CEM planning (phase plan) on the hub's `vjepa2_ac_vit_giant()` at
# `CEMConfig`'s defaults (400 samples, rollout 2, 10 steps, top-k 10): an
# encode runs B1 once a ViT-g layer, a plan once an AC predictor layer in each
# of its 10 x 2 rollout calls (over 400 x 264 and 400 x 520 tokens)
ENCODE_LAUNCHES = _counts(b1=40)
PLAN_LAUNCHES = _counts(b1=10 * 2 * 24)
PLAN_TIMED, PLAN_CANDIDATES = 1, 4  # timed plans cut from 2 (the script's time limit)
# encode and step_fn, bf16 on the card against fp32 on the CPU: the serving
# slice's relative L2 (40 ViT-g layers, then 24 predictor layers on top); the
# CEM update on a linear world model, fp32 on both sides, one sampler: the
# same arithmetic in another order
PLAN_REL_L2, CEM_UPDATE_ATOL = 5e-2, 1e-6
# The same plan at fp32 (phase plan_fp32: `vjepa2_ac_vit_giant(dtype=
# torch.float32)`): every attention on B1 at fp32 (the DN route, heads of
# 64), an encode's 40 and a plan's 480 forwards (the AC rows with their
# frame-causal ids and pad keys), no bf16 kernel and no BHND one. One timed plan at `CEMConfig()` but for its CEM
# steps, PLAN_FP32_STEPS of its 10; its warm-up and the bit-equal repeat
# (traced) at PLAN_FP32_CUT_STEPS; each step runs both rollout lengths (cut
# from full plans to keep the script within its time limit: a full fp32
# plan takes ~46 s on an H100). encode and step_fn against the fp32 CPU path
# of phase plan (the same weights, checked): fp32 on both sides, the GEMMs in
# other orders, the attention 3xTF32 (2e-5 of plain), over 40 + 24 layers.
PLAN_FP32_STEPS, PLAN_FP32_CUT_STEPS, PLAN_FP32_REL_L2 = 3, 1, 1e-4
ENCODE_FP32_LAUNCHES = _counts(b1_fp32=40)
PLAN_FP32_LAUNCHES = _counts(b1_fp32=PLAN_FP32_STEPS * 2 * 24)
# The serving export (phase export): ViT-L answers requests of 1 and 8 clips
# through its loaded program (24 B1 each), timed against eager 5 times each,
# interleaved; ViT-H one clip (32 B3); the world model an encode (40 B1) and a
# plan (480 B1). A loaded program's answer is held to eager's with
# `torch.equal`; where the two part, to the fp32 CPU path within the serving
# slice's relative L2.
EXPORT_BATCHES, EXPORT_REPEATS, EXPORT_REL_L2 = (1, 8), 5, 5e-2

# The frozen evals (phases eval_video, eval_anticipation): the shipped ViT-L
# configs as `yaml.safe_load` gives them (`tests/test_torch_eval_cli.py`
# holds them to the files), through `cli.eval`'s run functions on the card;
# each phase overrides only ipe and the epochs (2 train steps, 1 val batch).
# Both share the reference's grid of 10 probes: 5 lrs x 2 weight decays.
_PROBE_GRID = [{"lr": lr, "start_lr": lr, "final_lr": 0.0, "weight_decay": wd,
                "final_weight_decay": wd, "warmup": 0.0}
               for wd in (0.01, 0.1) for lr in (0.005, 0.003, 0.001, 0.0003, 0.0001)]
EVAL_VIDEO_CONFIG_FILE = "configs/eval/vitl/ssv2.yaml"
EVAL_VIDEO_CONFIG = {
    "eval_name": "video_classification_frozen", "folder": "./runs/evals/vitl/ssv2",
    "tag": "ssv2-vitl16",
    "experiment": {
        "classifier": {"num_heads": 16, "num_probe_blocks": 4},
        "data": {"dataset_type": "VideoDataset", "dataset_train": None, "dataset_val": None,
                 "frame_step": 4, "frames_per_clip": 16, "num_classes": 174, "num_segments": 2,
                 "num_views_per_segment": 3, "resolution": 256},
        "optimization": {"batch_size": 4, "num_epochs": 20, "ipe": 300,
                         "multihead_kwargs": _PROBE_GRID}},
    "model_kwargs": {
        "checkpoint": None,
        "module_name": "evals.video_classification_frozen.modelcustom.vit_encoder_multiclip",
        "pretrain_kwargs": {"model_name": "vit_large", "patch_size": 16, "tubelet_size": 2,
                            "uniform_power": True, "use_rope": True},
        "wrapper_kwargs": {"use_pos_embed": False}},
}
EVAL_ANTICIPATION_CONFIG_FILE = "configs/eval/vitl/ek100.yaml"
EVAL_ANTICIPATION_CONFIG = {
    "eval_name": "action_anticipation_frozen", "folder": "./runs/evals/vitl/ek100",
    "experiment": {
        "data": {"annotations_train": None, "annotations_val": None, "frames_per_clip": 16,
                 "frames_per_second": 4, "resolution": 256, "anticipation_time": [1.0, 1.0]},
        "optimization": {"batch_size": 16, "num_epochs": 10, "ipe": 300, "lr": 0.001,
                         "weight_decay": 0.01, "recall_k": 5, "multihead_kwargs": _PROBE_GRID}},
    "model_kwargs": {
        "module_name":
            "evals.action_anticipation_frozen.modelcustom.vit_encoder_predictor_concat_ar",
        "checkpoint": None,
        "pretrain_kwargs": {"model_name": "vit_large", "use_rope": True, "uniform_power": True}},
}
EVAL_IPE = 2  # cut from 4 (3 at PR 17) to keep the script within its time limit
EVAL_OVERRIDES = {"experiment.optimization.ipe": EVAL_IPE,
                  "experiment.optimization.num_epochs": 1}
# launches a train step and a val batch: SSv2's encoder over its 4 x 2 clips in
# one call (24 B1 at [8,16,64,2048]) and its 10 probes' 3 self-attention
# blocks each (30 B1 at fp32 at [4,16,64,4096], heads of 64 on the DN
# route, and 30 B2 at fp32 in a train step); EK100's encoder over 16 clips (24 at [16,16,64,2048]) and its
# predictor over 2048 + 256 tokens (12 at [16,12,32,2304], per-example
# tables), its depth-1 probes no kernel
EVAL_VIDEO_LAUNCHES = {"train": _counts(b1=24, b1_fp32=30, b2_fp32=30),
                       "val": _counts(b1=24, b1_fp32=30)}
EVAL_ANTICIPATION_LAUNCHES = {"train": _counts(b1=24 + 12), "val": _counts(b1=24 + 12)}
# IN1K (phase eval_image): the shipped ViT-L config, batch 64 images as 16
# fake frames (24 B1 at [64,16,64,2048]), 6 probes of depth 4 (18 B1 at
# fp32 at [64,16,64,2048], 18 B2 at fp32 a train step); cut to ipe 2, 1
# epoch (2 train steps, 1 val batch)
EVAL_IMAGE_CONFIG_FILE = "configs/eval/vitl/in1k.yaml"
EVAL_IMAGE_CONFIG = {
    "eval_name": "image_classification_frozen", "folder": "./runs/evals/vitl/in1k",
    "experiment": {
        "classifier": {"num_heads": 16, "num_probe_blocks": 4},
        "data": {"root": None, "root_val": None, "resolution": 256, "num_classes": 1000},
        "optimization": {"batch_size": 64, "num_epochs": 20, "ipe": 300,
                         "multihead_kwargs": [{"lr": lr, "weight_decay": wd}
                                              for wd in (0.01, 0.1)
                                              for lr in (0.005, 0.001, 0.0003)]}},
    "model_kwargs": {
        "module_name": "evals.image_classification_frozen.modelcustom.vit_encoder",
        "checkpoint": None,
        "pretrain_kwargs": {"model_name": "vit_large", "use_rope": True, "uniform_power": True},
        "wrapper_kwargs": {"img_as_video_nframes": 16}},
}
EVAL_IMAGE_LAUNCHES = {"train": _counts(b1=24, b1_fp32=18, b2_fp32=18),
                       "val": _counts(b1=24, b1_fp32=18)}
EVAL_IMAGE_CPU_EXAMPLES = 4  # the CPU checks' examples: the host's share of the batch
# ViT-g/384 K400 (phase eval_video_384): the shipped config, batch 1 of 8
# segments of 16f@384 (8 x 8 x 24 x 24 = 36,864 tokens); the 22-head ViT-g
# over the 8 clips (40 B1 at [8,22,64,4608]), 10 probes of depth 4 with 16
# heads of 88 (30 fp32 forwards at [1,16,36864,88], 30 backwards a train
# step); cut to ipe 1, 1 epoch (1 train step, 1 val batch; 2 before PR 18)
EVAL_VIDEO_384_CONFIG_FILE = "configs/eval/vitg-384/k400.yaml"
EVAL_VIDEO_384_CONFIG = {
    "eval_name": "video_classification_frozen", "folder": "./runs/evals/vitg-384/k400",
    "tag": "k400-vitg-38416-16x8x3-16f",
    "experiment": {
        "classifier": {"num_heads": 16, "num_probe_blocks": 4},
        "data": {"dataset_type": "VideoDataset", "dataset_train": None, "dataset_val": None,
                 "frame_step": 4, "frames_per_clip": 16, "num_classes": 400, "num_segments": 8,
                 "num_views_per_segment": 3, "resolution": 384},
        "optimization": {"batch_size": 1, "num_epochs": 20, "ipe": 300,
                         "multihead_kwargs": _PROBE_GRID}},
    "model_kwargs": {
        "checkpoint": None,
        "module_name": "evals.video_classification_frozen.modelcustom.vit_encoder_multiclip",
        "pretrain_kwargs": {"model_name": "vit_giant_xformers", "patch_size": 16,
                            "tubelet_size": 2, "uniform_power": True, "use_rope": True},
        "wrapper_kwargs": {"max_frames": 128, "use_pos_embed": False}},
}
EVAL_384_IPE = 1  # cut from 2 to keep the script within its time limit
EVAL_VIDEO_384_OVERRIDES = {"experiment.optimization.ipe": EVAL_384_IPE,
                            "experiment.optimization.num_epochs": 1}
EVAL_VIDEO_384_LAUNCHES = {"train": _counts(b1=40, b3_fp32=30, bhnd_bwd_fp32=30),
                           "val": _counts(b1=40, b3_fp32=30)}
# the K400 check's query chunk: the plain forward's [1, 16, 512, 36864] fp32
# scores (1.2 GB) where the whole [1, 16, 36864, 36864] would be 87 GB
EVAL_384_QUERY_CHUNK = 512
# Card against the fp32 CPU path (`_eval_cpu_checks`). Example 0's features
# and probe 0's logits on them, end to end (bf16 encoder and predictor on the
# card): the serving slice's relative L2. Every probe's logits and loss, and
# probe 0's gradients, on the card's own bf16 features: fp32 on both sides,
# only the summation order differs (cuBLAS against the CPU's GEMMs, softmax
# sums over up to 4096 keys; measured ~1e-7 on the losses, ~1e-6 on the
# gradients): 1e-4 relative L2 on the logits, 1e-4 relative on the losses,
# 1e-3 relative L2 on the flattened gradients. The step's own losses and
# gradients against the same computed again on the card: 1e-5.
EVAL_REL_L2, EVAL_PROBE_REL_L2, EVAL_LOSS_RTOL, EVAL_GRAD_REL_L2 = 5e-2, 1e-4, 1e-4, 1e-3
EVAL_STEP_RTOL = 1e-5

# Video from disk (phase train_disk; phase eval_video reads its clips from the
# same files). The shipped ViT-L pretrain config as `yaml.safe_load` gives it
# (`tests/test_torch_data_smoke.py` holds it to the file): batch 24, 16f@256,
# fps 4, 8 workers, full remat, bf16. Overridden: the run folder (a temporary
# directory), `data.datasets` (the manifest below), ipe 3 and 2 epochs, run as
# epoch 0 then a resumed epoch 1.
TRAIN_DISK_CONFIG_FILE = "configs/train/vitl16/pretrain-256px-16f.yaml"
TRAIN_DISK_CONFIG = {
    "app": "vjepa", "folder": "./runs/vitl16-pretrain-256px-16f",
    "mesh": {"data": -1, "fsdp": 1, "model": 1},
    "data": {"dataset_type": "VideoDataset", "datasets": [], "batch_size": 24,
             "crop_size": 256, "patch_size": 16, "dataset_fpcs": [16], "tubelet_size": 2,
             "fps": 4, "num_workers": 8},
    "data_aug": {"auto_augment": False, "motion_shift": False,
                 "random_resize_aspect_ratio": [0.75, 1.35], "random_resize_scale": [0.3, 1.0],
                 "reprob": 0.0},
    "loss": {"loss_exp": 1.0},
    "mask": [{**m, "full_complement": False, "max_keep": None, "max_temporal_keep": 1.0}
             for m in _MASKS_8_2],
    "meta": {"dtype": "bfloat16", "seed": 239, "load_checkpoint": True, "save_every_freq": 50},
    "model": {"model_name": "vit_large", "pred_depth": 12, "pred_embed_dim": 384,
              "pred_num_heads": 12, "uniform_power": True, "use_activation_checkpointing": True,
              "use_mask_tokens": True, "use_rope": True, "zero_init_mask_tokens": True},
    "optimization": {"ema": [0.99925, 0.99925], "epochs": 10, "final_lr": 0.000525,
                     "final_weight_decay": 0.04, "ipe": 300, "ipe_scale": 1.25, "lr": 0.000525,
                     "start_lr": 0.0001, "warmup": 40, "weight_decay": 0.04},
}
TRAIN_DISK_IPE = 3
TRAIN_DISK_OVERRIDES = {"optimization.ipe": TRAIN_DISK_IPE, "optimization.epochs": 2}
# a step under full remat: B1 24 target + 2 x 24 context + 2 x 12 predictor
# forwards, the 72 with gradients again in the backward (recomputed); B2 72
TRAIN_DISK_LAUNCHES = _counts(b1=96 + 72, b2=72)
# the files: 8 source videos of 300 frames at 256 x 340 (30 fps), each listed
# 9 times in a 72-row space-delimited CSV (label: the video's index); the
# SSv2 eval's val manifest lists the first 4 once (one val batch of 4)
DISK_VIDEOS, DISK_FRAMES, DISK_HW, DISK_FPS, DISK_REPEATS = 8, 300, (256, 340), 30.0, 9
DISK_VAL_ROWS = 4


class _NpyReader:
    """A video held as a uint8 [T, H, W, 3] `.npy` array, memory-mapped:
    ``get_batch`` reads only the frames asked for; 30 fps."""

    avg_fps = DISK_FPS

    def __init__(self, path: str):
        self._frames = np.load(path, mmap_mode="r")

    def __len__(self) -> int:
        return self._frames.shape[0]

    def get_batch(self, indices) -> np.ndarray:
        return np.ascontiguousarray(self._frames[np.asarray(indices, np.int64)])


class NpyVideoDataset(_VideoDataset):
    """The reader double of a host with no video decoder: `VideoDataset`
    opening `_NpyReader` files (defined here, at the top level, where the
    loader's spawned workers unpickle it; it is no part of the package)."""

    def open_video(self, path: str):
        return _NpyReader(path)

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
# B6 on fp32 operands against plain on the same inputs: nothing rounds to
# bf16, so only fp32's order: a row's sums over C <= 1408 elements in
# another order (~sqrt(C) 2**-24, 2e-6 relative at worst) and rsqrtf (2 ulp)
# move mean by ~1e-7 and rstd by ~2.4e-7 relative, y and dx by a few 1e-6
# at |values| <= ~10 (measured on an H100: 1.2e-7, 2.4e-7, 1.9e-6, 9.5e-7;
# dgamma/dbeta 2.3e-7): tolerances about 5x those.
LN_FP32_STAT_ATOL, LN_FP32_RSTD_RTOL, LN_FP32_ATOL, LN_FP32_RTOL, LN_FP32_PARAM_REL_L2 = (
    1e-6, 1e-6, 1e-5, 1e-5, 1e-5)
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
# (name, [B, H, N, D], features) — the shapes the fp32 BHND kernels take on
# the main paths: the probes' self-attention in the IN1K, SSv2 and ViT-g/384
# K400 evals and in the serving slice (plain attention); the fp32 ViT-L step
# of phase train_fp32 (RoPE: the target's shared tables, per-example tables
# of real collator masks for the contexts and the predictor, stack-padded
# with kv_valid, as `_bhnd_case` builds them for phase 7)
FP32_SHAPES = [
    ("in1k vit_large probe", (64, 16, 2048, 64), {}),
    ("ssv2 vit_large probe", (4, 16, 4096, 64), {}),
    ("serving slice probe", (8, 16, 2048, 64), {}),
    ("k400 vit_giant/384 probe", (1, 16, 36864, 88), {}),
    ("fp32 vit_large target", (8, 16, 2048, 64), {"rope": "shared"}),
    ("fp32 vit_large context, mask 0", (8, 16, 584, 64), {"rope": "ctx0", "kv_valid_len": 578}),
    ("fp32 vit_large context, mask 1", (8, 16, 176, 64), {"rope": "ctx1", "kv_valid_len": 173}),
    ("fp32 predictor, mask 1", (8, 12, 1664, 32), {"rope": "pred1", "kv_valid_len": 1662}),
    ("fp32 predictor, mask 0", (8, 12, 1624, 32), {"rope": "pred0", "kv_valid_len": 1623}),
    # the AC predictor's rows at fp32 (frame-causal ids, the stack pad's keys
    # on int32-max): the DROID step's 7 frames of 2 + 256 tokens, and a CEM
    # plan's rollouts of 1 and 2 frames (forward only: planning takes no
    # gradient)
    ("fp32 droid AC, stack-padded", (8, 16, 1808, 64), {"ac": (7, 2)}),
    ("fp32 cem rollout, 1 frame", (400, 16, 264, 64), {"ac": (1, 6), "fwd_only": True}),
    ("fp32 cem rollout, 2 frames", (400, 16, 520, 64), {"ac": (2, 4), "fwd_only": True}),
    ("fp32 ring hop: seg_kv, given lse", (2, 16, 1024, 80), {"seg_kv": True, "global_lse": True}),
    ("fp32 causal", (2, 16, 1024, 80), {"causal": True}),
    # ids an fp32 cast would merge (2**24 + 1 rounds to 2**24), and queries
    # whose id is below every key's (out 0, lse -inf, no gradient)
    ("fp32 ids 2**24 and 2**24 + 1", (2, 16, 1024, 64), {"ids": "past 2**24"}),
    ("fp32 rows with no key", (2, 16, 1024, 64), {"ids": "no key"}),
]
# (name, [B, H, D, N], features) — the shapes B1 and B2 take at fp32 on the
# main paths, the DN route (`flash_attention_dn`: heads of 16-64, as JAX's
# `modules.py:515-546` routes them): the fp32 ViT-L step's target (shared
# RoPE; no gradient), a context and a predictor on per-example tables with
# kv_valid, the fp32 DROID step's AC rows (frame-causal, the pad keys on
# int32-max) and its target's single frames (no gradient), the fp32 plan's
# rollouts (no gradient), and heads of 16 and 48. Each row also runs the
# BHND fp32 kernels on the same data transposed: the two share the split
# copies and the mainloops, so they are expected to give equal bits.
FP32_DN_SHAPES = [
    ("fp32 vit_large target", (8, 16, 64, 2048), {"rope": "shared", "fwd_only": True}),
    ("fp32 vit_large context, mask 0", (8, 16, 64, 584), {"rope": "ctx0", "kv_valid_len": 578}),
    ("fp32 predictor, mask 1", (8, 12, 32, 1664), {"rope": "pred1", "kv_valid_len": 1662}),
    ("fp32 droid AC, stack-padded", (8, 16, 64, 1808), {"ac": (7, 2)}),
    ("fp32 droid target frames", (64, 22, 64, 256), {"rope": "shared", "fwd_only": True}),
    ("fp32 cem rollout, 1 frame", (400, 16, 64, 264), {"ac": (1, 6), "fwd_only": True}),
    ("fp32 cem rollout, 2 frames", (400, 16, 64, 520), {"ac": (2, 4), "fwd_only": True}),
    ("fp32 heads of 16", (8, 16, 16, 2048), {"rope": "shared"}),
    ("fp32 heads of 48", (8, 16, 48, 2048), {"rope": "shared"}),
]
# the row of the main path's shape for the BHND fp32 kernels, whose record
# the kernels line gives: the heads of 16-64 take the DN route, and the
# ViT-g/384 K400 probes' heads of 88 this one
FP32_BHND_MAIN_ROW = "k400 vit_giant/384 probe"
# The plain version holds [B, H, N, M] fp32 scores (the backward about five
# such); above FP32_PLAIN_WHOLE bytes it runs over chunks of queries that hold
# at most FP32_PLAIN_CHUNK bytes (at most 512 rows): out, lse and dq follow
# row by row, dk and dv are the sums of the chunks' partials.
FP32_PLAIN_WHOLE, FP32_PLAIN_CHUNK = 8 << 30, 2 << 30
# fp32 kernel against plain on the same fp32 inputs (TF32 off): the kernel
# takes each product as three TF32 products (operands held to 2**-22) over
# 32- or 64-key tiles summed in fp32 with an online rescale, the plain
# version whole rows through cuBLAS; fp32 rounding (2**-24) over ~N
# additions: 2e-5 relative L2 and 1e-4 x max|plain| on out and the
# gradients, 1e-5 on lse.
FP32_REL_L2, FP32_MAX_ABS, FP32_LSE_ATOL = 2e-5, 1e-4, 1e-5
# B7/B8 against plain from the same bf16 inputs: each output rounds once to
# bf16 (2**-9) and y may round to the neighbouring bf16 value where the
# statistics differ in the last bit: 5e-3 + 1e-2 |plain|. On fp32 inputs the
# kernels (3xTF32) are held to the fp32 flash kernels' FP32_REL_L2 and
# FP32_MAX_ABS x max|plain|: the split keeps each operand to 2**-22 and the
# tensor cores' truncating fp32 adds over C / 8 k-steps drift ~1e-5 at C
# 1408 (measured on an H100: 2.5e-6 relative L2 at 384, 7e-6 at 1024, 1e-5
# at 1408).
PROLOGUE_ATOL, PROLOGUE_RTOL = 5e-3, 1e-2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def overridden(raw: dict, overrides: dict) -> dict:
    """A deep copy of the config ``raw`` with each dotted key of
    ``overrides`` set."""
    out = json.loads(json.dumps(raw))
    for key, value in overrides.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node[part]
        node[leaf] = value
    return out


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
    def traced(body, skip=frozenset()):
        return _traced_spans(lambda: [body(i) for i in range(calls)], skip)[0]

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    skip = {name for name, _, _ in traced(lambda i: flush.fill_(1 + i % 250))} if cold else set()
    fn()  # warm-up
    spans = traced(lambda i: (flush.fill_(1 + i % 250) if cold else None, fn()), skip)
    by_kernel: dict[str, float] = {}
    for name, a, b in spans:
        m = re.search(r"\w+_kernel(<[\w, <>]*>)?", name.replace("(anonymous namespace)::", ""))
        key = m.group() if m else name[:80]
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a) / 1e3 / calls
    return _busy_us(spans) / 1e3 / calls, by_kernel


def _traced_spans(body, skip=frozenset()) -> tuple[list[tuple[str, float, float]], float]:
    """([(kernel, start us, end us)], host wall ms) of one traced run of
    ``body``: the card synchronised before, and after inside the wall time.
    The profiler now and then returns a session without its device events:
    trace again, and fail rather than time nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            body()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.name not in skip
                 and e.time_range.end > e.time_range.start]
        if spans:
            return spans, wall_ms
    raise RuntimeError("the profiler recorded no device events in five sessions")


def _busy_us(spans) -> float:
    """The union of the spans' intervals (us): the time some kernel runs."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def wall_and_busy(fn) -> dict:
    """One call of ``fn`` under the profiler: its host wall ms (synchronised
    before and after), the device-busy ms of the same call, the idle share
    1 - busy / wall and the kernels' ms summed by
    `tools.profile_pretrain.category`. The profiler's own host cost is inside
    the wall."""
    from vjepa2_tpu_torch.tools.profile_pretrain import category

    spans, wall_ms = _traced_spans(fn)
    busy_ms = _busy_us(spans) / 1e3
    cats: dict[str, float] = {}
    for name, a, b in spans:
        cats[category(name)] = cats.get(category(name), 0.0) + (b - a) / 1e3
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernels": len(spans),
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_ms_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1]))}


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
    with integer arguments). The identifier may hold digits (``flash_fp32_fwd_kernel``),
    so each start that the length before it fits is tried."""
    for k in re.finditer(r"_kernel", mangled):
        starts = [i for i in range(k.start(), -1, -1) if re.fullmatch(
            r"[A-Za-z_][A-Za-z0-9_]*", mangled[i:k.start()] or "_")]
        for start in starts:
            m = re.match(r"[A-Za-z_][A-Za-z0-9_]*_kernel", mangled[start:k.end()])
            digits = re.search(r"\d+$", mangled[:start])
            if m is None or not digits or not digits.group().endswith(str(len(m.group()))):
                continue
            rest = mangled[k.end():]
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


def _seq_positions(dev, ids):
    """Per-example positions [B, N] of a collator sequence, stack-padded with
    id 0 to a multiple of 8 as the models pad, and its kv_valid (None when
    no pad was added)."""
    n = ids.shape[1]
    N = n + (-n) % 8
    pos = torch.zeros(ids.shape[0], N, dtype=torch.long)
    pos[:, :n] = torch.from_numpy(ids)
    return pos.to(dev), (n if N != n else None)


def _dn_case(dev, B, H, D, N, feats, seqs=None):
    """(q, k, v, kwargs) for one B1 shape: random bf16 [B, H, D, N]
    operands, RoPE tables (shared, or per example from a collator sequence
    of ``seqs`` with its kv_valid), and the shape's kv_valid or frame-causal
    segments (equal frames of tokens)."""
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    if B * H * D * N > DEVICE_RNG_ELEMENTS:
        gen = torch.Generator(dev).manual_seed(0)
        q, k, v = (torch.randn(B, H, D, N, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
    else:
        rng = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rng.randn(B, H, D, N).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
    kw = {}
    pos = torch.arange(N, device=dev)
    if "seq" in feats:
        pos, kv_valid = _seq_positions(dev, seqs[feats["seq"]])
        if pos.shape != (B, N):
            raise AssertionError(f"{feats['seq']} gives positions {tuple(pos.shape)}, not "
                                 f"[{B}, {N}]")
        if kv_valid is not None:
            kw["kv_valid_len"] = kv_valid
    grid = feats.get("grid", (16, 16))
    (cos, sin), _ = expand_rope_cache(build_rope_cache(pos, D, *grid), D)
    kw["rope_expanded"] = (cos, sin)
    if "kv_valid_len" in feats:
        kw["kv_valid_len"] = feats["kv_valid_len"]
    if "segments" in feats:
        kw["segment_ids"] = _ac_segments(dev, N, feats["segments"], feats.get("pad", 0))
    return q, k, v, kw


def _ac_segments(dev, N, frames, pad):
    """Frame-causal ids of ``N`` tokens: ``frames`` equal frames, then
    ``pad`` stack-pad tokens on int32-max (`models.modules.frame_segments`)."""
    from vjepa2_tpu_torch.models.modules import frame_segments

    return frame_segments(frames, (N - pad) // frames, dev, pad)


def phase_kernels(dev, smi: str) -> dict:
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops.rope import rope_rotate

    seqs, first = _mask_seqs(), None
    for name, (B, H, D, N), feats in SHAPES:
        q, k, v, kw = _dn_case(dev, B, H, D, N, feats, seqs)
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


def phase_slice(dev, smi: str) -> tuple[int, ...]:
    from vjepa2_tpu_torch.evals.wrappers import encode_clips
    from vjepa2_tpu_torch.hub.backbones import vjepa2_vit_large
    from vjepa2_tpu_torch.models.attentive_pooler import AttentiveClassifier

    def build(device, dtype, generator=None):
        enc, _ = vjepa2_vit_large(num_frames=FRAMES, uniform_power=True, use_flash=True,
                                  dtype=dtype, device=device, generator=generator)
        # the probe in fp32 on the flash route, as the evals' probes
        clf = AttentiveClassifier(embed_dim=1024, num_heads=16, depth=4, num_classes=174,
                                  device=device, use_flash=True)
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
    want = _counts(b1=len(enc.blocks), b1_fp32=len(clf.pooler.blocks))
    for clips in requests:
        before = _launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = answer(clips)
        times.append((time.perf_counter() - t1) * 1e3)
        launched = tuple(a - b for a, b in zip(_launch_counts(), before))
        if launched != want:
            raise AssertionError(f"a request launched {dict(zip(KERNEL_COUNTS, launched))}, "
                                 f"want {dict(zip(KERNEL_COUNTS, want))}")
        if logits.shape != (CLIPS, 174) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        answers.append(logits)
    launches = _launch_counts()

    on_device = requests[0].to(dev)
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: clf(encode_clips(enc, on_device)), iters=3, warmup=1)

    # the same weights in fp32 on the CPU (the wrapper takes the plain path
    # there), on `_CPU_WORK` beside the next phases; the record prints then
    states = [{k: v.to("cpu", copy=True) for k, v in m.state_dict().items()} for m in (enc, clf)]
    got = answers[0][0]
    med = sorted(times)[len(times) // 2]

    def finish() -> None:
        torch.set_num_threads(os.cpu_count() or 1)
        t2 = time.perf_counter()
        enc_cpu, clf_cpu = build("cpu", torch.float32)
        enc_cpu.load_state_dict(states[0])
        clf_cpu.load_state_dict(states[1])
        with torch.inference_mode():
            ref = clf_cpu(encode_clips(enc_cpu, requests[0][:1]))[0]
        cpu_s = time.perf_counter() - t2
        rel = ((got - ref).norm() / ref.norm()).item()
        ok = rel <= LOGITS_REL_L2
        emit({"phase": "slice",
              "model": "vit_large 16f@256 bf16 + ssv2 probe (depth 4, 174; fp32 flash route)",
              "requests": REQUESTS, "clips_per_request": CLIPS, "warmup_requests": 1,
              "ms_per_request": times, "median_ms_per_request": med,
              "clips_per_s": CLIPS / (med / 1e3), "device_ms_per_request": device_ms,
              "launches": dict(zip(KERNEL_COUNTS, launches)),
              "launches_per_request": dict(zip(KERNEL_COUNTS, want)),
              "logits_rel_l2_vs_cpu_fp32": rel,
              "logits_max_abs_err": (got - ref).abs().max().item(),
              "ref_logits_max_abs": ref.abs().max().item(), "tol_rel_l2": LOGITS_REL_L2,
              "setup_s": setup_s, "cpu_reference_s": cpu_s, "ok": ok, "gpu": smi})
        if not ok:
            raise AssertionError(f"slice logits off the CPU fp32 reference: rel L2 {rel}")

    _DEFERRED.append(_CPU_WORK.submit(finish))
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
    if seq in AC_SEQUENCES:  # frames of 2 + 256 tokens, frame-causal, shared tables
        frames, pad = AC_SEQUENCES[seq]
        N = frames * 258 + pad
        pos = torch.arange(N, device=dev)
        kw["segment_ids"] = _ac_segments(dev, N, frames, pad)
    else:  # per-example positions, stack-padded with id 0 as the models pad
        pos, kv_valid = _seq_positions(dev, seqs[seq])
        N = pos.shape[1]
        if kv_valid is not None:
            kw["kv_valid_len"] = kv_valid
    (cos, sin), _ = expand_rope_cache(build_rope_cache(pos, D, 16, 16), D)
    kw["rope_expanded"] = (cos, sin)
    B = pos.shape[0] if pos.ndim == 2 else 8
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, D, N).astype(np.float32))
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
            ln.LAUNCHES_BWD, ln_qkv.LAUNCHES, ln_mlp.LAUNCHES, fa.LAUNCHES_FP32,
            fa.LAUNCHES_BWD_FP32, fdn.LAUNCHES_FP32, fdn.LAUNCHES_BWD_FP32, ln.LAUNCHES_FP32,
            ln.LAUNCHES_BWD_FP32, ln_qkv.LAUNCHES_FP32, ln_mlp.LAUNCHES_FP32)


def _check_fp32_route(phase: str, launches) -> dict:
    """Where a path's fp32 attention went, from its launches (in the order of
    KERNEL_COUNTS): B1/B2 at fp32 (the DN route, heads of 16-64) and the
    BHND fp32 kernels (wider heads). The fp32 paths' heads are 64 and 32:
    raises unless the DN route took some and the BHND kernels none."""
    by = dict(zip(KERNEL_COUNTS, launches))
    route = {"dn_fp32": by["b1_fp32"] + by["b2_fp32"],
             "bhnd_fp32": by["b3_fp32"] + by["bhnd_bwd_fp32"]}
    if route["dn_fp32"] == 0 or route["bhnd_fp32"]:
        raise AssertionError(f"{phase}: the fp32 attention took {route}, want the DN route "
                             "only (heads of 64 and 32)")
    return route


def _reset_launch_counts() -> None:
    from vjepa2_tpu_torch.ops import flash_attention as fa
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
    from vjepa2_tpu_torch.ops import layernorm as ln
    from vjepa2_tpu_torch.ops import ln_mlp, ln_qkv

    fdn.LAUNCHES = fdn.LAUNCHES_BWD = fa.LAUNCHES = fa.LAUNCHES_BWD = 0
    ln.LAUNCHES = ln.LAUNCHES_BWD = ln_qkv.LAUNCHES = ln_mlp.LAUNCHES = 0
    fa.LAUNCHES_FP32 = fa.LAUNCHES_BWD_FP32 = fdn.LAUNCHES_FP32 = fdn.LAUNCHES_BWD_FP32 = 0
    ln.LAUNCHES_FP32 = ln.LAUNCHES_BWD_FP32 = ln_qkv.LAUNCHES_FP32 = ln_mlp.LAUNCHES_FP32 = 0



# phase 6's clip-0 reference on the fp32 CPU path, by model: the initial
# weights, clip 0's masks, the loss and flattened gradients, and the bf16
# step's errors against it; phase train_fp32 reuses it. Under the key
# (model, "qkv,mlp"), train_fused's, which train_fused_fp32 reuses: its
# weights and masks (`_CLIP0_INPUTS`) when its card part runs, its CPU
# result when that ends on `_CPU_WORK` (before train_fused_fp32's record).
_CLIP0_CPU: dict = {}
_CLIP0_INPUTS: dict = {}
# the unfused fp32 ViT-L step's median ms (phase train_fp32), printed beside
# the fused one's
_FP32_STEP_MS: dict = {}


def _build_step_models(tp, model: str, fuse_ln: str, device, dtype):
    """Phase 6's (encoder, predictor) of ``model`` (`train.pretrain.build_models`)."""
    return tp.build_models(model, crop_size=SIZE, num_frames=FRAMES, pred_depth=12,
                           pred_embed_dim=384, pred_num_heads=12, use_rope=True,
                           num_mask_tokens=2, use_flash=True, dtype=dtype, device=device,
                           fuse_ln=fuse_ln)


class _Trainer:
    """One masked-pretrain run of phase 6 on the card: the models (random
    weights from a seeded generator), AdamW and the EMA target, the collator
    with fresh masks each step, one batch of clips (bf16; at fp32 the same
    values, drawn in bf16, so that phase 6's clip-0 reference holds)."""

    def __init__(self, dev, model: str, fuse_ln: str = "", dtype=torch.bfloat16):
        from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
        from vjepa2_tpu_torch.train import pretrain as tp
        from vjepa2_tpu_torch.train.state import TrainState

        self.dev, self.model, self.fuse_ln, self.tp = dev, model, fuse_ln, tp
        self.dtype = dtype
        self.phase, self.per_step = (TRAIN_CFGS if dtype == torch.bfloat16
                                     else FP32_STEPS)[(model, fuse_ln)]
        t0 = time.perf_counter()
        self.enc, self.pred = self.build(dev, dtype)
        tp.init_params(self.enc, self.pred, torch.Generator(device=dev).manual_seed(0))
        self.hp = tp.PretrainHParams(ipe=100, epochs=10)  # as `bench.py:bench_pretrain`
        self.state = TrainState.create(self.enc, self.pred,
                                       tp.make_optimizer(self.hp, self.enc, self.pred))
        self.train_step = tp.make_train_step(self.hp)
        self.coll = MaskCollator(MASK_CFGS, dataset_fpcs=[FRAMES], crop_size=(SIZE, SIZE))
        self.clips = torch.from_numpy(np.random.RandomState(0).rand(CLIPS, FRAMES, SIZE, SIZE, 3)
                                      .astype(np.float32)).to(dev, torch.bfloat16).to(dtype)
        self.setup_s = time.perf_counter() - t0

    def build(self, device, dtype):
        return _build_step_models(self.tp, self.model, self.fuse_ln, device, dtype)

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

    def clip0(self, defer: bool = False):
        """Clip 0's loss and gradients on the initial weights on the card,
        then in fp32 on the CPU through the plain path with the same fusions
        (after a few Adam steps the encoder's gradient norm falls ~2000x and
        bf16 noise dominates it): the record. With ``defer``, a function of no
        argument that runs the CPU part and gives the record, holding host
        copies only (the trainer and its card memory may go before it runs)."""
        tp, loss_exp, model, fuse_ln, dtype = (self.tp, self.hp.loss_exp, self.model,
                                               self.fuse_ln, self.dtype)
        depth = f"full ({len(self.enc.blocks)} + 12 layers)"
        me, mp = _masks(self.coll, CLIPS)
        me0, mp0 = [torch.from_numpy(m[:1]) for m in me], [torch.from_numpy(m[:1]) for m in mp]

        def loss_and_grads(e, p, tgt, x, me_, mp_):
            h = tp.target_features(tgt, x, mp_)
            e.zero_grad(set_to_none=True)
            p.zero_grad(set_to_none=True)
            loss = tp.forward_loss(e, p, x, me_, mp_, h, loss_exp)
            loss.backward()
            flat = [torch.cat([q.grad.float().flatten().cpu() for q in m.parameters()])
                    for m in (e, p)]
            return loss.item(), flat

        to_dev = lambda ms: [m.to(self.dev) for m in ms]  # noqa: E731
        ref = _CLIP0_CPU.get(model) if (dtype, fuse_ln) == (torch.float32, "") else None
        if ref is not None:  # phase 6's weights, masks and CPU result
            for m, key in ((self.enc, "encoder"), (self.pred, "predictor"),
                           (self.state.target_encoder, "encoder")):  # the target: a copy
                m.load_state_dict(ref["state"][key])
            me0, mp0 = ref["masks"]
        shared = (_CLIP0_INPUTS.pop((model, fuse_ln), None)
                  if dtype == torch.float32 and fuse_ln else None)
        if shared is not None:  # the bf16 fused step's weights and masks (train_fused)
            for m, state in zip((self.enc, self.pred, self.state.target_encoder),
                                shared["state"]):
                m.load_state_dict(state)
            me0, mp0 = shared["masks"]
        loss_gpu, (ge_gpu, gp_gpu) = loss_and_grads(self.enc, self.pred, self.state.target_encoder,
                                                    self.clips[:1], to_dev(me0), to_dev(mp0))

        def record(ref, cpu_s) -> dict:
            loss_cpu, (ge_cpu, gp_cpu) = ref["loss"], ref["grads"]
            tol = ({"loss_rel": TRAIN_LOSS_REL, "grad_rel_l2": TRAIN_GRAD_REL_L2}
                   if dtype == torch.bfloat16 else
                   {"loss_rel": FP32_TRAIN_LOSS_REL, "grad_rel_l2": FP32_TRAIN_GRAD_REL_L2})
            rec = {"loss_gpu": loss_gpu, "loss_cpu_fp32": loss_cpu,
                   "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
                   "encoder_grad_rel_l2": ((ge_gpu - ge_cpu).norm() / ge_cpu.norm()).item(),
                   "predictor_grad_rel_l2": ((gp_gpu - gp_cpu).norm() / gp_cpu.norm()).item(),
                   "tol": tol, "depth": depth, "cpu_reference_s": cpu_s}
            if cpu_s and (model, fuse_ln, dtype) == ("vit_large", "", torch.bfloat16):
                _CLIP0_CPU[model] = {**ref, "bf16_errors": {
                    k: rec[k] for k in ("loss_rel_err", "encoder_grad_rel_l2",
                                        "predictor_grad_rel_l2")}}
            if cpu_s and (model, fuse_ln, dtype) == ("vit_large", "qkv,mlp", torch.bfloat16):
                _CLIP0_CPU[(model, fuse_ln)] = ref
            return rec

        if ref is not None:
            return record(ref, 0.0)
        if shared is not None:  # train_fused's CPU result, on `_CPU_WORK` ahead of this

            def against_shared() -> dict:
                return record(_CLIP0_CPU.pop((model, fuse_ln)), 0.0)

            return against_shared if defer else against_shared()
        states = [{k: v.detach().to("cpu", copy=True) for k, v in m.state_dict().items()}
                  for m in (self.enc, self.pred, self.state.target_encoder)]
        clip = self.clips[:1].float().cpu()
        if (model, fuse_ln, dtype) == ("vit_large", "qkv,mlp", torch.bfloat16):
            _CLIP0_INPUTS[(model, fuse_ln)] = {"state": states, "masks": (me0, mp0)}

        def on_cpu() -> dict:
            torch.set_num_threads(os.cpu_count() or 1)
            t2 = time.perf_counter()
            enc_cpu, pred_cpu = _build_step_models(tp, model, fuse_ln, "cpu", torch.float32)
            tgt_cpu, _ = _build_step_models(tp, model, fuse_ln, "cpu", torch.float32)
            for m, state in zip((enc_cpu, pred_cpu, tgt_cpu), states):
                m.load_state_dict(state)
            loss_cpu, grads = loss_and_grads(enc_cpu, pred_cpu, tgt_cpu, clip, me0, mp0)
            return record({"state": {"encoder": enc_cpu.state_dict(),
                                     "predictor": pred_cpu.state_dict()},
                           "masks": (me0, mp0), "loss": loss_cpu, "grads": grads},
                          time.perf_counter() - t2)

        return on_cpu if defer else on_cpu()

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
    tol = c["tol"]
    return (c["loss_rel_err"] <= tol["loss_rel"] and c["encoder_grad_rel_l2"] <= tol["grad_rel_l2"]
            and c["predictor_grad_rel_l2"] <= tol["grad_rel_l2"])


def _step_record(tr: _Trainer, times, losses, norms, masks) -> dict:
    med = sorted(times)[len(times) // 2]
    return {"ms_per_step": times, "median_ms_per_step": med, "clips_per_s": CLIPS / (med / 1e3),
            "losses": losses, "grad_norms": norms,
            "mask_lengths": {"ctx": [m.shape[1] for m in masks[0]],
                             "pred": [m.shape[1] for m in masks[1]]},
            "launches_per_step": dict(zip(KERNEL_COUNTS, tr.per_step))}


def _timed_run(dev, tr: _Trainer, defer: bool = False) -> tuple[dict, tuple[int, ...]]:
    """Phase 6's run of a trainer: clip 0 against the fp32 CPU path (with
    ``defer``, its CPU part as a function, `_Trainer.clip0`), the warm-up with
    the EMA check, `TRAIN_STEPS` timed steps (their launches counted from 0),
    peak memory and finite gradients. Returns (the record's fields, the timed
    steps' launches)."""
    clip0 = tr.clip0(defer)
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
    return {"warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
            **_step_record(tr, times, losses, norms, masks), "peak_memory_gb": peak_gb,
            "launches": dict(zip(KERNEL_COUNTS, launches)), "ema_max_abs_err": ema_err,
            "ema_leaf": leaf, "clip0": clip0, "setup_s": tr.setup_s}, launches


# CPU references that phases hand to `_CPU_WORK` only when the run reaches
# the device-bound phases (`_run_phases` submits them before
# train_droid_fp32), so that they run beside card work that does not time
# the host; the phase's record prints when its reference ends.
_CPU_LATER: list = []


# phase 6's clip-0 CPU reference on `_CPU_WORK`, by model: train_fp32 waits
# for it (`_CLIP0_CPU` holds its result)
_CLIP0_DONE: dict = {}


def phase_train(dev, smi: str, model: str = "vit_large",
                defer_clip0: bool = False) -> tuple[int, ...]:
    """Phase 6's step (or train_huge's). Its clip-0 CPU reference, and so its
    record, runs on `_CPU_WORK`: at once, beside the next phases (phase 6's,
    `_CLIP0_DONE`), or with ``defer_clip0`` from `_CPU_LATER`."""
    tr = _Trainer(dev, model)
    rec, launches = _timed_run(dev, tr, True)
    phase = tr.phase
    del tr

    def finish() -> None:
        clip0 = rec["clip0"]() if callable(rec["clip0"]) else rec["clip0"]
        ok = _clip0_ok(clip0)
        emit({"phase": phase,
              "model": f"{model} 16f@256 bs8 + predictor (12 x 384, 12 heads) bf16, AdamW fp32",
              **rec, "clip0": clip0, "ok": ok, "gpu": smi})
        if not ok:
            raise AssertionError(f"clip-0 loss or gradients off the CPU fp32 reference: {clip0}")

    if defer_clip0:
        _CPU_LATER.append(finish)
    else:
        _CLIP0_DONE[model] = _CPU_WORK.submit(finish)
        _DEFERRED.append(_CLIP0_DONE[model])
    return launches


def phase_train_fused(dev, smi: str) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The fused ViT-L step (`fuse_ln="qkv,mlp"`) with the checks of phase 6,
    then the unfused step of phase 6 beside it, the two alternating step by
    step. Peak memory is each run's own: the fused one's over its warm-up
    before the unfused run exists, the unfused one's in phase `train`.
    Returns the launches of (the fused steps, the unfused steps)."""
    fused = _Trainer(dev, "vit_large", "qkv,mlp")
    clip0_cpu = fused.clip0(defer=True)  # its CPU part waits in `_CPU_LATER`
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
    rec = {name: _step_record(tr, times, losses, norms, masks)
           for name, (tr, times, losses, norms) in runs.items()}
    rec["fused"].update(peak_memory_gb=peak_gb,
                        launches=dict(zip(KERNEL_COUNTS, launches["fused"])))
    rec["unfused"]["launches"] = dict(zip(KERNEL_COUNTS, launches["unfused"]))
    setup_s = fused.setup_s

    def finish() -> None:
        clip0 = clip0_cpu()
        ok = _clip0_ok(clip0)
        emit({"phase": "train_fused",
              "model": "vit_large 16f@256 bs8 + predictor (12 x 384, 12 heads) bf16, AdamW "
                       "fp32, fuse_ln qkv,mlp",
              "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
              "order": f"unfused, fused; x{TRAIN_STEPS}",
              **rec, "fused_over_unfused_median": rec["fused"]["median_ms_per_step"]
              / rec["unfused"]["median_ms_per_step"],
              "ema_max_abs_err": ema_err, "ema_leaf": leaf, "clip0": clip0,
              "setup_s": setup_s, "ok": ok, "gpu": smi})
        if not ok:
            raise AssertionError(f"fused clip-0 loss or gradients off the CPU fp32 reference: "
                                 f"{clip0}")

    _CPU_LATER.append(finish)
    return launches["fused"], launches["unfused"]


def phase_train_fused_fp32(dev, smi: str) -> tuple[int, ...]:
    """train_fused's fused ViT-L step at fp32 (TF32 off): phase 6's run
    (`_timed_run`: the exact launches of `FP32_STEPS`, the EMA, finite
    gradients), clip 0 on train_fused's initial weights, clip and masks, held
    to train_fused's fp32 CPU result when that ends on `_CPU_WORK` (the
    record prints then). Returns the timed steps' launches."""
    tr = _Trainer(dev, "vit_large", "qkv,mlp", dtype=torch.float32)
    rec, launches = _timed_run(dev, tr, True)
    del tr
    unfused_ms = _FP32_STEP_MS.get("vit_large")

    def finish() -> None:
        clip0 = rec["clip0"]()
        ok = _clip0_ok(clip0)
        emit({"phase": "train_fused_fp32",
              "model": "vit_large 16f@256 bs8 + predictor (12 x 384, 12 heads), RoPE, fp32 "
                       "(TF32 off), AdamW fp32, fuse_ln qkv,mlp",
              **rec, "clip0": clip0,
              "clip0_reference": "train_fused's fp32 CPU path (its weights, clip and masks)",
              "unfused_fp32_median_ms_per_step": unfused_ms,
              "fused_over_unfused_fp32_median": (rec["median_ms_per_step"] / unfused_ms
                                                 if unfused_ms else None),
              "ok": ok, "gpu": smi})
        if not ok:
            raise AssertionError(f"fused fp32 clip-0 loss or gradients off the CPU fp32 "
                                 f"reference: {clip0}")

    _CPU_LATER.append(finish)
    return launches


class _LoopRecorder:
    """While active, wraps the trainer class the CLI builds (the `Pretrainer`,
    or with ``droid`` the `DroidTrainer`; restored on exit): every step's
    launches (the counts before and after it), the host clock at its start,
    step number, loss, lr and weight decay, and the Pretrainer's EMA momentum
    and masks or the DROID step's grad norm; each state ``restore_or_init``
    returns (``on_restore(trainer, state)`` runs first); each checkpoint
    save's host clock at its start, seconds and bytes (with ``skip_saves``
    the clock only: nothing is written). Nothing is
    synchronised or read back while the loop runs (the loss and masks stay
    on the card until exit), so the loop keeps its own syncs, at its log
    points and at the epoch's end."""

    def __init__(self, on_restore=None, droid: bool = False, skip_saves: bool = False):
        self.steps, self.states, self.saves, self.last = [], [], [], None
        self.on_restore, self.droid, self.skip_saves = on_restore, droid, skip_saves

    def __enter__(self):
        from vjepa2_tpu_torch.core.checkpoint import CheckpointManager
        from vjepa2_tpu_torch.train.droid_loop import DroidTrainer
        from vjepa2_tpu_torch.train.loop import Pretrainer

        cls = DroidTrainer if self.droid else Pretrainer
        self._patched = [(cls, "_step_fn", cls._step_fn),
                         (cls, "restore_or_init", cls.restore_or_init),
                         (CheckpointManager, "save", CheckpointManager.save)]
        make, restore, save = (orig for _, _, orig in self._patched)
        rec = self

        def step_fn(trainer, *key):
            fn = make(trainer, *key)

            def step(state, *args):
                before, n, t0 = _launch_counts(), state.step, time.perf_counter()
                metrics = fn(state, *args)
                groups = state.optimizer.opt.param_groups
                extra = ({"grad_norm": metrics["grad_norm"]} if rec.droid else
                         {"ema_momentum": metrics["ema_momentum"],
                          "masks": [m.clone() for m in (*args[1], *args[2])]})
                rec.steps.append({
                    "step": n, "t0": t0, "loss": metrics["loss"],
                    "launches": tuple(a - b for a, b in zip(_launch_counts(), before)),
                    "lr": groups[0]["lr"], "wd": groups[0]["weight_decay"], **extra})
                rec.last = (fn, state, *args)
                return metrics

            return step

        def restore_or_init(trainer):
            state = restore(trainer)
            if rec.on_restore is not None:
                rec.on_restore(trainer, state)
            rec.states.append((trainer, state))
            return state

        def timed_save(mgr, step, state):
            t0 = time.perf_counter()
            if rec.skip_saves:  # its start only: the end of the loop's last step
                rec.saves.append({"step": step, "t0": t0, "seconds": 0.0, "bytes": 0})
                return
            save(mgr, step, state)
            rec.saves.append({"step": step, "t0": t0, "seconds": time.perf_counter() - t0,
                              "bytes": os.path.getsize(mgr.path(step))})

        cls._step_fn, cls.restore_or_init = step_fn, restore_or_init
        CheckpointManager.save = timed_save
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self._patched:
            setattr(owner, name, orig)
        for s in self.steps:
            for k in ("loss", "grad_norm"):
                if isinstance(s.get(k), torch.Tensor):
                    s[k] = float(s[k])
            if "masks" in s and isinstance(s["masks"][0], torch.Tensor):
                s["masks"] = [m.cpu().numpy() for m in s["masks"]]
        return False

    def loop_ms_per_step(self) -> tuple[float, int]:
        """(ms a step, steps timed) of the loop as it runs: from the start of
        its second step to the start of the epoch's checkpoint save, which
        follows the loop's closing read-back of the losses."""
        steps = [s for s in self.steps if s["t0"] < self.saves[-1]["t0"]]
        ms = (self.saves[-1]["t0"] - steps[1]["t0"]) * 1e3
        return ms / (len(steps) - 1), len(steps) - 1

    def release(self):
        """Drop the trainers and states held (their memory on the card)."""
        import gc

        self.states.clear()
        self.last = None
        gc.collect()
        torch.cuda.empty_cache()


def _state_tensors(state):
    """(name, tensor) of a train state's `state_dict`: its models (three, or
    the DROID state's two) and AdamW's moments and per-parameter step counts."""
    sd = state.state_dict()
    for m in ("encoder", "predictor", "target_encoder"):
        yield from ((f"{m}.{k}", v) for k, v in sd.get(m, {}).items())
    for i, s in sd["optimizer"]["state"].items():
        yield from ((f"optimizer.{i}.{k}", v) for k, v in s.items())


def _run_config(raw: dict, dev, epochs=None) -> None:
    """The CLI's app for a config dict (`cli.main.APPS`: `run_vjepa` or
    `run_vjepa_droid`), on the card; ``data.datasets`` from disk, else
    synthetic clips."""
    import argparse

    from vjepa2_tpu_torch.cli.main import APPS
    from vjepa2_tpu_torch.core.config import PretrainConfig

    APPS[raw["app"]](PretrainConfig.from_dict(raw),
                     argparse.Namespace(synthetic_data=False, epochs=epochs, device=dev))


def _check_launches(phase: str, steps, want) -> None:
    for s in steps:
        if s["launches"] != want:
            raise AssertionError(f"{phase}: step {s['step']} launched "
                                 f"{dict(zip(KERNEL_COUNTS, s['launches']))}, want "
                                 f"{dict(zip(KERNEL_COUNTS, want))}")
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"{phase}: non-finite loss at step {s['step']}")


def _restore_check(part1):
    """(on_restore, record): the state of ``part1``'s run copied to the host
    (its recorder released), and a callback for the next run's recorder that
    holds the state it restores to that copy, bit for bit, into ``record``."""
    _, state1 = part1.states[0]
    saved = {k: v.detach().cpu() for k, v in _state_tensors(state1)}
    part1.release()
    del state1
    record = {}

    def compare(trainer, state):
        record["step"] = state.step
        record["tensors"] = len(saved)
        record["bit_equal"] = all(torch.equal(v.cpu(), saved[k])
                                  for k, v in _state_tensors(state)) \
            and sorted(k for k, _ in _state_tensors(state)) == sorted(saved)
        saved.clear()

    return compare, record


def _resume_checks(raw: dict, part2, folder: str, ipe: int) -> dict:
    """The resumed run's first step (step ``ipe``): the schedules' lr, weight
    decay and EMA momentum there, and the masks of an uninterrupted run (a
    fresh collator stepped once by init_state and once a step up to this
    one); the CSV's rows, two epochs' worth."""
    from vjepa2_tpu_torch.core import schedulers
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator

    first = part2.steps[0]
    trainer, _ = part2.states[0]
    hp = trainer.hp
    want = {"step": ipe,
            "lr": schedulers.warmup_cosine_lr(ipe, warmup_steps=hp.warmup_steps,
                                              start_lr=hp.start_lr, ref_lr=hp.lr,
                                              t_max=hp.total_steps, final_lr=hp.final_lr),
            "wd": schedulers.cosine_wd(ipe, ref_wd=hp.wd, t_max=hp.total_steps,
                                       final_wd=hp.final_wd),
            "ema_momentum": schedulers.ema_momentum(ipe, ema_start=hp.ema[0],
                                                    ema_end=hp.ema[1], t_max=hp.total_steps)}
    got = {k: first[k] for k in want}
    d = raw["data"]
    coll = MaskCollator(raw["mask"], dataset_fpcs=d["dataset_fpcs"],
                        crop_size=(d["crop_size"],) * 2, seed=raw["meta"]["seed"])
    for _ in range(ipe + 2):
        coll.step()
    me, mp = coll(d["dataset_fpcs"][0], d["batch_size"])
    masks_ok = all(np.array_equal(a, b) for a, b in zip(first["masks"], (*me, *mp)))
    with open(os.path.join(folder, "log_r0.csv")) as f:
        rows = [ln for ln in f.read().splitlines() if ln and not ln.startswith("epoch")]
    return {"resumed_first": got, "resumed_schedules_equal": got == want,
            "resumed_masks_equal": masks_ok, "csv_rows": len(rows),
            "ok": got == want and masks_ok and len(rows) == 2 * ipe}


def phase_train_loop(dev, smi: str) -> tuple[int, ...]:
    """The `Pretrainer` through the CLI's `run_vjepa` on the shipped ViT-H
    config (`LOOP_CONFIG`: batch 16, full remat, bf16, synthetic clips):
    epoch 0 (the resume is phase train_disk's since PR 20). Returns the
    launches of its steps."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="vjepa2_loop_")
    overrides = {"folder": folder, **LOOP_OVERRIDES}
    raw = overridden(LOOP_CONFIG, overrides)
    per_step = LOOP_LAUNCHES
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        with _LoopRecorder() as part1:
            _run_config(raw, dev, epochs=1)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        steps = part1.steps
        _check_launches("train_loop", steps, per_step)
        with open(os.path.join(folder, "log_r0.csv")) as f:
            rows = [ln for ln in f.read().splitlines() if ln and not ln.startswith("epoch")]
        if len(rows) != LOOP_IPE:
            raise AssertionError(f"train_loop: {len(rows)} CSV rows for {LOOP_IPE}")
        # one more step, synchronised and traced: its wall, device-busy time
        # and idle share, all from that one call
        fn, state, clips, me_, mp_ = part1.last
        traced = wall_and_busy(lambda: fn(state, clips, me_, mp_)["loss"].item())
        ms, n = part1.loop_ms_per_step()
        part1.release()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    launches = tuple(sum(s["launches"][i] for s in steps) for i in range(len(KERNEL_COUNTS)))
    emit({"phase": "train_loop", "config": LOOP_CONFIG_FILE,
          "overrides": {**overrides, "folder": "<temporary directory>"},
          "model": "vit_huge (32 x 1280, Dh 80) 16f@256 bs16 + predictor (12 x 384, 12 heads), "
                   "RoPE, bf16, full remat, synthetic clips",
          "steps": [{k: v for k, v in s.items() if k not in ("masks", "t0")} for s in steps],
          "loop_ms_per_step": ms, "clips_per_s": raw["data"]["batch_size"] / (ms / 1e3),
          "timed_steps": n, "one_traced_step": traced, "peak_memory_gb": peak_gb,
          "launches_per_step": dict(zip(KERNEL_COUNTS, per_step)),
          "checkpoint": [{k: v for k, v in c.items() if k != "t0"} for c in part1.saves],
          "csv_rows": len(rows), "seconds": time.perf_counter() - t0, "ok": True, "gpu": smi})
    return launches


def _models_on_cpu(state) -> dict:
    """A CPU copy of a train state's three models' tensors (the state's own
    are updated in place by the steps)."""
    return {m: {k: v.detach().cpu().clone() for k, v in getattr(state, m).state_dict().items()}
            for m in ("encoder", "predictor", "target_encoder")}


def _smoke_fp32_loop(dev, smi: str) -> tuple[int, ...]:
    """Phase train_fp32, part (a): the shipped fp32 smoke config
    (`SMOKE_CONFIG`) through `run_vjepa` on the card, epoch 0 and then a
    resumed epoch 1, and its first 3 losses against the same config and
    seed on the CPU from the card's initial weights. Returns the launches
    of the card's steps."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    folders = [tempfile.mkdtemp(prefix="vjepa2_smoke_") for _ in range(2)]
    overrides = {"folder": folders[0], **SMOKE_OVERRIDES}
    raw = overridden(SMOKE_CONFIG, overrides)
    ipe = raw["optimization"]["ipe"]
    try:
        init = {}

        def keep_init(trainer, state):  # the card's initial weights, for the CPU run
            init["models"] = _models_on_cpu(state)

        with _LoopRecorder(on_restore=keep_init) as part1:
            _run_config(raw, dev, epochs=1)
        _, state1 = part1.states[0]
        saved = {k: v.detach().cpu() for k, v in _state_tensors(state1)}
        part1.release()
        del state1
        restored = {}

        def compare(trainer, state):
            restored["step"] = state.step
            restored["bit_equal"] = all(torch.equal(v.cpu(), saved[k])
                                        for k, v in _state_tensors(state)) \
                and sorted(k for k, _ in _state_tensors(state)) == sorted(saved)

        with _LoopRecorder(on_restore=compare) as part2:
            _run_config(raw, dev, epochs=2)
        steps = part1.steps + part2.steps
        _check_launches("train_fp32", steps, SMOKE_LAUNCHES)
        route = _check_fp32_route("train_fp32", SMOKE_LAUNCHES)
        (ms1, n1), (ms2, n2) = part1.loop_ms_per_step(), part2.loop_ms_per_step()
        part2.release()
        with open(os.path.join(folders[0], "log_r0.csv")) as f:
            rows = [ln for ln in f.read().splitlines() if ln and not ln.startswith("epoch")]

        def load_init(trainer, state):
            for m, sd in init["models"].items():
                getattr(state, m).load_state_dict(sd)

        t_cpu = time.perf_counter()
        with _LoopRecorder(on_restore=load_init) as cpu:
            _run_config(overridden(raw, {"folder": folders[1]}), "cpu", epochs=1)
        cpu_s = time.perf_counter() - t_cpu
    finally:
        for folder in folders:
            shutil.rmtree(folder, ignore_errors=True)
    card, want = [s["loss"] for s in part1.steps[:3]], [s["loss"] for s in cpu.steps[:3]]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, want)]
    ok = (restored.get("bit_equal") and restored["step"] == ipe and len(rows) == 2 * ipe
          and len(rel) == 3 and max(rel) <= SMOKE_LOSS_RTOL)
    launches = tuple(sum(s["launches"][i] for s in steps) for i in range(len(KERNEL_COUNTS)))
    emit({"phase": "train_fp32", "part": "smoke loop", "config": SMOKE_CONFIG_FILE,
          "overrides": {**overrides, "folder": "<temporary directory>"},
          "model": "vit_tiny (12 x 192, Dh 64) 4f@64 bs4 + predictor (2 x 192, Dh 64), RoPE, "
                   "fp32, synthetic clips",
          "steps": [{k: v for k, v in s.items() if k not in ("masks", "t0")} for s in steps],
          "loop_ms_per_step": (ms1 * n1 + ms2 * n2) / (n1 + n2),
          "launches_per_step": dict(zip(KERNEL_COUNTS, SMOKE_LAUNCHES)), "fp32_route": route,
          "restored": restored, "csv_rows": len(rows),
          "first_losses": {"card": card, "cpu_fp32": want, "rel_err": rel,
                           "tol_rel": SMOKE_LOSS_RTOL},
          "cpu_reference_s": cpu_s, "seconds": time.perf_counter() - t0, "ok": bool(ok),
          "gpu": smi})
    if not ok:
        raise AssertionError(f"the fp32 smoke loop: restored {restored}, {len(rows)} CSV rows, "
                             f"first losses {card} against the CPU's {want}")
    return launches


def _vitl_fp32_step(dev, smi: str) -> tuple[int, ...]:
    """Phase train_fp32, part (b): phase 6's ViT-L step at fp32 (the model of
    `configs/train/vitl16/pretrain-256px-16f.yaml` with meta.dtype float32):
    phase 6's run (`_timed_run`, clip 0 against phase 6's fp32 CPU
    reference), then one more step traced. Returns the timed steps'
    launches."""
    done = _CLIP0_DONE.pop("vit_large", None)
    if done is not None:  # phase 6's reference on `_CPU_WORK`: `_CLIP0_CPU` then holds it
        done.result()
    tr = _Trainer(dev, "vit_large", dtype=torch.float32)
    rec, launches = _timed_run(dev, tr)
    _FP32_STEP_MS["vit_large"] = rec["median_ms_per_step"]
    route = _check_fp32_route("train_fp32", launches)
    bf16 = _CLIP0_CPU.pop("vit_large", {}).get("bf16_errors")
    traced = wall_and_busy(tr.step)
    clip0 = rec["clip0"]
    ok = _clip0_ok(clip0)
    # the bf16 step's clip-0 errors against these tolerances: it must miss them
    bf16_misses = bf16 is not None and (
        bf16["loss_rel_err"] > FP32_TRAIN_LOSS_REL
        and min(bf16["encoder_grad_rel_l2"], bf16["predictor_grad_rel_l2"]) > FP32_TRAIN_GRAD_REL_L2)
    emit({"phase": "train_fp32", "part": "vit_large step",
          "model": "vit_large 16f@256 bs8 + predictor (12 x 384, 12 heads), RoPE, fp32 "
                   "(TF32 off), AdamW fp32",
          **rec, "one_traced_step": traced, "fp32_route": route,
          "clip0_reference": "phase train's fp32 CPU path (the same weights, clip and masks)"
          if clip0["cpu_reference_s"] == 0.0 else "computed here",
          "bf16_clip0_errors": bf16, "bf16_misses_these_tolerances": bf16_misses,
          "ok": ok and bf16_misses, "gpu": smi})
    if not ok:
        raise AssertionError(f"fp32 clip-0 loss or gradients off the CPU fp32 reference: {clip0}")
    if not bf16_misses:
        raise AssertionError(f"phase 6's bf16 clip-0 errors {bf16} do not miss the fp32 "
                             "tolerances: they would not tell the fp32 step from the bf16 one")
    return launches


def phase_train_fp32(dev, smi: str) -> tuple[int, ...]:
    """The fp32 pretraining path: the shipped smoke loop, then the full-width
    ViT-L step at fp32. Returns the launches of both."""
    a = _smoke_fp32_loop(dev, smi)
    b = _vitl_fp32_step(dev, smi)
    return tuple(x + y for x, y in zip(a, b))


def phase_train_accum(dev, smi: str) -> tuple[int, ...]:
    """The `Pretrainer` through `run_vjepa` on the shipped ViT-L 64-frame
    cooldown (`ACCUM_CONFIG`: batch 12, grad_accum 6, save_attn_qkv_h) for 1
    warm-up and 1 timed step; then, on one microbatch of 2 clips, the
    gradients under the config's policy against no remat, and each policy's
    peak memory. Returns the launches of the loop's steps."""
    import shutil
    import tempfile

    from vjepa2_tpu_torch.models.modules import block_remat
    from vjepa2_tpu_torch.train import pretrain as tp

    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="vjepa2_accum_")
    overrides = {"folder": folder, **ACCUM_OVERRIDES}
    raw = overridden(ACCUM_CONFIG, overrides)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        with _LoopRecorder() as rec:
            _run_config(raw, dev)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        _check_launches("train_accum", rec.steps, ACCUM_LAUNCHES)
        trainer, state = rec.states[0]
        _, _, clips, me, mp = rec.last
        # microbatch 0 of the last step: 2 clips
        clips, me, mp = clips[0], [m[0] for m in me], [m[0] for m in mp]
        enc, pred = state.encoder, state.predictor
        policy = raw["model"]["remat_policy"]

        def loss_and_grads(name):
            """One forward and backward of the microbatch with every block
            under the policy ``name`` (None: no remat): (loss, flat fp32
            gradients, peak bytes above the start, host ms from a sync before
            to a sync after the backward)."""
            enc.remat = pred.remat = block_remat(name is not None, name)
            enc.zero_grad(set_to_none=True)
            pred.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t1 = time.perf_counter()
            h = tp.target_features(state.target_encoder, clips, mp)
            loss = tp.forward_loss(enc, pred, clips, me, mp, h, trainer.hp.loss_exp, [0, 1])
            loss.backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated(dev) - base
            grads = torch.cat([p.grad.float().flatten() for m in (enc, pred)
                               for p in m.parameters()])
            return loss.item(), grads, peak, ms

        loss_r, grads_r, _, _ = loss_and_grads(policy)
        loss_n, grads_n, _, _ = loss_and_grads(None)
        grad_rel = ((grads_r - grads_n).norm() / grads_n.norm()).item()
        grad_max_abs = (grads_r - grads_n).abs().max().item()
        loss_rel = abs(loss_r - loss_n) / abs(loss_n)
        bit_equal = loss_r == loss_n and torch.equal(grads_r, grads_n)
        del grads_r, grads_n
        # each policy: the peak and host ms of an untraced call, then the
        # wall, device-busy ms and idle share of one traced call
        micro = {}
        for name in (None, "full", "save_attn", "save_attn_qkv", "save_attn_qkv_h"):
            _, _, peak, ms = loss_and_grads(name)
            micro[name or "none"] = {"peak_gb_above_start": peak / 2**30, "ms": ms,
                                     **wall_and_busy(lambda: loss_and_grads(name))}
        peaks = {k: v["peak_gb_above_start"] for k, v in micro.items()}
        enc.remat = pred.remat = block_remat(True, policy)
        order = (peaks["full"] < peaks["save_attn"] <= peaks["save_attn_qkv"]
                 <= peaks["save_attn_qkv_h"])
        # one more loop step (6 microbatches), synchronised and traced
        fn, state_, clips_, me_, mp_ = rec.last
        traced = wall_and_busy(lambda: fn(state_, clips_, me_, mp_)["loss"].item())
        ms, timed = rec.loop_ms_per_step()
        rec.release()
        del state, state_, enc, pred, trainer
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    ok = bit_equal
    launches = tuple(sum(s["launches"][i] for s in rec.steps) for i in range(len(KERNEL_COUNTS)))
    emit({"phase": "train_accum", "config": ACCUM_CONFIG_FILE,
          "overrides": {**overrides, "folder": "<temporary directory>"},
          "model": "vit_large (24 x 1024, Dh 64) 64f@256 (8192 tokens) bs12 = 6 x 2 + predictor "
                   "(12 x 384, 12 heads), RoPE, bf16, save_attn_qkv_h, synthetic clips",
          "steps": [{k: v for k, v in s.items() if k not in ("masks", "t0")} for s in rec.steps],
          "warmup_steps": 1, "loop_ms_per_step": ms, "timed_steps": timed,
          "clips_per_s": raw["data"]["batch_size"] / (ms / 1e3), "peak_memory_gb": peak_gb,
          "one_traced_step": traced,
          "launches_per_step": dict(zip(KERNEL_COUNTS, ACCUM_LAUNCHES)),
          "checkpoint": [{k: v for k, v in c.items() if k != "t0"} for c in rec.saves],
          "microbatch_remat_vs_none": {"policy": policy, "loss_rel_err": loss_rel,
                                       "grad_rel_l2": grad_rel, "grad_max_abs": grad_max_abs,
                                       "tol": "bit-equal"},
          "microbatch_by_policy": micro, "peak_order_holds": order,
          "seconds": time.perf_counter() - t0, "ok": ok, "gpu": smi})
    if not ok:
        raise AssertionError(f"the cooldown microbatch's loss and gradients under {policy} are "
                             f"not bit-equal to the no-remat ones: loss {loss_rel}, gradients "
                             f"{grad_rel} relative L2, {grad_max_abs} max abs")
    return launches


def _droid_trajectory(trainer, predictor, target_encoder):
    """The DROID losses of the models on trajectory 0 of the trainer's
    loader, and their backward: ((loss, teacher forcing, rollout), the
    predictor's flat fp32 gradients on the CPU); the gradients are then
    cleared. On the card or the CPU, wherever the models are."""
    from vjepa2_tpu_torch.train.droid import droid_losses

    loader = trainer.make_loader()
    dev = next(predictor.parameters()).device
    clips, actions, states = (torch.from_numpy(x[:1]).to(dev)
                              for x in (loader.clips, loader.actions, loader.states))
    losses = droid_losses(predictor, target_encoder, trainer.hp, trainer.tpf, clips, actions,
                          states)
    losses[0].backward()
    grads = torch.cat([p.grad.float().flatten().cpu() for p in predictor.parameters()])
    predictor.zero_grad(set_to_none=True)
    return tuple(x.item() for x in losses), grads


# Trajectory 0 on the fp32 CPU path from the DROID trainer's initial
# weights, shared by phases train_droid_fp32 (first) and train_droid: the
# port keeps parameters in fp32 at both dtypes, so both start from the same
# weights (train_droid checks it). {"weights": train_droid_fp32's initial
# weights on the host, "same": whether train_droid's equal them,
# "finish_fp32": train_droid_fp32's check, which train_droid queues on
# `_CPU_WORK` after the reference; "cpu": (losses, gradients)}
_DROID_CPU: dict = {}


def _droid_cpu_reference(raw: dict, trainer) -> float:
    """Trajectory 0 in fp32 on the CPU from `_DROID_CPU`'s initial weights:
    sets _DROID_CPU["cpu"], returns its seconds."""
    from vjepa2_tpu_torch.train.droid import build_droid_models

    torch.set_num_threads(os.cpu_count() or 1)
    t1 = time.perf_counter()
    m = raw["model"]
    enc, pred = build_droid_models(
        model_name=m["model_name"], crop_size=raw["data"]["crop_size"],
        pred_depth=m["pred_depth"], pred_embed_dim=m["pred_embed_dim"],
        pred_num_heads=m["pred_num_heads"], uniform_power=m["uniform_power"],
        dtype=torch.float32, device="cpu")
    weights = _DROID_CPU.pop("weights")
    enc.load_state_dict(weights["target_encoder"])
    pred.load_state_dict(weights["predictor"])
    del weights
    _DROID_CPU["cpu"] = _droid_trajectory(trainer, pred, enc)
    return time.perf_counter() - t1


def _droid_models(state):
    return (("predictor", state.predictor), ("target_encoder", state.target_encoder))


def _host_weights(state) -> dict:
    return {k: {n: v.detach().to("cpu", copy=True) for n, v in m.state_dict().items()}
            for k, m in _droid_models(state)}


def _same_parameters(state, weights) -> bool:
    """Whether the state's models hold ``weights``' parameters, bit for bit."""
    return all(torch.equal(p.detach().cpu(), weights[k][n])
               for k, m in _droid_models(state) for n, p in m.named_parameters())


def _trajectory_errors(card, cpu) -> dict:
    (card_losses, card_grads), (cpu_losses, cpu_grads) = card, cpu
    return {"card": card_losses, "cpu": cpu_losses,
            "loss_rel_err": abs(card_losses[0] - cpu_losses[0]) / abs(cpu_losses[0]),
            "grad_rel_l2": ((card_grads - cpu_grads).norm() / cpu_grads.norm()).item()}


def phase_train_droid(dev, smi: str) -> tuple[int, ...]:
    """The `DroidTrainer` through the CLI's `run_vjepa_droid` on the shipped
    ViT-g DROID config (`DROID_CONFIG`: batch 8, 8 frames at 256 px, ViT-g
    depth 40, predictor depth 24, auto_steps 2, bf16, synthetic trajectories):
    epoch 0, then a new trainer on the same folder resumes and runs epoch 1.
    Before the first step, trajectory 0's losses and predictor gradients on
    the initial weights (the parameters of phase train_droid_fp32's, bit
    for bit), held to the fp32 CPU path from the same weights, which runs on
    `_CPU_WORK` beside the later phases (then train_droid_fp32's check; the
    records print when each ends). Returns the launches of all its steps."""
    import shutil
    import tempfile

    from vjepa2_tpu_torch.core import schedulers

    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="vjepa2_droid_")
    overrides = {"folder": folder, **DROID_OVERRIDES}
    raw = overridden(DROID_CONFIG, overrides)
    traj = {}

    def on_card(trainer, state):  # the initial weights: trajectory 0, and the same as fp32's
        traj["card"] = _droid_trajectory(trainer, state.predictor, state.target_encoder)
        _DROID_CPU["same"] = _same_parameters(state, _DROID_CPU["weights"])
        torch.cuda.reset_peak_memory_stats(dev)

    try:
        with _LoopRecorder(on_restore=on_card, droid=True) as part1:
            _run_config(raw, dev, epochs=1)
        _, state1 = part1.states[0]
        saved = {k: v.detach().to("cpu", copy=True) for k, v in _state_tensors(state1)}
        part1.release()
        del state1
        restored = {}

        def compare(trainer, state):  # the restored state against the saved one
            restored["step"] = state.step
            restored["tensors"] = len(saved)
            restored["bit_equal"] = all(torch.equal(v.cpu(), saved[k])
                                        for k, v in _state_tensors(state)) \
                and sorted(k for k, _ in _state_tensors(state)) == sorted(saved)

        with _LoopRecorder(on_restore=compare, droid=True) as part2:
            _run_config(raw, dev, epochs=2)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        del saved
        steps = part1.steps + part2.steps
        _check_launches("train_droid", steps, DROID_LAUNCHES)
        if not restored.get("bit_equal") or restored["step"] != DROID_IPE:
            raise AssertionError(f"the restored state is not the saved one: {restored}")
        if not _DROID_CPU["same"]:
            raise AssertionError("the bf16 and fp32 DROID trainers start from other weights")
        first = part2.steps[0]
        trainer, state = part2.states[0]
        hp = trainer.hp
        want = {"step": DROID_IPE,
                "lr": schedulers.wsd_lr(DROID_IPE, warmup_steps=hp.warmup_steps,
                                        anneal_steps=hp.anneal_steps, t_max=hp.total_steps,
                                        start_lr=hp.start_lr, ref_lr=hp.lr,
                                        final_lr=hp.final_lr),
                "wd": schedulers.cosine_wd(DROID_IPE, ref_wd=hp.wd, t_max=hp.total_steps,
                                           final_wd=hp.final_wd)}
        got = {k: first[k] for k in want}
        target_equal = all(torch.equal(v.cpu(), _DROID_CPU["weights"]["target_encoder"][k])
                           for k, v in state.target_encoder.named_parameters())
        with open(os.path.join(folder, "droid_log_r0.csv")) as f:
            rows = [ln for ln in f.read().splitlines() if ln and not ln.startswith("epoch")]
        if got != want or not target_equal or len(rows) != 2 * DROID_IPE:
            raise AssertionError(f"resume: {got} against {want}, target bit-equal "
                                 f"{target_equal}, {len(rows)} CSV rows for {2 * DROID_IPE}")
        # one more step, synchronised and traced: its wall, device-busy time
        # and idle share, all from that one call
        fn, state_, *batch = part2.last
        traced = wall_and_busy(lambda: fn(state_, *batch)["loss"].item())
        (ms1, n1), (ms2, n2) = part1.loop_ms_per_step(), part2.loop_ms_per_step()
        ms = (ms1 * n1 + ms2 * n2) / (n1 + n2)
        part2.release()
        del state, state_, fn, batch
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    launches = tuple(sum(s["launches"][i] for s in steps) for i in range(len(KERNEL_COUNTS)))
    record = {"phase": "train_droid", "config": DROID_CONFIG_FILE,
              "overrides": {**overrides, "folder": "<temporary directory>"},
              "model": "vit_giant_xformers target (40 x 1408, 22 heads of 64) over 64 single "
                       "frames of 256 tokens + AC predictor (24 x 1024, 16 heads of 64) over "
                       "1806 and 516 frame-causal tokens (stack-padded to 1808 and 520), bs8, "
                       "8f@256, auto_steps 2, RoPE, bf16, synthetic trajectories",
              "steps": [{k: v for k, v in s.items() if k != "t0"} for s in steps],
              "loop_ms_per_step": ms, "loop_ms_per_step_by_part": [ms1, ms2],
              "clips_per_s": raw["data"]["batch_size"] / (ms / 1e3), "timed_steps": n1 + n2,
              "one_traced_step": traced, "peak_memory_gb": peak_gb,
              "launches_per_step": dict(zip(KERNEL_COUNTS, DROID_LAUNCHES)),
              "checkpoint": [{k: v for k, v in c.items() if k != "t0"}
                             for c in part1.saves + part2.saves],
              "restored": restored, "resumed_first": got, "target_bit_equal": target_equal,
              "initial_weights_equal_train_droid_fp32": True, "csv_rows": len(rows),
              "card_s": time.perf_counter() - t0, "gpu": smi}
    card = traj.pop("card")

    def finish() -> None:  # the same trajectory on the CPU in fp32, then the check
        cpu_s = _droid_cpu_reference(raw, trainer)
        errs = _trajectory_errors(card, _DROID_CPU["cpu"])
        ok = errs["loss_rel_err"] <= TRAIN_LOSS_REL and errs["grad_rel_l2"] <= TRAIN_GRAD_REL_L2
        emit({**record, "trajectory_vs_cpu_fp32": {
            **errs, "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel_l2": TRAIN_GRAD_REL_L2}},
            "cpu_reference_s": cpu_s, "ok": ok})
        if not ok:
            raise AssertionError(f"DROID trajectory 0 off the CPU fp32 path: {errs}")

    _DEFERRED.append(_CPU_WORK.submit(finish))
    _DEFERRED.append(_CPU_WORK.submit(_DROID_CPU.pop("finish_fp32")))
    return launches


def _no_bf16(fn):
    """fn()'s result, and the ops it dispatched that made a bf16 tensor (none
    on an fp32 path, which casts nothing down)."""
    from torch.utils import _pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
                   for t in _pytree.tree_leaves(out)):
                seen.append(str(func))
            return out

    with Watch():
        out = fn()
    return out, sorted(set(seen))


def phase_train_droid_fp32(dev, smi: str) -> tuple[int, ...]:
    """The DROID trainer at fp32: `run_vjepa_droid` on the shipped ViT-g
    DROID config with ``meta.dtype: float32`` (`DROID_FP32_OVERRIDES`), one
    epoch of `DROID_IPE` steps (phase train_droid, after this one, covers
    the resume). Trajectory 0's losses and predictor gradients on the
    initial weights, no op of it making a bf16 tensor, are held at the fp32
    step's tolerances to the fp32 CPU trajectory that train_droid computes
    from the same weights (it checks that they are). Every step launches B1
    at fp32 88 times and B2 at fp32 48 (`DROID_FP32_LAUNCHES`), no bf16
    attention kernel and no BHND one. Returns the steps' launches."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="vjepa2_droid_fp32_")
    overrides = {"folder": folder, **DROID_FP32_OVERRIDES}
    raw = overridden(DROID_CONFIG, overrides)
    traj = {}

    def on_card(trainer, state):  # trajectory 0 on the initial weights, watched
        traj["card"], traj["bf16_ops"] = _no_bf16(
            lambda: _droid_trajectory(trainer, state.predictor, state.target_encoder))
        _DROID_CPU["weights"] = _host_weights(state)
        traj["dtypes"] = {"compute": str(trainer.dtype), "parameters": sorted(
            {str(p.dtype) for m in (state.predictor, state.target_encoder)
             for p in m.parameters()})}
        torch.cuda.reset_peak_memory_stats(dev)

    try:
        with _LoopRecorder(on_restore=on_card, droid=True) as part:
            _run_config(raw, dev, epochs=1)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        _check_launches("train_droid_fp32", part.steps, DROID_FP32_LAUNCHES)
        route = _check_fp32_route("train_droid_fp32", DROID_FP32_LAUNCHES)
        losses_finite = all(np.isfinite(s["loss"]) for s in part.steps)
        fn, state_, *batch = part.last
        traced = wall_and_busy(lambda: fn(state_, *batch)["loss"].item())
        ms, n = part.loop_ms_per_step()
        steps, saves = part.steps, part.saves
        part.release()
        del state_, fn, batch
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    launches = tuple(sum(s["launches"][i] for s in steps) for i in range(len(KERNEL_COUNTS)))
    record = {"phase": "train_droid_fp32", "config": DROID_CONFIG_FILE,
              "overrides": {**overrides, "folder": "<temporary directory>"},
              "model": "phase train_droid's models and batch at fp32 (TF32 off): the "
                       "vit_giant_xformers target and the AC predictor on B1 and B2 at fp32 "
                       "(the DN route), frame-causal ids with the pad keys on int32-max",
              "fp32_route": route,
              "steps": [{k: v for k, v in s.items() if k != "t0"} for s in steps],
              "loop_ms_per_step": ms, "timed_steps": n,
              "clips_per_s": raw["data"]["batch_size"] / (ms / 1e3),
              "one_traced_step": traced, "peak_memory_gb": peak_gb,
              "launches_per_step": dict(zip(KERNEL_COUNTS, DROID_FP32_LAUNCHES)),
              "checkpoint": [{k: v for k, v in c.items() if k != "t0"} for c in saves],
              "losses_finite": losses_finite, "dtypes": traj["dtypes"],
              "bf16_ops_in_trajectory": traj["bf16_ops"],
              "card_s": time.perf_counter() - t0, "gpu": smi}
    card = traj["card"]

    def finish() -> None:  # queued by train_droid, after its CPU reference
        cpu = _DROID_CPU.pop("cpu")
        errs = _trajectory_errors(card, cpu)
        ok = (errs["loss_rel_err"] <= FP32_TRAIN_LOSS_REL
              and errs["grad_rel_l2"] <= FP32_TRAIN_GRAD_REL_L2 and _DROID_CPU.pop("same")
              and losses_finite and not record["bf16_ops_in_trajectory"])
        emit({**record, "initial_weights_equal_train_droid": True,
              "trajectory_vs_cpu_fp32": {**errs, "tol": {
                  "loss_rel": FP32_TRAIN_LOSS_REL, "grad_rel_l2": FP32_TRAIN_GRAD_REL_L2},
                  "reference": "phase train_droid's fp32 CPU trajectory (the same weights)"},
              "ok": ok})
        if not ok:
            raise AssertionError(f"train_droid_fp32: trajectory 0 {errs}, losses finite "
                                 f"{losses_finite}, bf16 ops {record['bf16_ops_in_trajectory']}")

    _DROID_CPU["finish_fp32"] = finish
    return launches


def _ring_hop_ids(dev, B, N):
    """A ring hop's segment ids [B, N]: frames 4-11 of queries, 0-15 of keys."""
    seg_q = (torch.arange(8, device=dev, dtype=torch.int32) + 4).repeat_interleave(N // 8)
    seg_k = torch.arange(16, device=dev, dtype=torch.int32).repeat_interleave(N // 16)
    return seg_q[None].expand(B, N), seg_k[None].expand(B, N)


def _given_lse(lse, feats):
    """The lse a row's backward is given: a ring's global one (this hop's
    mass and another's) where the row says so, else the forward's."""
    return torch.logaddexp(lse, lse - 0.7) if feats.get("global_lse") else lse


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
    if feats.get("seg_kv"):
        seg_q, seg_k = _ring_hop_ids(dev, B, N)
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


def _sorted_seqs(me, mp, prefix=""):
    seqs = {f"{prefix}ctx{i}": np.sort(m, axis=1) for i, m in enumerate(me)}
    seqs.update({f"{prefix}pred{i}": np.sort(np.concatenate([a, b], axis=1), axis=1)
                 for i, (a, b) in enumerate(zip(me, mp))})
    return seqs


def _mask_seqs():
    """Sorted per-example positions of one collator step at batch 8: the
    context (``ctx0``, ``ctx1``) and the predictor's context + targets
    (``pred0``, ``pred1``) of each mask config; and the cooldown's
    (``cool_*``, `_cooldown_seqs`)."""
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator

    me, mp = _masks(MaskCollator(MASK_CFGS, dataset_fpcs=[FRAMES], crop_size=(SIZE, SIZE)), 8)
    return {**_sorted_seqs(me, mp), **_cooldown_seqs(), "ek100_pred": _ek100_positions()}


def _ek100_positions():
    """The EK100 predictor's positions [16, 2304] as `anticipative_features`
    gives them for the eval's synthetic batches (every clip 1 s ahead at 4
    fps, 2 tubelet steps): the clip's 2048 tokens, then 256 targets from
    2048 + 2 x 256 = 2560."""
    d = EVAL_ANTICIPATION_CONFIG["experiment"]["data"]
    tokens, per_frame = (FRAMES // 2) * (SIZE // 16) ** 2, (SIZE // 16) ** 2
    steps = int(d["anticipation_time"][0] * d["frames_per_second"] / 2)
    row = np.concatenate([np.arange(tokens), tokens + per_frame * steps + np.arange(per_frame)])
    return np.tile(row, (EVAL_ANTICIPATION_CONFIG["experiment"]["optimization"]["batch_size"], 1))


def _cooldown_seqs():
    """The cooldown's sequences (``cool_ctx0``, ``cool_ctx1``, ``cool_pred0``,
    ``cool_pred1``) for one microbatch of 2 clips: the first step of the
    config's collator (64 frames at 256 px, seed 239): contexts of 2302 and
    568 of 8192 tokens, predictor sequences of 6479 and 6471."""
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator

    d = ACCUM_CONFIG["data"]
    coll = MaskCollator(ACCUM_CONFIG["mask"], dataset_fpcs=d["dataset_fpcs"],
                        crop_size=(d["crop_size"],) * 2, seed=ACCUM_CONFIG["meta"]["seed"])
    coll.step()
    me, mp = coll(d["dataset_fpcs"][0], 2)
    return _sorted_seqs(me, mp, "cool_")


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

        with torch.no_grad():
            out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
            lse = _given_lse(lse, feats)
            got = fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)
            q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
            out_p, lse_p = fa.flash_attention_bhnd_plain(q32, k32, v32, **kw)
            want = fa.flash_attention_bhnd_bwd_plain(q32, k32, v32, out_p,
                                                     _given_lse(lse_p, feats), do32, **kw)
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


def _ln_case(dev, R, C, dtype=torch.bfloat16):
    """(x, dy, gamma, beta) for one B6 shape: random rows and cotangent in
    ``dtype`` (bf16 or fp32), a random fp32 affine."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(R, C) * 2 + 0.3).astype(np.float32)).to(dev, dtype)
    dy = torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(dev, dtype)
    gamma = torch.from_numpy((rng.randn(C) * 0.5 + 1).astype(np.float32)).to(dev)
    beta = torch.from_numpy((rng.randn(C) * 0.5).astype(np.float32)).to(dev)
    return x, dy, gamma, beta


def ln_yardsticks(x, dy, gamma, beta):
    """`F.layer_norm` (the affine in x's dtype) and its autograd backward on
    B6's inputs: the yardsticks, never on the port's path."""
    import torch.nn.functional as F

    C = x.shape[-1]
    g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
    leaves = [t.detach().requires_grad_() for t in (x, g16, b16)]
    with torch.enable_grad():
        out = F.layer_norm(leaves[0], (C,), leaves[1], leaves[2], 1e-6)
    return (lambda: F.layer_norm(x, (C,), g16, b16, 1e-6),
            lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))


def phase_kernels_ln(dev, smi: str, dtype=torch.bfloat16) -> tuple[dict, dict]:
    """B6 forward and backward on ``dtype`` rows (bf16, or fp32: phase
    kernel_ln_fp32) against their plain versions; `F.layer_norm` (the affine
    in that dtype) and its autograd backward as the yardsticks. ``ms`` is
    CUDA events around 20 back-to-back calls (host time where it exceeds the
    device's); ``device_ms`` the kernels' own time by the profiler, cold L2."""
    from vjepa2_tpu_torch.ops import layernorm as ln

    fp32 = dtype == torch.float32
    suffix = "_fp32" if fp32 else ""
    stat_atol, rstd_rtol, atol, rtol, param_rel_l2 = (
        (LN_FP32_STAT_ATOL, LN_FP32_RSTD_RTOL, LN_FP32_ATOL, LN_FP32_RTOL, LN_FP32_PARAM_REL_L2)
        if fp32 else (LN_STAT_ATOL, LN_RSTD_RTOL, LN_ATOL, LN_RTOL, LN_PARAM_REL_L2))
    firsts = [None, None]
    for name, (R, C) in LN_SHAPES:
        x, dy, gamma, beta = _ln_case(dev, R, C, dtype)
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
            ok_fwd = (_within(y, y_p, atol, rtol) and fwd_err["mean"] <= stat_atol
                      and fwd_err["rstd_rel"] <= rstd_rtol)
            bwd_err = {"dx": (grads[0].float() - grads_p[0]).abs().max().item(),
                       "dgamma_rel_l2": _rel_l2(grads[1], grads_p[1]),
                       "dbeta_rel_l2": _rel_l2(grads[2], grads_p[2])}
            ok_bwd = (_within(grads[0], grads_p[0], atol, rtol)
                      and bwd_err["dgamma_rel_l2"] <= param_rel_l2
                      and bwd_err["dbeta_rel_l2"] <= param_rel_l2)
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
                 {"y": f"{atol} + {rtol}*|plain|", "mean": stat_atol, "rstd_rel": rstd_rtol}),
                ("layernorm_bwd", bwd_err, ok_bwd,
                 {"dx": f"{atol} + {rtol}*|plain|", "dgamma/dbeta_rel_l2": param_rel_l2}))):
            part = kernel[-3:]
            kernel += suffix
            dev_ms, by_kernel = dev_times[part]
            rec = {"phase": "kernel_ln" + suffix, "kernel": kernel, "shape": name,
                   "rows": [R, C], "dtype": str(dtype).split(".")[-1],
                   "ms": times[part][0], "plain_ms": times[part][1], "library_ms": times[part][2],
                   "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
                   "library_device_ms": library_dev[part],
                   "library": f"F.layer_norm ({'fp32' if fp32 else 'bf16'} affine)"
                              + (" backward" if i else ""),
                   "bound_ms": bounds[part][0], "bound_by": bounds[part][1],
                   "bound_share": bounds[part][0] / dev_ms, "errors": err,
                   "max_abs_err": err["y" if i == 0 else "dx"], "tol": tol, "ok": ok, "gpu": smi}
            emit(rec)
            if not ok:
                raise AssertionError(f"{kernel} disagrees with its plain version at {name}")
            firsts[i] = firsts[i] or rec
    return firsts[0], firsts[1]


def _prologue_case(dev, B, N, C, H, D, hidden, tables, real, seqs, kernel,
                   dtype=torch.bfloat16):
    """(x, gamma, beta, w, bias, rope) for one B7 or B8 shape: random x in
    ``dtype`` (bf16 or fp32) with the stack-pad rows zero, a random
    LayerNorm affine, W in ``dtype`` scaled by 1/sqrt(C), a random fp32 bias,
    the RoPE tables of the shape (B7)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(B, N, C) * 1.5 + 0.2).astype(np.float32))
    if real is not None:
        x[:, real:] = 0.0
    x = x.to(dev, dtype)
    gamma = torch.from_numpy((rng.randn(C) * 0.5 + 1).astype(np.float32)).to(dev)
    beta = torch.from_numpy((rng.randn(C) * 0.5).astype(np.float32)).to(dev)
    n_out = 3 * H * D if kernel == "ln_qkv" else hidden
    w = torch.from_numpy((rng.randn(n_out, C) / np.sqrt(C)).astype(np.float32))
    w = w.to(dev, dtype)
    bias = torch.from_numpy((rng.randn(n_out) * 0.5).astype(np.float32)).to(dev)
    rope = _rope_tables(dev, B, N, D, tables, seqs) if kernel == "ln_qkv" else None
    return x, gamma, beta, w, bias, rope


def phase_kernels_prologue(dev, smi: str, kernel: str, dtype=torch.bfloat16) -> dict:
    """B7 (``kernel="ln_qkv"``) or B8 (``"ln_mlp"``) on ``dtype`` operands
    (bf16, or fp32: phases kernel_ln_qkv_fp32 / kernel_ln_mlp_fp32) against
    its plain version; the unfused chain `F.layer_norm` -> `F.linear` -> RoPE
    or `F.gelu` in that dtype as the yardstick (there is no single PyTorch
    call for either)."""
    import torch.nn.functional as F

    from vjepa2_tpu_torch.ops import ln_mlp, ln_qkv
    from vjepa2_tpu_torch.ops.rope import rope_rotate

    fp32 = dtype == torch.float32
    suffix = "_fp32" if fp32 else ""
    seqs, first = _mask_seqs(), None
    for name, B, N, C, H, D, hidden, tables, real in PROLOGUE_SHAPES:
        x, gamma, beta, w, bias, rope = _prologue_case(dev, B, N, C, H, D, hidden, tables, real,
                                                       seqs, kernel, dtype)
        g16, b16, bias16 = gamma.to(dtype), beta.to(dtype), bias.to(dtype)
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
            library = ("chain: F.layer_norm -> F.linear -> split-half RoPE (fp32)"
                       + (", all fp32 (TF32 off)" if fp32 else ""))
        else:
            run = lambda: (ln_mlp.ln_mlp(x, gamma, beta, w, bias),)  # noqa: E731
            plain = lambda: (ln_mlp.ln_mlp_plain(x, gamma, beta, w, bias),)  # noqa: E731
            def chain():
                return F.gelu(F.linear(F.layer_norm(x, (C,), g16, b16, 1e-6), w, bias16))

            library = "chain: F.layer_norm -> F.linear -> F.gelu" + (
                ", fp32 (TF32 off)" if fp32 else "")
        with torch.no_grad():
            got, want = run(), plain()
            torch.cuda.synchronize()
            errs = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
            if fp32:
                fp32_errs = [_fp32_errors(g, p) for g, p in zip(got, want)]
                ok = all(_fp32_ok(e) for e in fp32_errs)
            else:
                ok = all(_within(g, p, PROLOGUE_ATOL, PROLOGUE_RTOL) for g, p in zip(got, want))
            ms = cuda_ms(run, 20)
            plain_ms = cuda_ms(plain, 3)
            library_ms = cuda_ms(chain, 20)
        R, n_out = B * N, w.shape[0]
        # the product on the tensor cores (fp32-accurate at fp32: three TF32
        # products each); mean and rstd [R] fp32 are written too
        bound_ms, bound_by = bound(2 * R * C * n_out,
                                   nbytes(x, gamma, beta, w, bias, *(rope or ()), *got) + 8 * R,
                                   PEAK_3XTF32 if fp32 else PEAK_FLOPS)
        rec = {"phase": f"kernel_{kernel}{suffix}", "kernel": kernel + suffix, "shape": name,
               "bnc": [B, N, C], "out_features": n_out, "dtype": str(dtype).split(".")[-1],
               **({"heads": H, "head_dim": D, "tables": tables} if kernel == "ln_qkv" else {}),
               "real_tokens": real, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": library, "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": 2 * R * C * n_out / ms / 1e9, "bound_share": bound_ms / ms,
               "max_abs_err": max(errs),
               **({"errors": fp32_errs,
                   "tol": {"rel_l2": FP32_REL_L2, "max_abs": f"{FP32_MAX_ABS}*max|plain|"}}
                  if fp32 else {"tol": f"{PROLOGUE_ATOL} + {PROLOGUE_RTOL}*|plain|"}),
               "ok": ok, "gpu": smi}
        emit(rec)
        if not ok:
            raise AssertionError(f"{kernel}{suffix} disagrees with its plain version at {name}")
        first = first or rec
        del x, w, got, want
    return first


def _plain_rows(B, H, N, M):
    """The query chunk of the fp32 plain reference, or None for whole rows."""
    row_bytes = B * H * M * 4
    if row_bytes * N <= FP32_PLAIN_WHOLE:
        return None
    rows = 512
    while rows > 1 and rows * row_bytes > FP32_PLAIN_CHUNK:
        rows //= 2
    return rows


@contextlib.contextmanager
def _plain_in_query_chunks(rows: int):
    """While active, the plain BHND forward (the probes' route without
    ``use_flash``) runs over chunks of ``rows`` queries: the same function
    row by row, without the whole [B, H, N, M] fp32 scores."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    whole = fa._plain_fwd

    def chunked(q, k, v, *args):
        parts = [whole(q[:, :, i:i + rows], k, v, *args) for i in range(0, q.shape[2], rows)]
        return torch.cat([o for o, _ in parts], 2), torch.cat([lse for _, lse in parts], 2)

    fa._plain_fwd = chunked
    try:
        yield
    finally:
        fa._plain_fwd = whole


def fp32_plain_fwd(q, k, v, rows=None, **kw):
    """`flash_attention_bhnd_plain`, whole or over chunks of ``rows`` queries
    (those without RoPE: the tables follow the query rows)."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    assert not (rows and kw), "RoPE and the masks run whole rows"
    with _plain_in_query_chunks(rows) if rows else contextlib.nullcontext():
        return fa.flash_attention_bhnd_plain(q, k, v, **kw)


def fp32_plain_bwd(q, k, v, out, lse, do, rows=None, **kw):
    """`flash_attention_bhnd_bwd_plain`, whole or over chunks of ``rows``
    queries (dk and dv summed over the chunks; without RoPE)."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    N = q.shape[2]
    assert not (rows and kw), "RoPE and the masks run whole rows"
    rows = rows or N
    dq, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
    for i in range(0, N, rows):
        sl = slice(i, i + rows)
        g = fa.flash_attention_bhnd_bwd_plain(q[:, :, sl], k, v, out[:, :, sl], lse[:, :, sl],
                                              do[:, :, sl], **kw)
        dq.append(g[0])
        dk += g[1]
        dv += g[2]
    return torch.cat(dq, 2), dk, dv


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend `F.scaled_dot_product_attention` picks for these operands
    (and ``attn_mask`` or ``is_causal``)."""
    from torch.nn.attention import SDPBackend

    names = {int(b): name for name, b in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q, k, v, **kw)), "unknown")


def _fp32_errors(got, want) -> dict:
    g, w = got.double(), want.double()
    return {"rel_l2": ((g - w).norm() / w.norm()).item(), "max_abs_err": (g - w).abs().max().item(),
            "max_abs_plain": w.abs().max().item(), "finite": bool(torch.isfinite(got).all())}


def _fp32_ok(e: dict) -> bool:
    return e["finite"] and e["rel_l2"] <= FP32_REL_L2 and e["max_abs_err"] <= (
        FP32_MAX_ABS * e["max_abs_plain"])


def _fp32_library_operands(q, k, v, do, kw):
    """`F.scaled_dot_product_attention`'s fp32 operands for a call: q and k
    rotated in fp32 (as the pre-pass rotates them), k and v cut to the
    first kv_valid keys, so that it computes the kernel's function without
    a mask."""
    from vjepa2_tpu_torch.ops.rope import rope_rotate

    if "rope_expanded" in kw:
        cos, sin = (t[:, None] for t in kw["rope_expanded"])
        q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
    kv = kw.get("kv_valid_len") or k.shape[2]
    return q, k[:, :, :kv].contiguous(), v[:, :, :kv].contiguous(), do


def _fp32_library_ms(q, k, v, do, kw, lib_kw, kinds, iters, rows) -> tuple[dict, str]:
    """`F.scaled_dot_product_attention`'s ms on a call's fp32 operands
    (`_fp32_library_operands`, token-major [B, H, N, D]; ``lib_kw``: its
    mask), forward and, in ``kinds``, backward, and the backend it picked;
    None where its math backend would hold the whole scores (``rows``)."""
    import torch.nn.functional as F

    with torch.no_grad():
        lq, lk, lv, ldo = (t.contiguous() for t in _fp32_library_operands(q, k, v, do, kw))
        backend = sdpa_backend(lq, lk, lv, **lib_kw)
    library_ms = {"fwd": None, "bwd": None}
    if backend != "MATH" or rows is None:
        with torch.no_grad():
            library_ms["fwd"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(lq, lk, lv, **lib_kw), iters["fwd"])
        if "bwd" in kinds:
            leaves = [t.detach().requires_grad_() for t in (lq, lk, lv)]
            with torch.enable_grad():
                ref = F.scaled_dot_product_attention(*leaves, **lib_kw)
                library_ms["bwd"] = cuda_ms(
                    lambda: torch.autograd.grad(ref, leaves, ldo, retain_graph=True),
                    iters["bwd"])
    return library_ms, backend


def _fp32_masks(dev, B, N, feats) -> dict:
    """The segment ids or causal flag of an `FP32_SHAPES` row, as kwargs."""
    if "ac" in feats:
        frames, pad = feats["ac"]
        return {"segment_ids": _ac_segments(dev, N, frames, pad)}
    if feats.get("seg_kv"):
        seg_q, seg_k = _ring_hop_ids(dev, B, N)
        return {"segment_ids": seg_q, "seg_kv": seg_k}
    if feats.get("causal"):
        return {"causal": True}
    if feats.get("ids") == "past 2**24":  # 4 frames, ids 2**24 and 2**24 + 1 in turn
        seg = (1 << 24) + torch.arange(N, device=dev, dtype=torch.int32) // (N // 4) % 2
        return {"segment_ids": seg}
    if feats.get("ids") == "no key":  # queries of frame 0; keys of frames 1-4
        seg = torch.arange(N, device=dev, dtype=torch.int32) // (N // 4)
        return {"segment_ids": seg, "seg_kv": seg + 1}
    return {}


def _lse_errors(lse, want) -> dict:
    """The largest |lse - plain| over the rows with a key, and whether lse is
    -inf exactly where the plain version's is (the rows with none)."""
    empty = torch.isneginf(want)
    err = (lse - want)[~empty].abs().max().item() if not empty.all() else 0.0
    return {"max_abs_err": err, "empty_rows": int(empty.sum().item()),
            "empty_rows_match": bool(torch.equal(torch.isneginf(lse), empty))}


def phase_kernels_fp32(dev, smi: str) -> tuple[dict, dict]:
    """The fp32 BHND kernels (`csrc/flash_fp32.cuh`) against their plain
    versions at `FP32_SHAPES`, forward and backward (given the kernel's out
    and lse, or a ring's global lse), the plain version over query chunks
    where its scores do not fit; each timed by CUDA events with its TFLOP/s
    over the (query, key) pairs the masks leave and its bound
    (`PEAK_3XTF32`: fp32-accurate products on the tensor cores), beside the
    plain version and `F.scaled_dot_product_attention` on the same fp32
    operands (TF32 off; q and k pre-rotated, k and v cut to kv_valid, the
    segment ids as the equivalent boolean mask), with the backend PyTorch
    picked. Rows with no key to attend: out 0, lse -inf and dq 0 there.
    Then B1 and B2 at fp32 (`_dn_fp32_rows`). Returns a record of each of
    the four: the BHND kernels' at `FP32_BHND_MAIN_ROW`, the DN calls'
    first."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    seqs, firsts = _mask_seqs(), [None, None]
    for name, (B, H, N, D), feats in FP32_SHAPES:
        gen = torch.Generator(dev).manual_seed(0)
        q, k, v, do = (torch.randn(B, H, N, D, generator=gen, device=dev) for _ in range(4))
        kw = _fp32_masks(dev, B, N, feats)
        if feats.get("rope"):
            kw["rope_expanded"] = _rope_tables(dev, B, N, D, feats["rope"], seqs)
        if "kv_valid_len" in feats:
            kw["kv_valid_len"] = feats["kv_valid_len"]
        seg_q = kw.get("segment_ids")
        seg_q = None if seg_q is None else seg_q.expand(B, N)
        seg_k = kw.get("seg_kv", seg_q)
        seg_k = None if seg_k is None else seg_k.expand(B, N)
        mask = pair_mask(B, N, N, dev, kw.get("kv_valid_len"), seg_q, seg_k,
                         kw.get("causal", False))
        rows = _plain_rows(B, H, N, N)
        pairs = attended_pairs(B, H, N, N, mask)
        kinds = ("fwd",) if feats.get("fwd_only") else ("fwd", "bwd")
        flops = {"fwd": 4 * D * pairs, "bwd": 10 * D * pairs}
        iters = {kind: max(2, min(20, int(4e12 / f))) for kind, f in flops.items()}
        with torch.no_grad():
            out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
            out_p, lse_p = fp32_plain_fwd(q, k, v, rows, **kw)
            glse = _given_lse(lse, feats)
            errs = {"fwd": {"out": _fp32_errors(out, out_p)}}
            lse_errs = _lse_errors(lse, lse_p)
            empty = torch.isneginf(lse_p)
            empty_ok = not out[empty].any()
            grads = None
            if "bwd" in kinds:
                grads = fa.flash_attention_bhnd_bwd(q, k, v, out, glse, do, **kw)
                want = fp32_plain_bwd(q, k, v, out, glse, do, rows, **kw)
                errs["bwd"] = {n_: _fp32_errors(g, w)
                               for n_, g, w in zip(("dq", "dk", "dv"), grads, want)}
                empty_ok = empty_ok and not grads[0][empty].any()
                del want
            torch.cuda.synchronize()
            kv = kw.get("kv_valid_len") or N
            zero_past_kv = grads is None or not (grads[1][:, :, kv:].any()
                                                 or grads[2][:, :, kv:].any())
            del out_p, lse_p
            ms = {"fwd": cuda_ms(lambda: fa.flash_attention_bhnd(q, k, v, **kw), iters["fwd"])}
            plain_ms = {"fwd": cuda_ms(lambda: fp32_plain_fwd(q, k, v, rows, **kw), 1, warmup=1)}
            if "bwd" in kinds:
                ms["bwd"] = cuda_ms(
                    lambda: fa.flash_attention_bhnd_bwd(q, k, v, out, glse, do, **kw),
                    iters["bwd"])
                plain_ms["bwd"] = cuda_ms(
                    lambda: fp32_plain_bwd(q, k, v, out, glse, do, rows, **kw), 1, warmup=1)
        lib_kw = ({"is_causal": True} if kw.get("causal") else
                  {"attn_mask": mask} if seg_q is not None else {})
        library_ms, backend = _fp32_library_ms(q, k, v, do, kw, lib_kw, kinds, iters, rows)
        side = [*kw.get("rope_expanded", ()), *(t for t in (seg_q, seg_k) if t is not None)]
        sizes = {"fwd": nbytes(q, k, v, out, lse, *side),
                 "bwd": nbytes(q, k, v, out, do, lse, *side, *(grads or ()))}
        for i, (kernel, kind) in enumerate((("flash_fwd_fp32", "fwd"),
                                            ("flash_bwd_fp32", "bwd"))):
            if kind not in kinds:
                continue
            bound_ms, bound_by = bound(flops[kind], sizes[kind], PEAK_3XTF32)
            ok = all(_fp32_ok(e) for e in errs[kind].values()) and empty_ok and (
                lse_errs["max_abs_err"] <= FP32_LSE_ATOL and lse_errs["empty_rows_match"]
                if kind == "fwd" else zero_past_kv)
            rec = {"phase": "kernel_fp32", "kernel": kernel, "shape": name,
                   "bhnd": [B, H, N, D], "features": sorted(kw) + (
                       ["global lse"] if kind == "bwd" and feats.get("global_lse") else []),
                   "kv_valid": kw.get("kv_valid_len"), "ms": ms[kind], "iters": iters[kind],
                   "plain_ms": plain_ms[kind], "plain_query_chunk": rows,
                   "library_ms": library_ms[kind],
                   "library": f"F.scaled_dot_product_attention fp32, TF32 off ({backend}"
                              f"{', boolean mask' if 'attn_mask' in lib_kw else ''})",
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": flops[kind] / ms[kind] / 1e9, "bound_share": bound_ms / ms[kind],
                   "attended_pairs": pairs, "errors": errs[kind],
                   "max_abs_err": max(e["max_abs_err"] for e in errs[kind].values()),
                   "tol": {"rel_l2": FP32_REL_L2, "max_abs": f"{FP32_MAX_ABS}*max|plain|"},
                   "ok": ok, "gpu": smi}
            if lse_errs["empty_rows"]:
                rec["rows_with_no_key"] = {"rows": lse_errs["empty_rows"], "zero": empty_ok}
            if kind == "fwd":
                rec.update(max_abs_err_lse=lse_errs["max_abs_err"], tol_lse=FP32_LSE_ATOL,
                           lse_neg_inf_where_plain=lse_errs["empty_rows_match"])
            else:
                rec.update(dk_dv_zero_past_kv_valid=zero_past_kv)
            emit(rec)
            if not ok:
                raise AssertionError(f"{kernel} disagrees with its plain version at {name}")
            if firsts[i] is None or name == FP32_BHND_MAIN_ROW:
                firsts[i] = rec
        del q, k, v, do, out, lse, glse, grads
        torch.cuda.empty_cache()
    return (firsts[0], firsts[1], *_dn_fp32_rows(dev, smi, seqs))


def _bit_gap(got, want) -> float:
    """0.0 where the two are equal bit for bit (-inf where both are), else
    their largest absolute difference."""
    return 0.0 if torch.equal(got, want) else (got - want).abs().nan_to_num().max().item()


def bhnd_fp32(q, k, v, kw, grad=None):
    """The fp32 kernels through the BHND layout's launches
    (`flash_attention.fp32_forward` / `fp32_backward`) on contiguous
    [B, H, N, D] q, k, v, at any width the kernels take (the BHND wrapper
    takes 32-104; the DN route's 16 and 48 too here), with a DN call's
    ``kw``: (out, lse), or with ``grad`` = (out, lse, do) (dq, dk, dv)."""
    from vjepa2_tpu_torch.ops import flash_attention as fa

    B, H, N, D = q.shape
    cos, sin = kw.get("rope_expanded", (None, None))
    seg = kw.get("segment_ids")
    seg = None if seg is None else seg.expand(B, N)
    cos, sin, tables, Mv, seg_q, seg_k, seg_b = fa._fp32_side(q, k, cos, sin, seg, seg,
                                                              kw.get("kv_valid_len"))
    side = (None, cos, sin, tables, Mv, seg_q, seg_k, seg_b, False)
    if grad is None:
        out = torch.empty((B, N, H, D), device=q.device).transpose(1, 2)
        lse = torch.empty((B, H, N), device=q.device)
        fa.fp32_forward(q, k, v, out, lse, *side)
        return out, lse
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fa.fp32_backward(q, k, v, *grad, dq, dk, dv, False, *side)
    return dq, dk, dv


def _dn_fp32_rows(dev, smi: str, seqs) -> tuple[dict, dict]:
    """B1 and B2 at fp32 (`flash_attention_dn` on fp32 [B, H, D, N]: the
    kernels of `csrc/flash_fp32.cuh`, the pre-pass reading the DN layout in
    place, out, dq, dk and dv stored D-major) against their plain versions
    (`flash_attention_bhdn_plain`, `flash_attention_bhdn_bwd_plain`) at
    `FP32_DN_SHAPES`, at phase kernel_fp32's tolerances, each timed as there
    beside the plain version, the same kernels on the same data transposed
    to [B, H, N, D] (`bhnd_fp32`: their ms and whether they give the same
    bits) and
    `F.scaled_dot_product_attention` fp32 on pre-rotated token-major q and k.
    Returns the first forward and backward records."""
    from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

    firsts = [None, None]
    for name, (B, H, D, N), feats in FP32_DN_SHAPES:
        gen = torch.Generator(dev).manual_seed(0)
        q, k, v, do = (torch.randn(B, H, D, N, generator=gen, device=dev) for _ in range(4))
        kw = {}
        if "ac" in feats:
            kw["segment_ids"] = _ac_segments(dev, N, *feats["ac"])
        if feats.get("rope"):
            kw["rope_expanded"] = _rope_tables(dev, B, N, D, feats["rope"], seqs)
        if "kv_valid_len" in feats:
            kw["kv_valid_len"] = feats["kv_valid_len"]
        qt, kt, vt, dot = (t.transpose(2, 3) for t in (q, k, v, do))  # the BHND views
        qc, kc, vc, doc = (t.contiguous() for t in (qt, kt, vt, dot))  # and layout
        seg = kw.get("segment_ids")
        seg = None if seg is None else seg.expand(B, N)
        mask = pair_mask(B, N, N, dev, kw.get("kv_valid_len"), seg, seg)
        pairs = attended_pairs(B, H, N, N, mask)
        kinds = ("fwd",) if feats.get("fwd_only") else ("fwd", "bwd")
        flops = {"fwd": 4 * D * pairs, "bwd": 10 * D * pairs}
        iters = {kind: max(2, min(20, int(4e12 / f))) for kind, f in flops.items()}
        with torch.no_grad():
            out, lse = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
            out_p, lse_p = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
            errs = {"fwd": {"out": _fp32_errors(out, out_p)}}
            lse_errs = _lse_errors(lse, lse_p)
            del out_p, lse_p
            out_b, lse_b = bhnd_fp32(qc, kc, vc, kw)
            gaps = {"out": _bit_gap(out, out_b.transpose(2, 3)), "lse": _bit_gap(lse, lse_b)}
            del out_b, lse_b
            grads = None
            if "bwd" in kinds:
                grads = fdn.flash_attention_bhdn_bwd(q, k, v, out, lse, do, **kw)
                want = fdn.flash_attention_bhdn_bwd_plain(q, k, v, out, lse, do, **kw)
                errs["bwd"] = {n_: _fp32_errors(g, w)
                               for n_, g, w in zip(("dq", "dk", "dv"), grads, want)}
                del want
                out_c = out.transpose(2, 3).contiguous()
                grads_b = bhnd_fp32(qc, kc, vc, kw, (out_c, lse, doc))
                gaps.update({n_: _bit_gap(g, gb.transpose(2, 3))
                             for n_, g, gb in zip(("dq", "dk", "dv"), grads, grads_b)})
                del grads_b
            torch.cuda.synchronize()
            kv = kw.get("kv_valid_len") or N
            zero_past_kv = grads is None or not (grads[1][..., kv:].any() or grads[2][..., kv:].any())
            ms = {"fwd": cuda_ms(lambda: fdn.flash_attention_bhdn(q, k, v, **kw), iters["fwd"])}
            bhnd_ms = {"fwd": cuda_ms(lambda: bhnd_fp32(qc, kc, vc, kw), iters["fwd"])}
            plain_ms = {"fwd": cuda_ms(lambda: fdn.flash_attention_bhdn_plain(q, k, v, **kw), 1,
                                       warmup=1)}
            if "bwd" in kinds:
                ms["bwd"] = cuda_ms(lambda: fdn.flash_attention_bhdn_bwd(q, k, v, out, lse, do, **kw),
                                    iters["bwd"])
                bhnd_ms["bwd"] = cuda_ms(lambda: bhnd_fp32(qc, kc, vc, kw, (out_c, lse, doc)),
                                         iters["bwd"])
                plain_ms["bwd"] = cuda_ms(
                    lambda: fdn.flash_attention_bhdn_bwd_plain(q, k, v, out, lse, do, **kw), 1,
                    warmup=1)
        library_ms, backend = _fp32_library_ms(qt, kt, vt, dot, kw, {} if seg is None else {
            "attn_mask": mask}, kinds, iters, None)
        side = [*kw.get("rope_expanded", ()), *(t for t in (seg,) if t is not None)]
        sizes = {"fwd": nbytes(q, k, v, out, lse, *side),
                 "bwd": nbytes(q, k, v, out, do, lse, *side, *(grads or ()))}
        for i, (kernel, kind) in enumerate((("flash_fwd_dn_fp32", "fwd"),
                                            ("flash_bwd_dn_fp32", "bwd"))):
            if kind not in kinds:
                continue
            bound_ms, bound_by = bound(flops[kind], sizes[kind], PEAK_3XTF32)
            ok = all(_fp32_ok(e) for e in errs[kind].values()) and (
                lse_errs["max_abs_err"] <= FP32_LSE_ATOL and lse_errs["empty_rows_match"]
                if kind == "fwd" else zero_past_kv)
            outs = ("out", "lse") if kind == "fwd" else ("dq", "dk", "dv")
            rec = {"phase": "kernel_fp32", "kernel": kernel, "shape": name,
                   "bhdn": [B, H, D, N], "features": sorted(kw),
                   "kv_valid": kw.get("kv_valid_len"), "ms": ms[kind], "iters": iters[kind],
                   "plain_ms": plain_ms[kind], "bhnd_fp32_ms": bhnd_ms[kind],
                   "bhnd_fp32_same_bits": all(gaps[o] == 0.0 for o in outs),
                   "bhnd_fp32_max_abs_gap": {o: gaps[o] for o in outs},
                   "library_ms": library_ms[kind],
                   "library": f"F.scaled_dot_product_attention fp32, TF32 off, on pre-rotated "
                              f"token-major q, k ({backend}"
                              f"{', boolean mask' if seg is not None else ''})",
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": flops[kind] / ms[kind] / 1e9, "bound_share": bound_ms / ms[kind],
                   "attended_pairs": pairs, "errors": errs[kind],
                   "max_abs_err": max(e["max_abs_err"] for e in errs[kind].values()),
                   "tol": {"rel_l2": FP32_REL_L2, "max_abs": f"{FP32_MAX_ABS}*max|plain|"},
                   "ok": ok, "gpu": smi}
            if kind == "fwd":
                rec.update(max_abs_err_lse=lse_errs["max_abs_err"], tol_lse=FP32_LSE_ATOL)
            else:
                rec.update(dk_dv_zero_past_kv_valid=zero_past_kv)
            emit(rec)
            if not ok:
                raise AssertionError(f"{kernel} disagrees with its plain version at {name}")
            firsts[i] = firsts[i] or rec
        del q, k, v, do, qt, kt, vt, dot, qc, kc, vc, doc, out, lse, grads, mask
        torch.cuda.empty_cache()
    return firsts[0], firsts[1]


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
        if launched != (0, 0, len(enc.blocks)) + (0,) * (len(KERNEL_COUNTS) - 3):
            raise AssertionError(f"a request launched {dict(zip(KERNEL_COUNTS, launched))}, "
                                 f"want B3 {len(enc.blocks)} times only")
        if feats.shape != (CLIPS, tokens, enc.embed_dim) or not torch.isfinite(feats).all():
            raise AssertionError(f"bad features {tuple(feats.shape)}")
        answers.append(feats)
    launches = _launch_counts()[2]

    on_device = requests[0].to(dev)
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: encode_clips(enc, on_device), iters=3, warmup=1)

    # the same weights in fp32 on the CPU (the wrappers take the plain path
    # there), on `_CPU_WORK` beside the next phases; the record prints then
    state = {k: v.to("cpu", copy=True) for k, v in enc.state_dict().items()}
    got = answers[0][0].float()
    med, depth = sorted(times)[len(times) // 2], len(enc.blocks)

    def finish() -> None:
        torch.set_num_threads(os.cpu_count() or 1)
        t2 = time.perf_counter()
        enc_cpu = build("cpu", torch.float32)
        enc_cpu.load_state_dict(state)
        with torch.inference_mode():
            ref = encode_clips(enc_cpu, requests[0][:1])[0]
        cpu_s = time.perf_counter() - t2
        rel = ((got - ref).norm() / ref.norm()).item()
        ok = rel <= GIANT_REL_L2
        emit({"phase": "encode_giant",
              "model": "vit_giant (40 layers, 1408 wide, 16 heads of 88) 16f@256 bf16, RoPE",
              "requests": REQUESTS, "clips_per_request": CLIPS, "warmup_requests": 1,
              "ms_per_request": times, "median_ms_per_request": med,
              "clips_per_s": CLIPS / (med / 1e3), "device_ms_per_request": device_ms,
              "b3_launches": launches, "b3_launches_per_request": depth,
              "features_rel_l2_vs_cpu_fp32": rel, "tol_rel_l2": GIANT_REL_L2,
              "reference_depth": f"full ({depth} layers)",
              "setup_s": setup_s, "cpu_reference_s": cpu_s, "ok": ok, "gpu": smi})
        if not ok:
            raise AssertionError(f"vit_giant features off the CPU fp32 reference: rel L2 {rel}")

    _DEFERRED.append(_CPU_WORK.submit(finish))
    return launches


def phase_entry(dev, smi: str) -> None:
    """`vjepa2_vit_huge()` and `vjepa2_vit_large()` with no argument build
    their (encoder, predictor) pairs on the card in bf16; a clip runs through
    the encoder's flash kernels, then 578 of its tokens through the
    predictor to 1045 targets (12 B1 launches at Dh 32)."""
    from vjepa2_tpu_torch.hub import backbones

    rs = np.random.RandomState(2)
    clip = torch.from_numpy(rs.rand(1, FRAMES, SIZE, SIZE, 3).astype(np.float32)).to(dev)
    tokens = (FRAMES // 2) * (SIZE // 16) ** 2
    ids = torch.from_numpy(rs.permutation(tokens)).to(dev)
    ctx, tgt = ids[None, :578].sort().values, ids[None, 578:1623].sort().values
    rec = {"phase": "entry"}
    # (factory, index of its encoder's kernel in `_launch_counts`: B3 for Dh
    # 80, B1 for Dh 64); the predictor's is B1 (Dh 32)
    for name, slot in (("vjepa2_vit_huge", 2), ("vjepa2_vit_large", 0)):
        torch.manual_seed(0)
        enc, pred = getattr(backbones, name)()
        _reset_launch_counts()
        with torch.inference_mode():
            out = enc(clip)
        launched = _launch_counts()
        _reset_launch_counts()
        with torch.inference_mode():
            y = pred(out[:, ctx[0]], ctx, tgt)
        launched_pred = _launch_counts()
        want = tuple(len(enc.blocks) if i == slot else 0 for i in range(len(KERNEL_COUNTS)))
        want_pred = (len(pred.predictor_blocks),) + (0,) * (len(KERNEL_COUNTS) - 1)
        ok = (launched == want and enc.dtype == torch.bfloat16 and out.dtype == torch.bfloat16
              and out.shape == (1, tokens, enc.embed_dim) and bool(torch.isfinite(out.float()).all())
              and launched_pred == want_pred and pred.dtype == torch.bfloat16
              and y.shape == (1, 1045, enc.embed_dim) and bool(torch.isfinite(y.float()).all()))
        rec[name] = {"dtype": str(enc.dtype), "device": str(next(enc.parameters()).device),
                     "layers": len(enc.blocks), "launches": dict(zip(KERNEL_COUNTS, launched)),
                     "predictor": {"layers": len(pred.predictor_blocks),
                                   "head_dim": pred.predictor_embed_dim // pred.num_heads,
                                   "launches": dict(zip(KERNEL_COUNTS, launched_pred))},
                     "ok": ok}
        del enc, pred, out, y
        if not ok:
            emit(rec)
            raise AssertionError(f"{name}() launched {dict(zip(KERNEL_COUNTS, launched))} and "
                                 f"{dict(zip(KERNEL_COUNTS, launched_pred))}, want "
                                 f"{dict(zip(KERNEL_COUNTS, want))} and "
                                 f"{dict(zip(KERNEL_COUNTS, want_pred))}, or gave bad outputs")
    rec.update(ok=True, gpu=smi)
    emit(rec)


def _cem_linear_step(reps, actions, poses):
    """The linear world model of `tests/planning/test_cem.py`: the last
    frame's [4, 8] latent moved by the action's xyz."""
    import torch.nn.functional as F

    return reps[:, -4:] + F.pad(actions[:, -1, :3], (0, 5))[:, None, :]


def _plan_ok(plan: np.ndarray, cfg) -> bool:
    """[rollout, 7], finite, no rotation, xyz within maxnorm, the gripper 0
    or at least 0.25 in size (`cem.py:102-103`)."""
    grip = np.abs(plan[:, 6])
    return bool(plan.shape == (cfg.rollout, 7) and np.isfinite(plan).all()
                and (plan[:, 3:6] == 0).all() and (np.abs(plan[:, :3]) <= cfg.maxnorm).all()
                and ((grip == 0) | (grip >= 0.25)).all())


# Phase plan's fp32 CPU world model, shared with plan_fp32: {"weights":
# the hub model's weights on the host (phase plan's; plan_fp32 checks that
# its parameters equal them), "frames", "pose", "acts", "poses": the inputs,
# "wm": the CPU world model and "ref_rep" its encode of frame 0 (built by
# phase plan's check on `_CPU_WORK`, dropped by plan_fp32's after it)}
_PLAN_CPU: dict = {}


def _cpu_steps(wm_cpu, rep, goal, acts, poses) -> list:
    """step_fn on the CPU at T = 1 and 2 over the latents (rep, goal)."""
    with torch.inference_mode():
        seq = torch.cat([rep, goal])
        return [wm_cpu.step_fn(seq[:T * 256][None].expand(PLAN_CANDIDATES, -1, -1),
                               acts[:, :T], poses[:, :T]) for T in (1, 2)]


def _card_steps(wm, rep, goal, acts, poses) -> list:
    """step_fn on the card at T = 1 and 2 over the latents, read back."""
    dev = wm.device
    with torch.inference_mode():
        seq = torch.cat([rep, goal])
        return [wm.step_fn(seq[:T * 256][None].expand(PLAN_CANDIDATES, -1, -1),
                           acts[:, :T].to(dev), poses[:, :T].to(dev)).cpu() for T in (1, 2)]


def phase_plan(dev, smi: str) -> tuple[int, ...]:
    """CEM planning over the V-JEPA 2-AC world model: `vjepa2_ac_vit_giant()`
    with no argument (card, bf16, weights drawn after `torch.manual_seed(0)`)
    in a `WorldModel`: two encodes (start and goal frames, 256 px), 1 warm-up
    and `PLAN_TIMED` plans at `CEMConfig()`, one traced plan; then the CPU
    checks on `_CPU_WORK` beside the later phases (the record prints when
    they end). Returns the launches of the counted encodes and plans."""
    import torch.nn.functional as F

    from vjepa2_tpu_torch.hub.backbones import vjepa2_ac_vit_giant
    from vjepa2_tpu_torch.planning import CEMConfig, WorldModel, make_cem
    from vjepa2_tpu_torch.train.droid import tokens_per_frame

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.manual_seed(0)
    enc, pred = vjepa2_ac_vit_giant()
    wm = WorldModel(enc, pred, tokens_per_frame(enc))
    cfg = wm.cem_config
    rs = np.random.RandomState(4)
    frames = [rs.rand(SIZE, SIZE, 3).astype(np.float32) for _ in range(2)]  # start, goal
    pose = np.concatenate([rs.uniform(-0.3, 0.3, 6), [0.5]]).astype(np.float32)
    setup_s = time.perf_counter() - t0
    total = [0] * len(KERNEL_COUNTS)

    def counted(fn, want, what):
        """fn()'s result and host ms (synchronised), its launches held to ``want``."""
        _reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launched = _launch_counts()
        if launched != want:
            raise AssertionError(f"{what} launched {dict(zip(KERNEL_COUNTS, launched))}, want "
                                 f"{dict(zip(KERNEL_COUNTS, want))}")
        for i, n in enumerate(launched):
            total[i] += n
        return out, ms

    def plan(seed):
        return wm.infer_next_action(rep, pose, goal, generator=torch.Generator(dev).manual_seed(seed))

    wm.encode(frames[0])  # warm-up, outside the counted run
    (rep, enc_ms0), (goal, enc_ms1) = (counted(lambda: wm.encode(f), ENCODE_LAUNCHES, "an encode")
                                       for f in frames)
    reps_ok = all(r.shape == (256, enc.embed_dim) and r.dtype == torch.float32
                  and bool(torch.isfinite(r).all()) for r in (rep, goal))
    warm = plan(0)
    plans, plan_ms = [], []
    for seed in range(PLAN_TIMED):
        p, ms = counted(lambda: plan(seed), PLAN_LAUNCHES, "a plan")
        plans.append(p)
        plan_ms.append(ms)
    repeat_equal = bool(np.array_equal(plans[0], warm))
    traced = wall_and_busy(lambda: plan(PLAN_TIMED))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    plans_ok = all(_plan_ok(p, cfg) for p in plans + [warm])

    # step_fn on a few candidates at T = 1 and 2 (the start and goal latents
    # as frames), on the card
    acts = torch.from_numpy(rs.uniform(-0.05, 0.05, (PLAN_CANDIDATES, 2, 7)).astype(np.float32))
    poses = torch.from_numpy(rs.uniform(-0.3, 0.3, (PLAN_CANDIDATES, 2, 7)).astype(np.float32))
    card_steps = _card_steps(wm, rep, goal, acts, poses)
    card_rep, card_goal = rep.cpu(), goal.cpu()
    # the CEM update on device tensors against the CPU: the linear world
    # model, one sampler's draws, CEMConfig's defaults
    draws = rs.randn(cfg.cem_steps, cfg.rollout, cfg.samples, 4).astype(np.float32)
    lin_rep = (rs.randn(4, 8) * 0.1).astype(np.float32)
    lin_goal = lin_rep + F.pad(torch.full((3,), 0.04), (0, 5)).numpy()
    lin = make_cem(_cem_linear_step, CEMConfig())
    lin_plans = [lin(torch.from_numpy(lin_rep).to(d), pose, torch.from_numpy(lin_goal).to(d),
                     sampler=lambda step, h: torch.from_numpy(draws[step, h])).cpu()
                 for d in (dev, "cpu")]
    cem_err = (lin_plans[0] - lin_plans[1]).abs().max().item()
    _PLAN_CPU.update(weights=[{k: v.detach().to("cpu", copy=True)
                               for k, v in m.state_dict().items()} for m in (enc, pred)],
                     frames=frames, pose=pose, acts=acts, poses=poses)
    del wm, enc, pred
    record = {"phase": "plan",
              "model": "vjepa2_ac_vit_giant(): vit_giant_xformers (40 x 1408, 22 heads of 64) + "
                       "AC predictor (24 x 1024, 16 heads of 64), bf16, RoPE, random weights",
              "cem": {k: getattr(cfg, k) for k in cfg.__dataclass_fields__},
              "ms_per_encode": [enc_ms0, enc_ms1], "median_ms_per_encode": max(enc_ms0, enc_ms1),
              "ms_per_plan": plan_ms, "median_ms_per_plan": sorted(plan_ms)[len(plan_ms) // 2],
              "warmup_plans": 1, "one_traced_plan": traced, "peak_memory_gb": peak_gb,
              "launches_per_encode": dict(zip(KERNEL_COUNTS, ENCODE_LAUNCHES)),
              "launches_per_plan": dict(zip(KERNEL_COUNTS, PLAN_LAUNCHES)),
              "plans": [p.tolist() for p in plans], "plans_ok": plans_ok,
              "repeat_bit_equal": repeat_equal, "cem_update_max_abs_err_vs_cpu": cem_err,
              "tol": {"rel_l2": PLAN_REL_L2, "cem_update": CEM_UPDATE_ATOL},
              "setup_s": setup_s, "card_s": time.perf_counter() - t0, "gpu": smi}

    def finish() -> None:
        # the same weights in fp32 on the CPU (built on the meta device, then
        # given the card's weights), the same inputs
        torch.set_num_threads(os.cpu_count() or 1)
        t2 = time.perf_counter()
        enc_cpu, pred_cpu = vjepa2_ac_vit_giant(device="meta")
        enc_cpu.load_state_dict(_PLAN_CPU["weights"][0], assign=True)
        pred_cpu.load_state_dict(_PLAN_CPU["weights"][1], assign=True)
        wm_cpu = WorldModel(enc_cpu, pred_cpu, tokens_per_frame(enc_cpu))
        ref_rep = wm_cpu.encode(frames[0])
        cpu_steps = _cpu_steps(wm_cpu, card_rep, card_goal, acts, poses)
        _PLAN_CPU.update(wm=wm_cpu, ref_rep=ref_rep)
        enc_rel = _rel_l2(card_rep, ref_rep)
        step_rel = [_rel_l2(c, r) for c, r in zip(card_steps, cpu_steps)]
        ok = (reps_ok and plans_ok and repeat_equal and enc_rel <= PLAN_REL_L2
              and max(step_rel) <= PLAN_REL_L2 and cem_err <= CEM_UPDATE_ATOL)
        emit({**record, "encode_rel_l2_vs_cpu_fp32": enc_rel,
              "step_fn_rel_l2_vs_cpu_fp32": {"T1": step_rel[0], "T2": step_rel[1],
                                             "candidates": PLAN_CANDIDATES},
              "cpu_reference_s": time.perf_counter() - t2, "ok": ok})
        if not ok:
            raise AssertionError(f"plan: encode {enc_rel} / step_fn {step_rel} rel L2, CEM "
                                 f"update {cem_err}, plans ok {plans_ok}, repeat equal "
                                 f"{repeat_equal}")

    _DEFERRED.append(_CPU_WORK.submit(finish))
    return tuple(total)


def phase_plan_fp32(dev, smi: str) -> tuple[int, ...]:
    """CEM planning at JAX's default precision: `vjepa2_ac_vit_giant(dtype=
    torch.float32)` after `torch.manual_seed(0)` (phase plan's weights, bit
    for bit) in a `WorldModel`: two encodes (`ENCODE_FP32_LAUNCHES` each), a
    warm-up plan at `PLAN_FP32_CUT_STEPS` CEM steps, one timed plan at
    `CEMConfig()` with `PLAN_FP32_STEPS` CEM steps (`PLAN_FP32_LAUNCHES`), the
    warm-up's repeat traced and bit-equal to it; no op of an encode or a
    step_fn makes a bf16 tensor.
    encode and step_fn (phase plan's candidates, on this phase's latents)
    against phase plan's fp32 CPU world model within `PLAN_FP32_REL_L2`, on
    `_CPU_WORK` after phase plan's checks. Returns the launches of the
    counted encodes and plan."""
    import dataclasses

    from vjepa2_tpu_torch.hub.backbones import vjepa2_ac_vit_giant
    from vjepa2_tpu_torch.planning import CEMConfig, WorldModel
    from vjepa2_tpu_torch.train.droid import tokens_per_frame

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.manual_seed(0)
    enc, pred = vjepa2_ac_vit_giant(dtype=torch.float32)
    cfg = dataclasses.replace(CEMConfig(), cem_steps=PLAN_FP32_STEPS)
    wm = WorldModel(enc, pred, tokens_per_frame(enc), cem_config=cfg)
    cut = WorldModel(enc, pred, tokens_per_frame(enc),
                     cem_config=dataclasses.replace(cfg, cem_steps=PLAN_FP32_CUT_STEPS))
    same = all(torch.equal(v.detach().cpu(), w[k])
               for m, w in zip((enc, pred), _PLAN_CPU["weights"])
               for k, v in m.named_parameters())
    dtypes = {"compute": sorted({str(m.dtype) for m in (enc, pred)}), "parameters": sorted(
        {str(p.dtype) for m in (enc, pred) for p in m.parameters()})}
    frames, pose, acts, poses = (_PLAN_CPU[k] for k in ("frames", "pose", "acts", "poses"))
    setup_s = time.perf_counter() - t0
    total = [0] * len(KERNEL_COUNTS)

    def counted(fn, want, what):
        _reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launched = _launch_counts()
        if launched != want:
            raise AssertionError(f"{what} launched {dict(zip(KERNEL_COUNTS, launched))}, want "
                                 f"{dict(zip(KERNEL_COUNTS, want))}")
        total[:] = [a + b for a, b in zip(total, launched)]
        return out, ms

    def plan(model, seed):
        return model.infer_next_action(rep, pose, goal,
                                       generator=torch.Generator(dev).manual_seed(seed))

    _, encode_bf16_ops = _no_bf16(lambda: wm.encode(frames[0]))  # also the warm-up
    (rep, enc_ms0), (goal, enc_ms1) = (
        counted(lambda: wm.encode(f), ENCODE_FP32_LAUNCHES, "an fp32 encode") for f in frames)
    reps_ok = all(r.shape == (256, enc.embed_dim) and r.dtype == torch.float32
                  and bool(torch.isfinite(r).all()) for r in (rep, goal))
    warm = plan(cut, 0)
    timed, plan_ms = counted(lambda: plan(wm, 0), PLAN_FP32_LAUNCHES, "an fp32 plan")
    repeat = []
    traced = wall_and_busy(lambda: repeat.append(plan(cut, 0)))
    repeat_equal = bool(np.array_equal(repeat[0], warm))
    plans_ok = all(_plan_ok(p, cfg) for p in (timed, warm, repeat[0]))
    card_steps, steps_bf16_ops = _no_bf16(lambda: _card_steps(wm, rep, goal, acts, poses))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    card_rep, card_goal = rep.cpu(), goal.cpu()
    del wm, cut, enc, pred, rep, goal
    route = _check_fp32_route("plan_fp32", total)
    record = {"phase": "plan_fp32", "fp32_route": route,
              "model": "vjepa2_ac_vit_giant(dtype=torch.float32): vit_giant_xformers (40 x 1408, "
                       "22 heads of 64) + AC predictor (24 x 1024, 16 heads of 64), fp32 (TF32 "
                       "off), RoPE, phase plan's random weights",
              "cem": {k: getattr(cfg, k) for k in cfg.__dataclass_fields__},
              "cut": {"timed_plan_cem_steps": PLAN_FP32_STEPS,
                      "of": CEMConfig().cem_steps,
                      "warmup_and_repeat_cem_steps": PLAN_FP32_CUT_STEPS},
              "same_weights_as_phase_plan": same, "dtypes": dtypes,
              "bf16_ops": {"encode": encode_bf16_ops, "step_fn": steps_bf16_ops},
              "ms_per_encode": [enc_ms0, enc_ms1], "median_ms_per_encode": max(enc_ms0, enc_ms1),
              "ms_per_plan": plan_ms, "one_traced_cut_plan": traced, "peak_memory_gb": peak_gb,
              "launches_per_encode": dict(zip(KERNEL_COUNTS, ENCODE_FP32_LAUNCHES)),
              "launches_per_plan": dict(zip(KERNEL_COUNTS, PLAN_FP32_LAUNCHES)),
              "plan": timed.tolist(), "plans_ok": plans_ok, "cut_repeat_bit_equal": repeat_equal,
              "tol": {"rel_l2": PLAN_FP32_REL_L2}, "setup_s": setup_s,
              "card_s": time.perf_counter() - t0, "gpu": smi}
    if not same:
        raise AssertionError("plan_fp32: the fp32 hub model's weights are not phase plan's")

    def finish() -> None:  # after phase plan's check, which built the CPU world model
        wm_cpu, ref_rep = _PLAN_CPU["wm"], _PLAN_CPU["ref_rep"]
        t2 = time.perf_counter()
        cpu_steps = _cpu_steps(wm_cpu, card_rep, card_goal, acts, poses)
        _PLAN_CPU.clear()
        enc_rel = _rel_l2(card_rep, ref_rep)
        step_rel = [_rel_l2(c, r) for c, r in zip(card_steps, cpu_steps)]
        ok = (reps_ok and plans_ok and repeat_equal and enc_rel <= PLAN_FP32_REL_L2
              and max(step_rel) <= PLAN_FP32_REL_L2
              and not (encode_bf16_ops or steps_bf16_ops))
        emit({**record, "encode_rel_l2_vs_cpu_fp32": enc_rel,
              "step_fn_rel_l2_vs_cpu_fp32": {"T1": step_rel[0], "T2": step_rel[1],
                                             "candidates": PLAN_CANDIDATES},
              "cpu_reference_s": time.perf_counter() - t2, "ok": ok})
        if not ok:
            raise AssertionError(f"plan_fp32: encode {enc_rel} / step_fn {step_rel} rel L2, "
                                 f"plans ok {plans_ok}, repeat equal {repeat_equal}, bf16 ops "
                                 f"{encode_bf16_ops or steps_bf16_ops}")

    _DEFERRED.append(_CPU_WORK.submit(finish))
    return tuple(total)


# A serving process for phase export: loads the ViT-L program with
# `hub.export.load_encoder` (the card), answers each batch of the saved
# clips, and reports its launches and the port's modules it imported.
_SERVE_SCRIPT = r"""
import json, sys, time
import torch
t0 = time.perf_counter()
from vjepa2_tpu_torch.hub.export import load_encoder
fn, meta = load_encoder(sys.argv[1])
load_s = time.perf_counter() - t0
from vjepa2_tpu_torch.ops import flash_attention as fa, flash_attention_dn as fdn
from vjepa2_tpu_torch.ops import layernorm as ln, ln_mlp, ln_qkv

def counts():
    return [fdn.LAUNCHES, fdn.LAUNCHES_BWD, fa.LAUNCHES, fa.LAUNCHES_BWD, ln.LAUNCHES,
            ln.LAUNCHES_BWD, ln_qkv.LAUNCHES, ln_mlp.LAUNCHES, fa.LAUNCHES_FP32,
            fa.LAUNCHES_BWD_FP32, fdn.LAUNCHES_FP32, fdn.LAUNCHES_BWD_FP32, ln.LAUNCHES_FP32,
            ln.LAUNCHES_BWD_FP32, ln_qkv.LAUNCHES_FP32, ln_mlp.LAUNCHES_FP32]

clips = torch.load(sys.argv[2])
outs, launches = {}, {}
for batch in json.loads(sys.argv[4]):
    before = counts()
    outs[batch] = fn(clips[:batch]).cpu()
    launches[batch] = [a - b for a, b in zip(counts(), before)]
torch.save(outs, sys.argv[3])
print(json.dumps({"load_s": load_s, "launches": launches,
                  "modules": sorted(m for m in sys.modules if m.startswith("vjepa2_tpu_torch"))}))
"""


@contextlib.contextmanager
def _export_clock(clock: dict):
    """Seconds of each `torch.export.export`, ``save`` and ``load`` call made
    inside, appended to ``clock`` under "trace_s", "save_s" and "load_s"."""
    saved = {name: getattr(torch.export, name) for name in ("export", "save", "load")}

    def timed(fn, key):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                clock.setdefault(key, []).append(time.perf_counter() - t)
        return call

    for name, key in (("export", "trace_s"), ("save", "save_s"), ("load", "load_s")):
        setattr(torch.export, name, timed(saved[name], key))
    try:
        yield clock
    finally:
        for name, fn in saved.items():
            setattr(torch.export, name, fn)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _parity(got, want, cpu_ref=None) -> dict:
    """A loaded program's answer against eager's: equal, or where they part
    (the largest difference and its index) and, with ``cpu_ref`` (a function
    giving the fp32 CPU answer), both answers' relative L2 to it, held to
    `EXPORT_REL_L2`."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape == want.shape and torch.equal(got, want):
        return {"equal": True, "ok": True}
    out = {"equal": False, "shapes": [list(got.shape), list(want.shape)], "ok": False}
    if got.shape == want.shape:
        diff = (got.float() - want.float()).abs()
        out.update(max_abs_diff=diff.max().item(),
                   parts_at=[int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape)],
                   differing_share=(diff > 0).float().mean().item())
        if cpu_ref is not None:
            ref = cpu_ref()
            out["rel_l2_vs_cpu_fp32"] = {"loaded": _rel_l2(got, ref), "eager": _rel_l2(want, ref)}
            out["ok"] = bool(torch.isfinite(got.float()).all()
                             and out["rel_l2_vs_cpu_fp32"]["loaded"] <= EXPORT_REL_L2)
    print(f"export: a loaded program parts from eager: {out}", file=sys.stderr, flush=True)
    return out


def _world_model(size: int):
    """`vjepa2_ac_vit_giant()` (card, bf16, weights drawn after
    `torch.manual_seed(0)`, as phase plan draws them) in a `WorldModel` with
    the hub preprocessor at ``size``."""
    from vjepa2_tpu_torch.hub.backbones import vjepa2_ac_vit_giant
    from vjepa2_tpu_torch.hub.preprocessor import vjepa2_preprocessor
    from vjepa2_tpu_torch.planning import WorldModel
    from vjepa2_tpu_torch.train.droid import tokens_per_frame

    torch.manual_seed(0)
    enc, pred = vjepa2_ac_vit_giant()
    return WorldModel(enc, pred, tokens_per_frame(enc), preprocessor=vjepa2_preprocessor(size))


def export_artifacts(root: str, frames: int, size: int) -> dict:
    """Phase export's three artifacts, exported under ``root`` by the process
    that calls this: `vjepa2_vit_large(num_frames=frames)` and
    `vjepa2_vit_huge(num_frames=frames)` with a symbolic batch, and the world
    model of `_world_model`, each built as the phase builds its eager copy
    (weights drawn after `torch.manual_seed(0)`). Per artifact: the build,
    trace and save seconds and its bytes."""
    from vjepa2_tpu_torch.hub import export
    from vjepa2_tpu_torch.hub.backbones import vjepa2_vit_huge, vjepa2_vit_large

    torch.set_num_threads(1)  # beside the phases that run meanwhile
    out = {}
    for name in ("vit_large", "vit_huge", "world_model"):
        t0 = time.perf_counter()
        if name == "world_model":
            model = _world_model(size)
        else:
            torch.manual_seed(0)
            factory = vjepa2_vit_large if name == "vit_large" else vjepa2_vit_huge
            model, _ = factory(num_frames=frames)
        clock = {"build_s": time.perf_counter() - t0}
        art = os.path.join(root, name)
        with _export_clock(clock):
            t1 = time.perf_counter()
            if name == "world_model":
                export.export_world_model(model, art)
            else:
                export.export_encoder(model, art, batch="B")
            clock["export_s"] = time.perf_counter() - t1
        out[name] = {**clock, "artifact_bytes": _dir_bytes(art)}
        del model
    return out


def start_exports(root: str) -> tuple:
    """A child process exporting phase export's artifacts under ``root``
    (`export_artifacts`), started after the build so that its traces, host
    work on one core, run beside the phases before export. Returns (the
    process, its log prefix)."""
    log = os.path.join(root, "exports")
    return _child(log, "import json, sys, chip_smoke; print(json.dumps(chip_smoke."
                       "export_artifacts(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))))",
                  root, str(FRAMES), str(SIZE)), log


def _child(log: str, code: str, *args: str) -> subprocess.Popen:
    """``python -c code args`` from the repository root, its output and
    errors written to ``log`` + ".out" / ".err"."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p)}
    with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
        return subprocess.Popen([sys.executable, "-c", code, *args], cwd=here, env=env,
                                stdout=out, stderr=err, text=True)


def _child_result(proc: subprocess.Popen, log: str, what: str, timeout: float = 900) -> dict:
    """The JSON line a child printed last; a failed child fails the phase."""
    rc = proc.wait(timeout=timeout)
    with open(log + ".out") as out, open(log + ".err") as err:
        out, err = out.read(), err.read()
    if rc:
        raise AssertionError(f"export: {what} failed (rc {rc}):\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_export(dev, smi: str, exports: tuple, root: str) -> tuple[int, ...]:
    """The serving export (`hub.export`). The artifacts come from the child
    `start_exports` started after the build: `vjepa2_vit_large(num_frames=16)`
    and `vjepa2_vit_huge(num_frames=16)` with a symbolic batch, and
    `vjepa2_ac_vit_giant()` in a `WorldModel` with the hub preprocessor at
    `CEMConfig()` (its encode and plan programs). Here: a fresh process
    loads the ViT-L program with no model module imported and answers
    requests of 1 and 8 clips (16f@256), while this one loads it and times
    it against the eager encoder, interleaved; ViT-H answers one clip; the
    world model runs eagerly, then loaded as a `ServingWorldModel`: two
    encodes of 480 x 640 uint8 frames and one plan at seed 0 against eager's.
    Every eager copy is built as the child built it, and every answer
    launches its kernels exactly as eager does. Returns the launches of the
    counted calls (this process's)."""
    from vjepa2_tpu_torch.hub import export
    from vjepa2_tpu_torch.hub.backbones import (vjepa2_ac_vit_giant, vjepa2_vit_huge,
                                                vjepa2_vit_large)
    from vjepa2_tpu_torch.planning import WorldModel

    t0 = time.perf_counter()
    total = [0] * len(KERNEL_COUNTS)

    def counted(fn, want, what):
        """fn()'s result and host ms (synchronised), its launches held to ``want``."""
        _reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launched = _launch_counts()
        if launched != want:
            raise AssertionError(f"export: {what} launched {dict(zip(KERNEL_COUNTS, launched))}, "
                                 f"want {dict(zip(KERNEL_COUNTS, want))}")
        for i, n in enumerate(launched):
            total[i] += n
        return out, ms

    def eager(module):
        def call(x):
            with torch.inference_mode():
                return module(x)
        return call

    def cpu_features(module, factory, clip):
        def ref():
            cpu = _cpu_model(module, lambda device: factory(device=device)[0])
            with torch.inference_mode():
                return cpu(clip[:1].cpu())
        return ref

    rs = np.random.RandomState(5)
    clips = torch.from_numpy(rs.rand(max(EXPORT_BATCHES), FRAMES, SIZE, SIZE, 3)
                             .astype(np.float32))
    rec = {"phase": "export", "elapsed_s": {}}
    children = []

    def mark(what):
        rec["elapsed_s"][what] = time.perf_counter() - t0

    try:
        exported = _child_result(*exports, "the export process")
        rec["exported_by_child"] = exported
        mark("artifacts exported (child)")

        # ViT-L: served by a fresh process, loaded here against eager; the
        # endpoint's clip geometry is baked into the program: 16f@256
        torch.manual_seed(0)
        enc, _ = vjepa2_vit_large(num_frames=FRAMES)
        art = os.path.join(root, "vit_large")
        clock = {}
        clips_path, out_path = os.path.join(root, "clips.pt"), os.path.join(root, "served.pt")
        torch.save(clips, clips_path)
        t_served = time.perf_counter()
        serve_log = os.path.join(root, "serve")
        children.append(_child(serve_log, _SERVE_SCRIPT, art, clips_path, out_path,
                               json.dumps(EXPORT_BATCHES)))
        server = children[-1]
        with _export_clock(clock):
            t1 = time.perf_counter()
            fn, meta = export.load_encoder(art)
            load_s = time.perf_counter() - t1
        mark("vit_large loaded")
        want = _counts(b1=len(enc.blocks))
        ms = {"eager": {b: [] for b in EXPORT_BATCHES}, "loaded": {b: [] for b in EXPORT_BATCHES}}
        parity = {}
        for r in range(EXPORT_REPEATS):
            for b in EXPORT_BATCHES:
                x = clips[:b].to(dev)
                runs = [("loaded", fn), ("eager", eager(enc))]
                for kind, call in runs if r % 2 == 0 else runs[::-1]:
                    y, t = counted(lambda: call(x), want, f"a {kind} ViT-L request of {b}")
                    ms[kind][b].append(t)
                    if r == 0:
                        parity.setdefault(b, {})[kind] = y
        mark("vit_large timed")
        large_ref = cpu_features(enc, lambda **kw: vjepa2_vit_large(num_frames=FRAMES, **kw),
                                 clips)
        eager_answers = {b: p["eager"] for b, p in parity.items()}
        parity = {b: {"loaded_here": _parity(p["loaded"], p["eager"], large_ref)}
                  for b, p in parity.items()}
        med = {k: {b: sorted(v)[len(v) // 2] for b, v in d.items()} for k, d in ms.items()}
        rec["vit_large"] = {
            "batch": meta["batch"], "in_dtype": meta["in_dtype"],
            "graph_ops": export.program_op_counts(fn.module), **clock, "load_encoder_s": load_s,
            "artifact_bytes": _dir_bytes(art),
            "launches_per_request": dict(zip(KERNEL_COUNTS, want)),
            "ms_per_request": ms, "median_ms_per_request": med, "parity": parity}
        ok = all(v["ok"] for p in parity.values() for v in p.values())
        large_want = want
        del fn

        # ViT-H: one clip through its loaded program
        torch.manual_seed(0)
        enc, _ = vjepa2_vit_huge(num_frames=FRAMES)
        art = os.path.join(root, "vit_huge")
        clock = {}
        with _export_clock(clock):
            t1 = time.perf_counter()
            fn, _ = export.load_encoder(art)
            load_s = time.perf_counter() - t1
        mark("vit_huge loaded")
        want = _counts(b3=len(enc.blocks))
        x = clips[:1].to(dev)
        got, loaded_ms = counted(lambda: fn(x), want, "a loaded ViT-H request")
        ref, eager_ms = counted(lambda: eager(enc)(x), want, "an eager ViT-H request")
        par = _parity(got, ref, cpu_features(
            enc, lambda **kw: vjepa2_vit_huge(num_frames=FRAMES, **kw), clips))
        rec["vit_huge"] = {"graph_ops": export.program_op_counts(fn.module), **clock,
                           "load_encoder_s": load_s, "artifact_bytes": _dir_bytes(art),
                           "launches_per_request": dict(zip(KERNEL_COUNTS, want)),
                           "ms_per_request": {"loaded": loaded_ms, "eager": eager_ms},
                           "parity": par}
        ok = ok and par["ok"]
        del enc, fn, got, ref

        # the world model: eager here, then the child's programs loaded
        wm = _world_model(SIZE)
        cfg = wm.cem_config
        frames = [rs.randint(0, 256, (480, 640, 3), np.uint8) for _ in range(2)]  # start, goal
        pose = np.concatenate([rs.uniform(-0.3, 0.3, 6), [0.5]]).astype(np.float32)
        eager_out = [counted(lambda: wm.encode(f), ENCODE_LAUNCHES, "an eager encode")
                     for f in frames]
        rep, goal = (r for r, _ in eager_out)
        plan_eager, eager_plan_ms = counted(
            lambda: wm.infer_next_action(rep, pose, goal,
                                         generator=torch.Generator(dev).manual_seed(0)),
            PLAN_LAUNCHES, "an eager plan")
        mark("world model run eagerly")
        clock = {}
        with _export_clock(clock):
            t1 = time.perf_counter()
            swm = export.load_world_model(os.path.join(root, "world_model"))
            load_s = time.perf_counter() - t1
        mark("world model loaded")

        def cpu_encode(frame):
            def ref():
                enc_cpu = _cpu_model(wm.encoder,
                                     lambda device: vjepa2_ac_vit_giant(device=device)[0])
                wm_cpu = WorldModel(enc_cpu, None, wm.tokens_per_frame,
                                    preprocessor=wm.preprocessor)
                return wm_cpu.encode(frame)
            return ref

        loaded_out = [counted(lambda: swm.encode(f), ENCODE_LAUNCHES, "a loaded encode")
                      for f in frames]
        enc_parity = [_parity(got, want_rep, cpu_encode(f))
                      for (got, _), (want_rep, _), f in zip(loaded_out, eager_out, frames)]
        plan, plan_ms = counted(lambda: swm.plan(rep, pose, goal, seed=0), PLAN_LAUNCHES,
                                "a loaded plan")
        mark("world model planned")
        plan_equal = bool(np.array_equal(plan, plan_eager))
        plan_ok = _plan_ok(plan, cfg) and _plan_ok(plan_eager, cfg)
        if not plan_equal:
            print(f"export: the loaded plan parts from eager: {plan.tolist()} vs "
                  f"{plan_eager.tolist()}", file=sys.stderr, flush=True)
        rec["world_model"] = {
            "cem": swm.meta["cem"], "frame_preprocessor": swm.meta["frame_preprocessor"],
            "graph_ops": {"encode": export.program_op_counts(swm._encode),
                          "plan (loop body, one CEM step)": export.program_op_counts(swm._plan)},
            **clock, "load_world_model_s": load_s,
            "launches_per_encode": dict(zip(KERNEL_COUNTS, ENCODE_LAUNCHES)),
            "launches_per_plan": dict(zip(KERNEL_COUNTS, PLAN_LAUNCHES)),
            "ms_per_encode": {"loaded": [t for _, t in loaded_out],
                              "eager": [t for _, t in eager_out]},
            "encode_parity": enc_parity,
            "ms_per_plan": {"loaded": plan_ms, "eager": eager_plan_ms},
            "plan": plan.tolist(), "plan_equal": plan_equal, "plan_ok": plan_ok}
        ok = ok and plan_ok and all(p["ok"] for p in enc_parity)
        del wm, swm, eager_out, loaded_out, rep, goal

        # the ViT-L serving process, which ran beside the work above
        served = _child_result(server, serve_log, "the serving process")
        served_s = time.perf_counter() - t_served
        served_outs = torch.load(out_path)
        mark("vit_large served")
        for b in EXPORT_BATCHES:
            parity[b]["served"] = _parity(served_outs[b], eager_answers[b], large_ref)
        model_modules = [m for m in served["modules"] if m.startswith("vjepa2_tpu_torch.models")]
        served_ok = (not model_modules and all(p["served"]["ok"] for p in parity.values())
                     and all(served["launches"][str(b)] == list(large_want)
                             for b in EXPORT_BATCHES))
        rec["vit_large"]["served"] = {
            "process_s": served_s, "load_s": served["load_s"],
            "launches_per_request": {b: dict(zip(KERNEL_COUNTS, served["launches"][str(b)]))
                                     for b in EXPORT_BATCHES},
            "model_modules_imported": model_modules, "ok": served_ok}
        ok = ok and served_ok
    except BaseException:
        rec.update(seconds=time.perf_counter() - t0, ok=False, gpu=smi)
        emit(rec)  # what ran before the failure
        raise
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rec.update(seconds=time.perf_counter() - t0, ok=ok, gpu=smi)
    emit(rec)
    if not ok:
        raise AssertionError("export: a loaded program's answers or launches are off (see the "
                             "record)")
    return tuple(total)


def _host_copy(x):
    """A CPU copy of a tensor or of a dict of them (a copy on the CPU too,
    since the probes' stacks are updated in place)."""
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    return x.detach().to("cpu", copy=True)


class _EvalRecorder:
    """While active, wraps the eval class that a `cli.eval` run function
    builds (`VideoClassificationEval` or `AnticipationEval`; restored on
    exit): keeps the instance; gives each train step and val pass
    (``train_batch``, ``eval_batch``, ``evaluate``) its launches, its host ms
    (each ends in a read-back) and the CUDA-event ms of its frozen features
    and of its probes; keeps the first train step's arguments, its features
    and the probes' parameters before it (on the CPU), and after it the
    step's losses and probe 0's first Adam moment, for the CPU checks."""

    def __init__(self, cls):
        self.cls = cls
        self.instance, self.batches, self.first, self._open = None, [], None, None

    def __enter__(self):
        cls, rec = self.cls, self
        names = [n for n in ("__init__", "train_batch", "eval_batch", "evaluate")
                 if n in vars(cls)]
        self._patched = [(cls, n, vars(cls)[n]) for n in names]
        self._attrs = []
        init = vars(cls)["__init__"]

        def wrapped_init(ev, *args, **kwargs):
            init(ev, *args, **kwargs)
            rec.instance = ev
            for obj, name, kind in ((ev, "features", "encode"), (ev.grid, "train_step", "probes"),
                                    (ev.grid, "eval_logits", "probes")):
                setattr(obj, name, rec._timed(getattr(obj, name), kind, name))
                rec._attrs.append((obj, name))

        cls.__init__ = wrapped_init
        for name in names[1:]:
            setattr(cls, name, self._batch(vars(cls)[name], name))
        return self

    def _timed(self, fn, kind, name):
        rec = self

        def call(*args, **kwargs):
            first = name == "train_step" and rec.first is not None and "params" not in rec.first
            if first:  # (params, opt, step, feats, *targets)
                rec.first.update(params=_host_copy(args[0]), feats=_host_copy(args[3]),
                                 targets=[_host_copy(t) for t in args[4:]])
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            rec._open[kind].append((start, end))
            if first:
                rec.first.update(losses=_host_copy(out[3]["loss"]),
                                 mu0=_host_copy({k: v[0] for k, v in out[1]["mu"].items()}))
            return out

        return call

    def _batch(self, fn, name):
        rec = self

        def call(ev, *args, **kwargs):
            if name == "train_batch" and rec.first is None:
                rec.first = {"args": args}
            rec._open = {"encode": [], "probes": []}
            before, t0 = _launch_counts(), time.perf_counter()
            out = fn(ev, *args, **kwargs)
            torch.cuda.synchronize()
            rec.batches.append({"kind": "train" if name == "train_batch" else "val",
                                "host_ms": (time.perf_counter() - t0) * 1e3,
                                "launches": tuple(a - b for a, b in zip(_launch_counts(), before)),
                                "events": rec._open})
            return out

        return call

    def __exit__(self, *exc):
        for owner, name, orig in self._patched:
            setattr(owner, name, orig)
        for obj, name in self._attrs:
            delattr(obj, name)
        torch.cuda.synchronize()
        for b in self.batches:
            events = b.pop("events")
            b["encode_calls"] = len(events["encode"])
            for kind, pairs in events.items():
                b[f"{kind}_ms"] = sum(s.elapsed_time(e) for s, e in pairs)
        return False

    def check_launches(self, phase: str, want: dict) -> None:
        """Every train step and val batch launched ``want[kind]`` (a val
        pass: once a batch it encoded)."""
        for i, b in enumerate(self.batches):
            per = want[b["kind"]]
            if b["launches"] != tuple(n * b["encode_calls"] for n in per):
                raise AssertionError(f"{phase}: {b['kind']} call {i} launched "
                                     f"{dict(zip(KERNEL_COUNTS, b['launches']))} over "
                                     f"{b['encode_calls']} batches, want "
                                     f"{dict(zip(KERNEL_COUNTS, per))} a batch")

    def summary(self) -> dict:
        """Per-call records, and the medians of the train steps after the
        first (which draws the probes) and of the val batches."""
        out = {"calls": self.batches}
        for kind in ("train", "val"):
            rows = [b for b in self.batches if b["kind"] == kind]
            rows = rows[1:] if kind == "train" and len(rows) > 1 else rows
            for key in ("host_ms", "encode_ms", "probes_ms"):
                vals = sorted(b[key] / b["encode_calls"] for b in rows)
                out[f"median_{key}_per_{kind}_batch"] = vals[len(vals) // 2]
        return out


# The eval phases' CPU references run one at a time on this worker, beside the
# card work of the phases after them (whose steps keep the card busy); the
# script waits for them before its summary.
_CPU_WORK = concurrent.futures.ThreadPoolExecutor(max_workers=1)
_DEFERRED: list = []


def _eval_args(dev):
    import argparse

    return argparse.Namespace(checkpoint=None, epochs=None, synthetic_data=False,
                              val_only=False, device=dev)


def _cpu_model(module, build):
    """``build(device="meta")`` given ``module``'s weights on the CPU, fp32,
    on the plain route."""
    cpu = build(device="meta")
    cpu.load_state_dict({k: v.detach().to("cpu", torch.float32)
                         for k, v in module.state_dict().items()}, assign=True)
    return cpu.eval()


def _flat_rel(got, want) -> float:
    """Relative L2 error of a tensor, or of a tuple of them concatenated."""
    if isinstance(got, (tuple, list)):
        got, want = (torch.cat([t.reshape(-1).float() for t in x]) for x in (got, want))
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _rows(out, n: int):
    """The first ``n`` examples of a probe's logits (a tensor, or the
    anticipation probe's three)."""
    return tuple(t[:n] for t in out) if isinstance(out, tuple) else out[:n]


def _eval_cpu_checks(ev, rec, cpu_features, n: int = 1):
    """The eval phases' checks against the fp32 CPU path, from the probes'
    weights before the first step and that step's bf16 features; the CPU
    runs the first ``n`` examples only (a probe's plain fp32 attention over
    4096 tokens costs seconds a probe and example there), tied to the step
    on the card. The card's part runs now; returned is the CPU's part, a
    function of no argument that gives the checks' record (with "ok") and
    touches nothing on the card, so that it can run beside later phases:

    (1) example 0's features, CPU encoder (and predictor) in fp32 from
    ``cpu_features()`` (which builds the CPU models now and returns the
    function that runs them) against the card's (bf16); probe 0's logits on
    each (end to end);
    (2) every probe's logits on the card's features of the first n
    examples, card against CPU (fp32 on both sides), and their loss; on the
    card, each probe's loss over the whole batch from the same weights
    against the step's own loss;
    (3) probe 0's gradients of the first n examples' loss, card against
    CPU; on the card, its gradients over the whole batch against the
    step's, read back from Adam's first moment (m = (1 - b1) g after one
    step)."""
    import copy

    from torch.func import functional_call

    from vjepa2_tpu_torch.evals.probes import ADAM_B1

    t0 = time.perf_counter()
    grid, first, dev = ev.grid, rec.first, ev.device
    probe = lambda p, i: {k: v[i] for k, v in p.items()}  # noqa: E731
    loss = lambda out, n: grid.objective(_rows(out, n), *(t[:n] for t in targets))[0]  # noqa: E731
    params, feats = first["params"], first["feats"]
    card_params = {k: v.to(dev) for k, v in params.items()}
    card_feats = feats.to(dev)
    B = feats.shape[0]
    # on the card: every probe's logits over the batch from the first step's weights
    targets = [t.to(dev) for t in first["targets"]]
    with torch.no_grad():
        card_out = [functional_call(grid.model, probe(card_params, i), (card_feats,))
                    for i in range(grid.n)]
        card_batch_loss = [loss(o, B).item() for o in card_out]
        card_ex0_loss = [loss(o, n).item() for o in card_out]
    card_ex0 = [_rows(o, n) for o in card_out]
    card_ex0 = [tuple(t.cpu() for t in o) if isinstance(o, tuple) else o.cpu() for o in card_ex0]
    del card_out

    def grads(model, p, x, n):
        p = {k: v.clone().requires_grad_() for k, v in p.items()}
        return torch.autograd.grad(loss(functional_call(model, p, (x,)), n), list(p.values()))

    card_g_batch = grads(grid.model, probe(card_params, 0), card_feats, B)
    card_g_ex0 = [g.cpu() for g in grads(grid.model, probe(card_params, 0), card_feats[:n], n)]
    step_g = [first["mu0"][k].to(dev) / (1 - ADAM_B1) for k in params]
    step_grad_rel = _flat_rel(list(card_g_batch), step_g)
    del card_params, card_feats, card_g_batch, step_g
    model = copy.deepcopy(grid.model).cpu()
    features = cpu_features()
    t_card = time.perf_counter() - t0
    n_probes = grid.n

    def cpu_part() -> dict:
        nonlocal targets
        torch.set_num_threads(os.cpu_count() or 1)
        t1 = time.perf_counter()
        targets = first["targets"]
        with torch.inference_mode():
            f0 = features()
            cpu_ex0 = [functional_call(model, probe(params, i), (feats[:n],))
                       for i in range(n_probes)]
            e2e = functional_call(model, probe(params, 0), (f0,))
            cpu_ex0_loss = [loss(o, n).item() for o in cpu_ex0]
        cpu_g_ex0 = grads(model, probe(params, 0), feats[:n], n)
        return _eval_cpu_record(
            n, feats, f0, card_ex0, cpu_ex0, e2e, card_ex0_loss, cpu_ex0_loss, card_batch_loss,
            first["losses"].tolist(), card_g_ex0, cpu_g_ex0, step_grad_rel, t_card,
            time.perf_counter() - t1)

    return cpu_part


def _eval_cpu_record(n, feats, f0, card_ex0, cpu_ex0, e2e, card_ex0_loss, cpu_ex0_loss,
                     card_batch_loss, step_losses, card_g_ex0, cpu_g_ex0, step_grad_rel, t_card,
                     t_cpu) -> dict:
    """`_eval_cpu_checks`' record: the errors, the tolerances and "ok"."""
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    out = {"cpu_examples": n, "features_rel_l2_vs_cpu_fp32": _flat_rel(feats[:1], f0),
           "probe0_logits_end_to_end_rel_l2": _flat_rel(_rows(card_ex0[0], 1), e2e),
           "logits_rel_l2_vs_cpu_fp32": [_flat_rel(c, o) for c, o in zip(card_ex0, cpu_ex0)],
           "example0_loss": {"card": card_ex0_loss, "cpu_fp32": cpu_ex0_loss},
           "example0_loss_max_rel_err": max(map(rel, card_ex0_loss, cpu_ex0_loss)),
           "first_step_loss": {"step": step_losses, "recomputed": card_batch_loss},
           "first_step_loss_max_rel_err": max(map(rel, card_batch_loss, step_losses)),
           "probe0_grad_rel_l2_vs_cpu_fp32": _flat_rel(card_g_ex0, cpu_g_ex0),
           "probe0_step_grad_rel_l2_vs_recomputed": step_grad_rel,
           "tol": {"end_to_end_rel_l2": EVAL_REL_L2, "logits_rel_l2": EVAL_PROBE_REL_L2,
                   "loss_rtol": EVAL_LOSS_RTOL, "grad_rel_l2": EVAL_GRAD_REL_L2,
                   "step_rtol": EVAL_STEP_RTOL},
           "card_reference_s": t_card, "cpu_reference_s": t_cpu}
    out["ok"] = (out["features_rel_l2_vs_cpu_fp32"] <= EVAL_REL_L2
                 and out["probe0_logits_end_to_end_rel_l2"] <= EVAL_REL_L2
                 and max(out["logits_rel_l2_vs_cpu_fp32"]) <= EVAL_PROBE_REL_L2
                 and out["example0_loss_max_rel_err"] <= EVAL_LOSS_RTOL
                 and out["probe0_grad_rel_l2_vs_cpu_fp32"] <= EVAL_GRAD_REL_L2
                 and out["first_step_loss_max_rel_err"] <= EVAL_STEP_RTOL
                 and step_grad_rel <= EVAL_STEP_RTOL)
    return out


def _probes_restore_bit_equal(ev) -> bool:
    """`save_probes`, then `restore_probes` into the same eval: the params,
    the Adam moments and count, and the step come back bit for bit. The
    anticipation eval saves and restores its Adam state; the video eval saves
    none and keeps the one it trained (JAX's rule), so its moments hold by
    construction."""
    import shutil
    import tempfile

    def saved_part(state):
        params, opt, step = state
        tensors = dict(params, count=opt["count"])
        for moment in ("mu", "nu"):
            tensors.update({f"{moment}.{k}": v for k, v in opt[moment].items()})
        return _host_copy(tensors), step

    before, step = saved_part(ev._probe_state)
    folder = tempfile.mkdtemp(prefix="vjepa2_probes_")
    try:
        ev.save_probes(os.path.join(folder, "probes.pt"))
        ev.restore_probes(os.path.join(folder, "probes.pt"))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    after, step_after = saved_part(ev._probe_state)
    return step_after == step and before.keys() == after.keys() and all(
        torch.equal(after[k], v) for k, v in before.items())


def _run_eval_phase(phase: str, dev, smi: str, config: dict, config_file: str, cls, want: dict,
                    run, checks, extra: dict, overrides=EVAL_OVERRIDES,
                    restore_check: bool = True) -> tuple[int, ...]:
    """One eval config through its `cli.eval` run function under an
    `_EvalRecorder`; then one more traced train step, the checks
    (``checks(ev, rec)``: a dict with "ok", or a function of no argument
    that gives it, run on the CPU beside the later phases by `_CPU_WORK`,
    the record emitted when it ends) and, with ``restore_check``, a probe
    save and restore. Returns the launches of its train steps and val
    batches."""
    import gc

    t0 = time.perf_counter()
    raw = overridden(config, overrides)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    with _EvalRecorder(cls) as rec:
        result = run(raw, _eval_args(dev))
    launches = _launch_counts()
    rec.check_launches(phase, want)
    if launches != tuple(sum(b["launches"][i] for b in rec.batches)
                         for i in range(len(KERNEL_COUNTS))):
        raise AssertionError(f"{phase}: {launches} launched outside its steps and val batches")
    run_s = time.perf_counter() - t0
    ev = rec.instance
    losses_finite = bool(torch.isfinite(rec.first["losses"]).all())
    traced = wall_and_busy(lambda: ev.train_batch(*rec.first["args"]))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    # the IN1K and K400-384 probes restore through eval_video's code
    # (`ProbeCheckpoint`); their copies to the host took 16-47 s (PR 20)
    restored = _probes_restore_bit_equal(ev) if restore_check else "checked in eval_video"
    checks = checks(ev, rec)
    record = {"phase": phase, "config": config_file, "overrides": overrides, **extra,
              "probes": ev.grid.n, "probe_chunk": 1, **rec.summary(),
              "launches_per_batch": {kind: dict(zip(KERNEL_COUNTS, per))
                                     for kind, per in want.items()},
              "one_traced_train_step": traced, "peak_memory_gb": peak_gb,
              "result_smoke_signal_random_weights": json.loads(json.dumps(
                  result, default=lambda o: o.tolist())), "losses_finite": losses_finite,
              "probes_restored_bit_equal": restored, "run_s": run_s,
              "seconds": time.perf_counter() - t0, "gpu": smi}
    del ev, rec
    gc.collect()
    torch.cuda.empty_cache()

    def finish(checks=checks) -> None:
        checks = checks() if callable(checks) else checks
        ok = checks.pop("ok") and losses_finite and bool(restored)
        emit({**record, **checks, "ok": ok})
        if not ok:
            raise AssertionError(f"{phase}: a check failed (see its record)")

    if callable(checks):
        _DEFERRED.append(_CPU_WORK.submit(finish))
    else:
        finish()
    return launches


def phase_eval_video(dev, smi: str, data: dict) -> tuple[int, ...]:
    """The SSv2 probe eval: `cli.eval.run_video_classification` on the
    shipped ViT-L config (`EVAL_VIDEO_CONFIG`) with ``dataset_train`` /
    ``dataset_val`` the manifests of phase disk_data, read through the
    port's loaders (4 spawned workers, JAX's default): the encoder (RoPE,
    bf16, 16f@256) over 4 x 2 clips a batch into features [4, 4096, 1024],
    10 fp32 probes of depth 4 (16 heads, 174 classes) trained one at a time;
    2 train steps and 1 val batch (one view)."""
    from vjepa2_tpu_torch.cli import eval as cli_eval
    from vjepa2_tpu_torch.evals.video_classification import VideoClassificationEval
    from vjepa2_tpu_torch.evals.wrappers import encode_clips
    from vjepa2_tpu_torch.models.vision_transformer import vit_large

    def cpu_features(ev, args):
        enc = _cpu_model(ev.encoder, lambda device: vit_large(
            img_size=(SIZE, SIZE), num_frames=FRAMES, uniform_power=True, use_rope=True,
            device=device))
        return lambda: encode_clips(enc, torch.from_numpy(np.asarray(args[0][:1])))

    overrides = {**EVAL_OVERRIDES, "experiment.data.dataset_train": data["train"],
                 "experiment.data.dataset_val": data["val"]}
    with disk_datasets(data):
        return _run_eval_phase(
            "eval_video", dev, smi, EVAL_VIDEO_CONFIG, EVAL_VIDEO_CONFIG_FILE,
            VideoClassificationEval, EVAL_VIDEO_LAUNCHES, cli_eval.run_video_classification,
            lambda ev, rec: _eval_cpu_checks(ev, rec, lambda: cpu_features(ev, rec.first["args"])),
            {"model": "vit_large 16f@256 bf16 RoPE, 2 segments x batch 4 -> features "
                      "[4, 4096, 1024]; 10 fp32 probes (depth 4, 16 heads of 64 on the fp32 "
                      "flash kernels, 174 classes), one at a time; random weights; clips from "
                      f"disk ({DISK_VIDEOS * DISK_REPEATS}-row train and {DISK_VAL_ROWS}-row "
                      "val manifests, frame step 4)", "decoder": data["decoder"]},
            overrides=overrides)


def phase_eval_anticipation(dev, smi: str) -> tuple[int, ...]:
    """The EK100 anticipation eval: `cli.eval.run_action_anticipation` on
    the shipped ViT-L config (`EVAL_ANTICIPATION_CONFIG`): the encoder over
    16 clips, the predictor (12 x 384, 12 heads of 32) over 2048 context
    tokens plus 256 targets 1 s ahead, features [16, 2304, 1024]; 10 fp32
    three-head probes of depth 1; 2 train steps and 1 val batch."""
    from vjepa2_tpu_torch.cli import eval as cli_eval
    from vjepa2_tpu_torch.evals.action_anticipation import AnticipationEval, anticipative_features
    from vjepa2_tpu_torch.models.predictor import vit_predictor
    from vjepa2_tpu_torch.models.vision_transformer import vit_large

    d = EVAL_ANTICIPATION_CONFIG["experiment"]["data"]

    def cpu_features(ev, args):
        enc = _cpu_model(ev.encoder, lambda device: vit_large(
            img_size=(SIZE, SIZE), num_frames=FRAMES, uniform_power=True, use_rope=True,
            device=device))
        pred = _cpu_model(ev.predictor, lambda device: vit_predictor(
            img_size=(SIZE, SIZE), num_frames=FRAMES, tubelet_size=2, embed_dim=enc.embed_dim,
            predictor_embed_dim=384, depth=12, num_heads=12, num_mask_tokens=10,
            use_mask_tokens=True, use_rope=True, device=device))
        hp = SIZE // 16
        return lambda: anticipative_features(
            enc, pred, torch.from_numpy(np.asarray(args[0][:1])),
            torch.from_numpy(np.asarray(args[1][:1])), frames_per_second=d["frames_per_second"],
            grid_size=hp, h_patches=hp, w_patches=hp)

    return _run_eval_phase(
        "eval_anticipation", dev, smi, EVAL_ANTICIPATION_CONFIG, EVAL_ANTICIPATION_CONFIG_FILE,
        AnticipationEval, EVAL_ANTICIPATION_LAUNCHES, cli_eval.run_action_anticipation,
        lambda ev, rec: _eval_cpu_checks(ev, rec, lambda: cpu_features(ev, rec.first["args"])),
        {"model": "vit_large 16f@256 bf16 RoPE, batch 16, + predictor (12 x 384, 12 heads of "
                  "32) over 2048 + 256 tokens -> features [16, 2304, 1024]; 10 fp32 "
                  "three-head probes (depth 1), one at a time; random weights, synthetic clips",
         "note": "the val pass's host_ms holds drawing its synthetic batch (numpy, inside "
                 "evaluate's loop); its encode_ms and probes_ms are the device's"})


def phase_eval_image(dev, smi: str) -> tuple[int, ...]:
    """The IN1K probe eval: `cli.eval.run_image_classification` on the
    shipped ViT-L config (`EVAL_IMAGE_CONFIG`): 64 images a batch, each
    replicated to 16 fake frames, the encoder (RoPE, bf16) into features
    [64, 2048, 1024], 6 fp32 probes of depth 4 (16 heads of 64 on the fp32
    flash kernels, 1000 classes) trained one at a time; 2 train steps and 1
    val batch. The CPU checks take the first 4 examples."""
    from vjepa2_tpu_torch.cli import eval as cli_eval
    from vjepa2_tpu_torch.evals.image_classification import ImageClassificationEval
    from vjepa2_tpu_torch.evals.wrappers import image_as_video
    from vjepa2_tpu_torch.models.vision_transformer import vit_large

    frames = EVAL_IMAGE_CONFIG["model_kwargs"]["wrapper_kwargs"]["img_as_video_nframes"]

    def cpu_features(ev, args):
        enc = _cpu_model(ev.encoder, lambda device: vit_large(
            img_size=(SIZE, SIZE), num_frames=frames, uniform_power=True, use_rope=True,
            device=device))
        return lambda: enc(image_as_video(torch.from_numpy(np.asarray(args[0][:1])), frames))

    return _run_eval_phase(
        "eval_image", dev, smi, EVAL_IMAGE_CONFIG, EVAL_IMAGE_CONFIG_FILE,
        ImageClassificationEval, EVAL_IMAGE_LAUNCHES, cli_eval.run_image_classification,
        lambda ev, rec: _eval_cpu_checks(ev, rec, lambda: cpu_features(ev, rec.first["args"]),
                                         n=EVAL_IMAGE_CPU_EXAMPLES),
        {"model": "vit_large 16f@256 bf16 RoPE, 64 images as 16 fake frames -> features "
                  "[64, 2048, 1024]; 6 fp32 probes (depth 4, 16 heads of 64 on the fp32 flash "
                  "kernels, 1000 classes), one at a time; random weights, synthetic images"},
        restore_check=False)


def _eval_384_checks(ev, rec) -> dict:
    """The K400-384 checks, forward only, against fp32 on the plain route on
    the card (TF32 off): the host's CPU cannot hold them in the script's
    time (the SSv2 phase's CPU reference runs near 0.14 TFLOP/s on the H100
    host: ~2 min for one 4608-token clip through the ViT-g, ~3 min for one
    probe forward at N = 36,864), and a backward at that N not at all;

    (1) example 0's first segment (one 16f@384 clip): its features from the
    ViT-g in fp32 on the plain route against the step's (bf16, B1);
    (2) probe 0's logits on the step's features of example 0 (the whole
    36,864 tokens): the fp32 flash kernels against the plain forward in
    chunks of `EVAL_384_QUERY_CHUNK` queries;
    (3) every probe's loss recomputed against the step's own, and probe 0's
    gradients recomputed against the step's (Adam's first moment), both on
    the flash route. The backward's plain reference at this shape is phase
    kernel_fp32's (over query chunks)."""
    import copy

    from torch.func import functional_call

    from vjepa2_tpu_torch.evals.probes import ADAM_B1
    from vjepa2_tpu_torch.evals.wrappers import encode_clips
    from vjepa2_tpu_torch.models.vision_transformer import vit_giant_xformers

    t0 = time.perf_counter()
    grid, first, dev = ev.grid, rec.first, ev.device
    params = {k: v.to(dev) for k, v in first["params"].items()}
    probe = lambda i: {k: v[i] for k, v in params.items()}  # noqa: E731
    feats, targets = first["feats"].to(dev), [t.to(dev) for t in first["targets"]]
    clips = torch.from_numpy(np.asarray(first["args"][0][:1, :1])).to(dev)
    res = EVAL_VIDEO_384_CONFIG["experiment"]["data"]["resolution"]
    fpc = EVAL_VIDEO_384_CONFIG["experiment"]["data"]["frames_per_clip"]

    enc32 = vit_giant_xformers(img_size=(res, res), num_frames=fpc, uniform_power=True,
                               use_rope=True, device="meta")
    enc32.load_state_dict({k: v.detach().to(dev, torch.float32)
                           for k, v in ev.encoder.state_dict().items()}, assign=True)
    with torch.inference_mode():
        f0 = encode_clips(enc32.eval(), clips)
    seg_tokens = f0.shape[1]
    features_rel = _flat_rel(feats[:1, :seg_tokens], f0)
    del enc32, f0

    plain = copy.deepcopy(grid.model)
    for blk in plain.pooler.blocks:
        blk.attn.use_flash = False
    with torch.no_grad():
        flash_logits = functional_call(grid.model, probe(0), (feats[:1],))
        with _plain_in_query_chunks(EVAL_384_QUERY_CHUNK):
            plain_logits = functional_call(plain, probe(0), (feats[:1],))
        losses = [grid.objective(functional_call(grid.model, probe(i), (feats,)), *targets)[0]
                  .item() for i in range(grid.n)]
    p0 = {k: v.clone().requires_grad_() for k, v in probe(0).items()}
    g = torch.autograd.grad(grid.objective(functional_call(grid.model, p0, (feats,)),
                                           *targets)[0], list(p0.values()))
    step_g = [first["mu0"][k].to(dev) / (1 - ADAM_B1) for k in params]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    out = {"segment0_tokens": seg_tokens,
           "segment0_features_rel_l2_vs_fp32_plain": features_rel,
           "probe0_logits_rel_l2_vs_plain_chunks": _flat_rel(flash_logits, plain_logits),
           "first_step_loss": {"step": first["losses"].tolist(), "recomputed": losses},
           "first_step_loss_max_rel_err": max(map(rel, losses, first["losses"].tolist())),
           "probe0_step_grad_rel_l2_vs_recomputed": _flat_rel(list(g), step_g),
           "tol": {"features_rel_l2": EVAL_REL_L2, "logits_rel_l2": EVAL_PROBE_REL_L2,
                   "step_rtol": EVAL_STEP_RTOL},
           "reference": "fp32 plain route on the card (TF32 off), not the CPU: see the "
                        "phase's docstring; no backward reference at N = 36,864 here",
           "card_reference_s": time.perf_counter() - t0}
    out["ok"] = (features_rel <= EVAL_REL_L2
                 and out["probe0_logits_rel_l2_vs_plain_chunks"] <= EVAL_PROBE_REL_L2
                 and out["first_step_loss_max_rel_err"] <= EVAL_STEP_RTOL
                 and out["probe0_step_grad_rel_l2_vs_recomputed"] <= EVAL_STEP_RTOL)
    return out


def phase_eval_video_384(dev, smi: str) -> tuple[int, ...]:
    """The ViT-g/384 K400 probe eval: `cli.eval.run_video_classification`
    on the shipped config (`EVAL_VIDEO_384_CONFIG`): batch 1 of 8 segments
    of 16f@384, the 22-head ViT-g (bf16, B1) into features
    [1, 36864, 1408], 10 fp32 probes of depth 4 (16 heads of 88 on the fp32
    flash kernels, 400 classes) trained one at a time; 1 train step and 1
    val batch; the checks of `_eval_384_checks`."""
    from vjepa2_tpu_torch.cli import eval as cli_eval
    from vjepa2_tpu_torch.evals.video_classification import VideoClassificationEval

    return _run_eval_phase(
        "eval_video_384", dev, smi, EVAL_VIDEO_384_CONFIG, EVAL_VIDEO_384_CONFIG_FILE,
        VideoClassificationEval, EVAL_VIDEO_384_LAUNCHES, cli_eval.run_video_classification,
        _eval_384_checks,
        {"model": "vit_giant_xformers 16f@384 bf16 RoPE (grid 8 x 24 x 24), 8 segments x batch "
                  "1 -> features [1, 36864, 1408]; 10 fp32 probes (depth 4, 16 heads of 88 on "
                  "the fp32 flash kernels, 400 classes), one at a time; random weights, "
                  "synthetic clips"},
        overrides=EVAL_VIDEO_384_OVERRIDES, restore_check=False)


def _disk_video(i: int) -> np.ndarray:
    """Source video ``i``: uint8 [DISK_FRAMES, H, W, 3], a smooth random field
    panning 2 px a frame (the numpy resize of a coarse grid), with fine
    noise."""
    from vjepa2_tpu_torch.data.transforms import resize_clip

    H, W = DISK_HW
    rng = np.random.default_rng(1000 + i)
    wide = W + 2 * DISK_FRAMES
    coarse = rng.integers(0, 256, (1, H // 16, wide // 16, 3), dtype=np.uint8)
    field = resize_clip(coarse, (H, wide))[0]
    noise = rng.integers(-6, 7, (H, W, 3))
    return np.stack([np.clip(field[:, 2 * t:2 * t + W] + noise, 0, 255).astype(np.uint8)
                     for t in range(DISK_FRAMES)])


def phase_disk_data(root: str) -> dict:
    """The video files of phases train_disk and eval_video, under ``root``:
    the card host's decoders first (cv2, imageio, the libav headers the
    native decoder needs). Where cv2 can write and the port can read, mp4
    files (mp4v) read by the port's `VideoReader` (its own backend choice);
    else uint8 `.npy` arrays read by `NpyVideoDataset`, the double. The
    manifests: ``train`` (72 rows, each video 9 times, labelled with its
    index), ``bench`` (192 rows: a batch for each of the 8 loader workers)
    and ``val`` (the first 4 videos). Runs on a thread beside the kernel
    phases; prints the decoder on a line of its own."""
    from vjepa2_tpu_torch.data import native, video

    t0 = time.perf_counter()
    cv2 = video._cv2()
    found = {"cv2": getattr(cv2, "__version__", None),
             "imageio": getattr(video._iio(), "__version__", None) if video._iio() else None,
             "libav_headers": native.libav_headers(),
             "port_backends": video.available_backends()}
    decoder = "npy-double"
    paths, nbytes = [], 0
    for i in range(DISK_VIDEOS):
        frames = _disk_video(i)
        if cv2 is not None:
            path = os.path.join(root, f"video_{i}.mp4")
            out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), DISK_FPS,
                                  (DISK_HW[1], DISK_HW[0]))
            for f in frames:
                out.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> cv2's BGR
            out.release()
            reader = video.VideoReader(path)
            probe = [0, DISK_FRAMES // 2, DISK_FRAMES - 1]
            got = reader.get_batch(probe)
            err = float(np.abs(got.astype(np.float32) - frames[probe]).mean())
            if len(reader) != DISK_FRAMES or reader.avg_fps != DISK_FPS or err > 8.0:
                raise AssertionError(f"disk_data: {path} reads back {len(reader)} frames at "
                                     f"{reader.avg_fps} fps, mean |error| {err}")
            decoder = reader.backend
        else:
            path = os.path.join(root, f"video_{i}.npy")
            np.save(path, frames)
        paths.append(path)
        nbytes += os.path.getsize(path)
    manifests = {}
    for name, rows in (("train", paths * DISK_REPEATS), ("bench", paths * 24),
                       ("val", paths[:DISK_VAL_ROWS])):
        manifests[name] = os.path.join(root, f"{name}.csv")
        with open(manifests[name], "w") as f:
            f.writelines(f"{p} {paths.index(p)}\n" for p in rows)
    emit({"decoder": decoder})
    emit({"phase": "disk_data", **found, "decoder": decoder, "videos": DISK_VIDEOS,
          "frames": DISK_FRAMES, "height_width": list(DISK_HW), "fps": DISK_FPS,
          "bytes": nbytes, "train_rows": len(paths) * DISK_REPEATS,
          "seconds": time.perf_counter() - t0})
    return {"decoder": decoder, **manifests}


@contextlib.contextmanager
def disk_datasets(data: dict):
    """While active, with the double, the port's loaders build
    `NpyVideoDataset` where they build `VideoDataset`."""
    if data["decoder"] != "npy-double":
        yield
        return
    from vjepa2_tpu_torch.data import manager, video_dataset

    saved = manager.VideoDataset, video_dataset.VideoDataset
    manager.VideoDataset = video_dataset.VideoDataset = NpyVideoDataset
    try:
        yield
    finally:
        manager.VideoDataset, video_dataset.VideoDataset = saved


@contextlib.contextmanager
def _batch_indices():
    """While active, [(epoch, sample indices)] of every batch a `DataLoader`
    hands out, in order."""
    from vjepa2_tpu_torch.data.loader import DataLoader

    seen, orig = [], DataLoader.batched_indices

    def batched(loader):
        for b in orig(loader):
            seen.append((loader.epoch, list(b)))
            yield b

    DataLoader.batched_indices = batched
    try:
        yield seen
    finally:
        DataLoader.batched_indices = orig


# batches of the bench manifest's 8 (a batch a worker) that train_disk's
# loader hands over with no step; the 3 after feed a step and two traced steps
LOADER_ALONE_BATCHES = 5


def _loader_and_traced_steps(trainer, rec, manifest: str, dev) -> tuple[dict, dict]:
    """One loader of the trainer's (its transform, workers and batch) over the
    bench manifest: its first `LOADER_ALONE_BATCHES` batches iterated with
    no step (seconds to the first, the workers' start included, then
    clips/s), then a step on the next batch and two traced steps, in one
    call, on the two after (each one's wait for its batch timed apart)."""
    from vjepa2_tpu_torch.data.manager import init_video_data
    from vjepa2_tpu_torch.data.prefetch import device_prefetch

    c = trainer.cfg
    bs = c.data.batch_size
    transform = trainer.make_loader(0).dataset.transform
    _, loader, _ = init_video_data(data_paths=[manifest], batch_size=bs, transform=transform,
                                   dataset_fpcs=c.data.dataset_fpcs, fps=c.data.fps,
                                   num_workers=c.data.num_workers, ordered=True,
                                   seed=c.meta.seed)
    it = iter(loader)
    t0 = time.perf_counter()
    clips = next(it)[0][0]
    first = time.perf_counter() - t0
    for _ in range(LOADER_ALONE_BATCHES - 1):
        next(it)
    total = time.perf_counter() - t0
    n = LOADER_ALONE_BATCHES * bs
    alone = {"workers": c.data.num_workers, "batches": LOADER_ALONE_BATCHES, "clips": n,
             "seconds": total, "first_batch_s": first, "clips_per_s": n / total,
             "clips_per_s_after_first": (n - bs) / (total - first),
             "clip_bytes": clips[0].nbytes}
    fn, state = rec.last[0], rec.last[1]
    batches = device_prefetch(it, size=2, transform=trainer.stage, device=dev)
    waits = []

    def step():
        t1 = time.perf_counter()
        args = next(batches)
        waits.append((time.perf_counter() - t1) * 1e3)
        return fn(state, *args)["loss"].item()

    step()
    traced = wall_and_busy(lambda: [step() for _ in range(2)])
    batches.close()
    it.close()
    return alone, {**traced, "steps": 2, "batch_wait_ms": waits[1:]}


def phase_train_disk(dev, smi: str, data: dict) -> tuple[int, ...]:
    """The `Pretrainer` through `cli.main.run_vjepa` on the shipped ViT-L
    config (`TRAIN_DISK_CONFIG`: batch 24, 16f@256, fps 4, 8 spawned
    workers, full remat, bf16) with ``data.datasets`` the 72-row manifest:
    epoch 0, then a new trainer resumes and runs epoch 1; then the same
    trainer runs epoch 2 on synthetic clips (no checkpoint written), for the
    loop's ms a step beside; the loader alone, then two traced steps from
    disk on the same loader.
    Checks: every step's B1/B2 launches, finite losses; the restored state
    bit-equal to the saved one, the resumed first step's schedules and masks
    those of an uninterrupted run, the CSV's 6 rows (train_loop's resume
    checks until PR 20); each epoch's sample indices against the sampler's
    for that epoch (the uninterrupted run's), and epoch 1's order against
    epoch 0's. Returns the launches of the steps from disk."""
    import shutil
    import tempfile

    from vjepa2_tpu_torch.data.samplers import DistributedSampler

    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="vjepa2_disk_")
    overrides = {"folder": folder, "data.datasets": [data["train"]], **TRAIN_DISK_OVERRIDES}
    raw = overridden(TRAIN_DISK_CONFIG, overrides)
    bs, rows = raw["data"]["batch_size"], DISK_VIDEOS * DISK_REPEATS
    try:
        with disk_datasets(data), _batch_indices() as seen:
            torch.cuda.reset_peak_memory_stats(dev)
            with _LoopRecorder() as part1:
                _run_config(raw, dev, epochs=1)
            compare, restored = _restore_check(part1)
            with _LoopRecorder(on_restore=compare) as part2:
                _run_config(raw, dev, epochs=2)
            peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
            run_batches = list(seen)
            resume = _resume_checks(raw, part2, folder, TRAIN_DISK_IPE)
            trainer, _ = part2.states[0]
            part2.release()
            trainer.synthetic_data, trainer._step_fns = True, {}
            with _LoopRecorder(skip_saves=True) as synth:
                trainer.run(epochs=3)  # epoch 2, from epoch 1's checkpoint
            trainer.synthetic_data = False
            alone, traced = _loader_and_traced_steps(trainer, synth, data["bench"], dev)
            synth.release()
            del trainer
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    steps = part1.steps + part2.steps
    _check_launches("train_disk", steps, TRAIN_DISK_LAUNCHES)
    _check_launches("train_disk (synthetic)", synth.steps, TRAIN_DISK_LAUNCHES)
    want = {}
    for epoch in (0, 1):
        sampler = DistributedSampler(rows, 1, 0, seed=raw["meta"]["seed"])
        sampler.set_epoch(epoch)
        idx = list(sampler)
        want[epoch] = [idx[i * bs:(i + 1) * bs] for i in range(TRAIN_DISK_IPE)]
    got = {e: [b for ep, b in run_batches if ep == e] for e in (0, 1)}
    indices = {"epoch0_equal_sampler": got[0] == want[0],
               "epoch1_resumed_equal_uninterrupted": got[1] == want[1],
               "epoch1_order_differs": got[1] != got[0]}
    (ms1, n1), (ms2, n2) = part1.loop_ms_per_step(), part2.loop_ms_per_step()
    ms = (ms1 * n1 + ms2 * n2) / (n1 + n2)
    ms_synth, n_synth = synth.loop_ms_per_step()
    ok = (all(indices.values()) and restored.get("step") == TRAIN_DISK_IPE
          and restored.get("bit_equal") and resume.pop("ok"))
    emit({"phase": "train_disk", "config": TRAIN_DISK_CONFIG_FILE,
          "overrides": {**overrides, "folder": "<temporary directory>",
                        "data.datasets": [f"<{rows}-row manifest of {DISK_VIDEOS} videos>"]},
          "decoder": data["decoder"],
          "model": "vit_large (24 x 1024, Dh 64) 16f@256 bs24 + predictor (12 x 384, 12 heads), "
                   "RoPE, bf16, full remat; clips from disk: 8 spawned workers, fps 4 of "
                   f"{DISK_FPS:g}, random resized crops, flips",
          "steps": [{k: v for k, v in s.items() if k not in ("masks", "t0")} for s in steps],
          "loop_ms_per_step_disk": ms, "loop_ms_per_step_disk_by_part": [ms1, ms2],
          "loop_ms_per_step_synthetic": ms_synth, "disk_over_synthetic": ms / ms_synth,
          "timed_steps": [n1 + n2, n_synth], "clips_per_s_disk": bs / (ms / 1e3),
          "loader_alone": alone, "traced_steps_from_disk": traced, "peak_memory_gb": peak_gb,
          "launches_per_step": dict(zip(KERNEL_COUNTS, TRAIN_DISK_LAUNCHES)),
          "checkpoint": [{k: v for k, v in c.items() if k != "t0"}
                         for c in part1.saves + part2.saves],
          "restored": restored, **resume, "sample_indices": indices,
          "seconds": time.perf_counter() - t0, "ok": ok, "gpu": smi})
    if not ok:
        raise AssertionError(f"train_disk: resume or sample indices off: {indices}, "
                             f"restored {restored}, {resume}")
    return tuple(sum(s["launches"][i] for s in steps) for i in range(len(KERNEL_COUNTS)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    # reference comparisons run in full fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    export_root = tempfile.mkdtemp(prefix="vjepa2_export_")
    exports = start_exports(export_root)
    data_root = tempfile.mkdtemp(prefix="vjepa2_videos_")
    writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    data = writer.submit(phase_disk_data, data_root)  # beside the kernel phases
    try:
        return _run_phases(dev, smi, timed, seconds, t_start, exports, export_root, data)
    finally:
        if exports[0].poll() is None:
            exports[0].kill()
            exports[0].wait()
        writer.shutdown(wait=True)
        shutil.rmtree(export_root, ignore_errors=True)
        shutil.rmtree(data_root, ignore_errors=True)


def _run_phases(dev, smi, timed, seconds, t_start, exports, export_root, data) -> int:
    """Every phase after the build, then the summary lines. ``data``: the
    future of phase disk_data's files."""
    rec = timed("kernel", phase_kernels, dev, smi)
    serve_launches = timed("slice", phase_slice, dev, smi)
    rec_bwd = timed("kernel_bwd", phase_kernels_bwd, dev, smi)
    train_l = timed("train", phase_train, dev, smi, "vit_large")
    rec_bhnd = timed("kernel_bhnd", phase_kernels_bhnd, dev, smi)
    rec_bhnd_bwd = timed("kernel_bhnd_bwd", phase_kernels_bhnd_bwd, dev, smi)
    rec_fp32, rec_fp32_bwd, rec_dn_fp32, rec_dn_fp32_bwd = timed("kernel_fp32", phase_kernels_fp32,
                                                                 dev, smi)
    fp32_l = timed("train_fp32", phase_train_fp32, dev, smi)
    train_h = timed("train_huge", phase_train, dev, smi, "vit_huge", True)
    giant_launches = timed("encode_giant", phase_encode_giant, dev, smi)
    timed("entry", phase_entry, dev, smi)
    rec_ln_fwd, rec_ln_bwd = timed("kernel_ln", phase_kernels_ln, dev, smi)
    rec_qkv = timed("kernel_ln_qkv", phase_kernels_prologue, dev, smi, "ln_qkv")
    rec_mlp = timed("kernel_ln_mlp", phase_kernels_prologue, dev, smi, "ln_mlp")
    rec_ln_fwd32, rec_ln_bwd32 = timed("kernel_ln_fp32", phase_kernels_ln, dev, smi,
                                       torch.float32)
    rec_qkv32 = timed("kernel_ln_qkv_fp32", phase_kernels_prologue, dev, smi, "ln_qkv",
                      torch.float32)
    rec_mlp32 = timed("kernel_ln_mlp_fp32", phase_kernels_prologue, dev, smi, "ln_mlp",
                      torch.float32)
    fused_l, unfused_l = timed("train_fused", phase_train_fused, dev, smi)
    fused_fp32_l = timed("train_fused_fp32", phase_train_fused_fp32, dev, smi)
    loop_l = timed("train_loop", phase_train_loop, dev, smi)
    accum_l = timed("train_accum", phase_train_accum, dev, smi)
    _DEFERRED.extend(_CPU_WORK.submit(job) for job in _CPU_LATER)  # beside device-bound phases
    droid_fp32_l = timed("train_droid_fp32", phase_train_droid_fp32, dev, smi)
    droid_l = timed("train_droid", phase_train_droid, dev, smi)
    plan_l = timed("plan", phase_plan, dev, smi)
    plan_fp32_l = timed("plan_fp32", phase_plan_fp32, dev, smi)
    export_l = timed("export", phase_export, dev, smi, exports, export_root)
    # the device-bound eval steps first, so that the CPU references each
    # phase leaves to `_CPU_WORK` run beside card work that does not time
    # the host (the anticipation eval's step is host-bound)
    eval_a = timed("eval_anticipation", phase_eval_anticipation, dev, smi)
    data = data.result()
    eval_v = timed("eval_video", phase_eval_video, dev, smi, data)
    eval_i = timed("eval_image", phase_eval_image, dev, smi)
    eval_384 = timed("eval_video_384", phase_eval_video_384, dev, smi)
    # last: its 8 loader workers want the host's cores, which the CPU
    # references leave by the time its loader is timed alone
    disk_l = timed("train_disk", phase_train_disk, dev, smi, data)
    t_wait = time.perf_counter()
    for done in _DEFERRED:
        done.result()  # raises a deferred check's failure
    seconds["CPU references, after the last phase"] = time.perf_counter() - t_wait
    emit({"phase": "seconds", "phases": seconds, "total": time.perf_counter() - t_start})
    # every main-path run's launches, in the order of KERNEL_COUNTS
    total = [sum(c) for c in zip(serve_launches, train_l, train_h, fused_l, unfused_l, loop_l,
                                 accum_l, droid_l, plan_l, export_l, eval_v, eval_a, eval_i,
                                 eval_384, fp32_l, droid_fp32_l, plan_fp32_l, fused_fp32_l,
                                 disk_l)]
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
              library=rec_mlp["library"]),
        entry("flash_fwd_fp32", FP32_FWD_SOURCE, FP32_FWD_REPLACES, total[8], rec_fp32,
              "max_abs_err", library=rec_fp32["library"],
              note="B3 on fp32 operands (heads wider than 64 at fp32: the ViT-g/384 "
                   "probes' self-attention; with RoPE, kv_valid and segment ids; ring hops): 3xTF32 "
                   "on wgmma, after the split pre-pass (flash_fp32_split.cu), which rotates q "
                   "and k; segment ids, seg_kv and the causal mask masked on the scores"),
        entry("flash_bwd_fp32", FP32_BWD_SOURCE, FP32_BWD_REPLACES, total[9], rec_fp32_bwd,
              "max_abs_err", library=rec_fp32_bwd["library"],
              note="B4 and B5 (flash_attention.py:361, :434) on fp32 operands: the split "
                   "pre-pass, dQ (flash_fp32_dq.cu), then dK/dV (flash_fp32_dkdv.cu), the "
                   "RoPE adjoint in their epilogues, p 0 where the masks say"),
        entry("flash_fwd_dn_fp32", FP32_FWD_SOURCE, KERNEL_REPLACES, total[10], rec_dn_fp32,
              "max_abs_err", library=rec_dn_fp32["library"],
              note="B1 on fp32 operands (the fp32 pretrain step, the smoke loop, the fp32 "
                   "DROID step and the fp32 CEM plan, heads of 16-64 on JAX's DN route): the "
                   "3xTF32 kernels of flash_fp32.cuh, the split pre-pass reading [B, H, D, N] "
                   "in place, out stored D-major"),
        entry("flash_bwd_dn_fp32", FP32_BWD_SOURCE, BWD_REPLACES, total[11], rec_dn_fp32_bwd,
              "max_abs_err", library=rec_dn_fp32_bwd["library"],
              note="B2 on fp32 operands: the split pre-pass (delta summed over D), dQ, then "
                   "dK/dV of flash_fp32.cuh, dq, dk and dv stored D-major"),
        entry("layernorm_fwd_fp32", LN_SOURCE, LN_FWD_REPLACES, total[12], rec_ln_fwd32,
              "max_abs_err", device_ms=rec_ln_fwd32["device_ms"],
              note="B6's forward on fp32 rows: off the model paths, as in JAX; its "
                   "statistics launch on fp32 rows is the first launch of every fp32 ln_qkv "
                   "and ln_mlp call (192 a fused fp32 ViT-L step)"),
        entry("layernorm_bwd_fp32", LN_SOURCE, LN_BWD_REPLACES, total[13], rec_ln_bwd32,
              "max_abs_err", device_ms=rec_ln_bwd32["device_ms"],
              note="B6's backward on fp32 rows: the LayerNorm tail of the fp32 ln_qkv and "
                   "ln_mlp backwards"),
        entry("ln_qkv_fp32", LN_GEMM_FP32_SOURCE, LN_QKV_REPLACES, total[14], rec_qkv32,
              "max_abs_err", library=rec_qkv32["library"],
              note="B7 on fp32 operands: the statistics launch, W's tf32 split, then 3xTF32 "
                   "on wgmma (tiles of 128 columns at most) with the bias and RoPE in fp32"),
        entry("ln_mlp_fp32", LN_GEMM_FP32_SOURCE, LN_MLP_REPLACES, total[15], rec_mlp32,
              "max_abs_err", library=rec_mlp32["library"],
              note="B8 on fp32 operands: the statistics launch, W's tf32 split, then 3xTF32 "
                   "on wgmma with the bias and the exact GELU in fp32")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
