// Flash attention over fp32 [B, H, N, D] ("BHND") operands for Hopper (sm_90a),
// on the tensor cores: every product of the attention is three TF32 wgmma
// products into one fp32 accumulator ("3xTF32"), which keeps fp32's accuracy.
//
// Replaces the TPU kernels of the BHND family on fp32 operands, which JAX
// runs in the storage dtype (`vjepa2_tpu/ops/flash_attention.py:202`; the
// frozen evals' attentive probes send them fp32 q, k, v):
//   * the forward `vjepa2_tpu/ops/flash_attention.py:166 _fwd_kernel` (B3,
//     `pallas_call` `:307`): `flash_fp32_fwd.cu`;
//   * the backwards `:511 _bwd_fused_kernel` (B4) and `:361 _dq_kernel` /
//     `:434 _dkv_kernel` (B5), one function, as `flash_bwd_bhnd.cu` is for
//     bf16: `flash_fp32_dq.cu`, then `flash_fp32_dkdv.cu`;
//   * and the pre-pass that splits their operands, `flash_fp32_split.cu`.
// The bf16 operands take `flash_fwd_bhnd.cu` and `flash_bwd_bhnd.cu`.
// Contract (JAX's whole feature set: the probes' plain attention, the
// pretrain step's RoPE and kv_valid, the AC predictor's frame-causal segment
// ids, a ring hop's key-side ids with a given lse, the token-causal mask):
//   * q [B, H, N, D], k and v [B, H, M, D] fp32 at element strides: unit
//     stride along d, every other stride a multiple of 4 elements from a
//     16-byte aligned base, or unit stride along the tokens at any other
//     strides (the DN layout [B, H, D, N] of B1/B2, `vjepa2_tpu/ops/
//     flash_attention_dn.py:129` and `:298`, whose fp32 operands take these
//     kernels too: the pre-pass reads each operand in its own layout); D in
//     {16, 32, 48, 64, 80, 88, 104};
//   * RoPE (optional, N == M): split-half tables cos, sin [B|1, N, D] fp32
//     (row stride t_n, unit along d; batch stride t_b, 0 when shared). The
//     pre-pass rotates q and k in fp32 before their split, each pair
//     (d, d + D/2) as `rope_rotate` does: lo' = lo c_lo - hi s_lo, hi' = hi
//     c_hi + lo s_hi, each product and each sum rounded once (`rope_pair`,
//     no FMA), so the rotated operands are those of the plain version; the
//     products then run on the rotated copies, the mainloops unchanged. The
//     backward's dq and dk leave through the adjoint R^T in the epilogues of
//     the dQ and dK/dV launches (`rope_adjoint`);
//   * kv_valid: keys at or past it are masked. The wrapper passes it as the
//     key count M of the pre-pass and of the main launches (which mask their
//     own ragged edge at M), so nothing past it is split, loaded or summed;
//     dK/dV also gets the keys' full count and writes zeros at or past M;
//   * segment ids (optional): seg_q [B, N] and seg_k [B, M] int32 at batch
//     strides segq_b, segk_b (M != N: a ring hop's keys); query i attends key
//     j iff seg_q[i] >= seg_k[j], compared as integers (JAX's TPU kernels
//     cast them to fp32, exact only below 2^24). causal (optional): iff j <=
//     i. These are each kernel's kMasked variant, which runs the wrapper's
//     plan (`ops/flash_attention.py mask_tile_plan`): for each block, the
//     tiles that hold an attended pair, in order, each marked partial where
//     one of its pairs is masked; only those are loaded, and only partial
//     ones are tested pair by pair (a masked score -inf before the
//     forward's running max, p = 0 in both backward launches). The unmasked
//     variant is the kernel without them. A row with no key to attend gives
//     out 0, lse -inf and no gradient;
//   * forward: s = (q . k) * scale * log2(e), an online softmax in base 2
//     (`exp2f`), out = sum_j p_j v_j / sum_j p_j in the layout its strides
//     give (unit stride along d), lse [B, H, N] in natural log; the kernels
//     mask their own ragged edge, so N and M need no padding;
//   * backward, given out, dout and an lse: delta = rowsum(dout * out);
//     p = exp2(s - lse * log2(e)) (0 where lse is -inf); dv = p^T dout;
//     dp = dout v^T; ds = p (dp - delta) scale; dk = ds^T q; dq = ds k;
//     dq, dk, dv written contiguous [B, H, N|M, D], or [B, H, D, N|M] for a
//     DN call, whose forward writes out [B, H, D, N] too (`store_cols`): the
//     layout touches only the pre-pass's reads and the epilogues' stores.
//
// The split: x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
// hi) (x - hi is exact in fp32; hi + lo holds x to 2^-22), and a product is
// A_lo B_hi + A_hi B_lo + A_hi B_hi, the small terms first (A_lo B_lo, below
// 2^-22, is dropped). wgmma's tf32 reads only the top 19 bits of a register,
// so every operand is rounded explicitly before it gets there.
//
// What bounds it on this card: 4*D FLOPs a score forward and 10*D backward
// (14*D as computed: the dQ launch recomputes S and dP), each issued three
// times at 495 TFLOP/s of TF32: 165 TFLOP/s of fp32-accurate products,
// against O(N*D) bytes. So the operations, over the (query, key) pairs that
// the masks leave (the kernels still compute a segment-masked pair; the
// bound counts only the pairs attended). RoPE adds O(N*D) work to the
// pre-pass, which is bound by its bytes, and to the epilogues; the
// mainloops are unchanged.
//
// Design, for the layouts wgmma takes at tf32:
//   * tf32 operands in shared memory must be K-major (the reduction
//     contiguous; the transposed descriptors of `bhnd_hopper.cuh` are
//     bf16/fp16 only). So the pre-pass writes each B operand's hi and lo once
//     a call: token-major [2][B][H][n][D] ("natural": Q, K, dO, V, where the
//     features are the reduction) and feature-major [2][B][H][D][np]
//     ("transposed": V^T, K^T, Q^T, dO^T, where the tokens are), hi at batch
//     b and lo at batch B + b, so one tensor map reads both;
//   * a register A operand (P, P^T, dS, dS^T) comes out of the previous
//     product's accumulator, whose thread holds columns {2t, 2t+1} of each 8;
//     the tf32 A fragment wants columns {t, t+4}. Instead of a shuffle, the
//     transposed copies hold their tokens permuted in each group of 8
//     (position c holds token `permuted(c)`), which the sum does not see;
//   * the long sums are not left to the tensor cores: their fp32 accumulation
//     truncates, and a chain over 36,864 keys drifts to ~1e-4 (an emulation
//     of round-toward-zero; 6e-7 with round-to-nearest). Each tile's product
//     goes to a fresh accumulator, added to a running sum in registers;
//   * every A operand is in registers (fragments loaded once a block) or, in
//     the forward, Q in shared memory; every B operand streams by TMA (128-byte
//     swizzle, 32 fp32 a row: the k-step arithmetic of `bhnd_hopper.cuh`'s
//     `desc_k`/`step_k` is the bf16 one) through an mbarrier ring, fed by a
//     producer warpgroup or, where the consumers need more than 168
//     registers a thread, by one of their threads (`block_threads`);
//   * two consumer warpgroups a block: in the forward they take 64 queries
//     each and turns on the tensor cores (as `pingpong` does); in the backward they
//     share 64 rows and split the products (dQ: one makes S and P, the other
//     dP, both form dS and each adds half of dQ's features; dK/dV: one makes
//     P^T and dV, the other dP^T, dS^T and dK), trading P and dP through
//     shared memory. Each has one resident operand, so both fit;
//   * no atomics: dQ is its own launch, so two calls give equal bits.

#pragma once

#include "bhnd_hopper.cuh"

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr int kSlack = 1024 + 256;  // the 1024-byte alignment and the barriers
// A block is two consumer warpgroups and, where their registers fit in 168
// a thread, a producer warpgroup whose one thread issues the TMA loads
// (`produce`): ptxas caps a block of 384 threads at 168 registers a thread,
// setmaxnreg or not (so does it at 288). Where they do not fit (the backward
// above Dh 64, the forward at every width: 182-255 registers), the block is
// the two warpgroups alone, 256 threads with up to 255 registers, and one
// consumer thread issues the loads (`refill`); at 384 threads those spilled
// 172-928 bytes. At Dh 64 the backward is faster with the producer (dQ
// 22.1 against 26.4 ms, dK/dV 21.0 against 31.7 at [64,16,2048,64] on an
// H100 80GB HBM3), where the loader's waits and issues sit between the two
// warpgroups' tiles.
constexpr int kLoader = kWgThreads;  // the consumer thread that loads without a producer

__host__ __device__ constexpr int block_threads(bool producer) {
  return (producer ? 3 : 2) * kWgThreads;
}

// The producer's loop: tile j into stage j % kStages once the consumers
// have released the tile before it there.
template <int kStages, class Load>
__device__ __forceinline__ void produce(uint64_t* empty, int n, const Load& load) {
  for (int j = 0; j < n; ++j) {
    if (j >= kStages) mbar_wait(&empty[j % kStages], ((j / kStages) & 1) ^ 1);
    load(j);
  }
}

// The ring's refill without a producer: once tile j's stage has been
// released by all eight warps, the loader thread puts tile j + kStages
// there (`load`). Called by every consumer thread after its warp's release
// of tile j.
template <int kStages, class Load>
__device__ __forceinline__ void refill(uint64_t* empty, int j, int n, const Load& load) {
  if (threadIdx.x == kLoader && j + kStages < n) {
    mbar_wait(&empty[j % kStages], (j / kStages) & 1);
    load(j + kStages);
  }
}

// Position c of each group of 8 tokens in a transposed copy holds token
// permuted(c) of the group (0, 2, 4, 6, 1, 3, 5, 7): the A fragment's columns t and
// t + 4 are then the accumulator's 2t and 2t + 1.
__host__ __device__ constexpr int permuted(int c) { return ((c & 3) << 1) | (c >> 2); }

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
// A masked plan's entry (`mask_tile_plan`): the tile's index, with this bit
// set where one of its pairs is masked.
constexpr int kPartialTile = 1 << 16;
// bytes of one part (hi or lo) of a token-major tile of `rows` tokens: ceil(D / 32)
// chunks of rows x 128 bytes (features past D arrive as zeros)
__host__ __device__ constexpr int nat_bytes(int D, int rows) { return (D + 31) / 32 * rows * kRowBytes; }
// bytes of one part of a feature-major tile of `tokens` (a multiple of 32) tokens:
// tokens / 32 chunks of D rows x 128 bytes
__host__ __device__ constexpr int tr_bytes(int D, int tokens) { return tokens / 32 * D * kRowBytes; }
// The first of two column blocks of a D-wide product (both multiples of 8).
__host__ __device__ constexpr int half_width(int D) { return (D + 15) / 16 * 8; }

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both rounded to tf32 (ties away from zero, as cvt.rna does).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}
// An 8-column tile of an accumulator (acc[0..3]: rows g, g + 8 at columns 2t,
// 2t + 1) as the tf32 A fragments (hi, lo) of the next product's k-step:
// fragment column t takes column 2t, t + 4 takes 2t + 1 (`permuted`).
__device__ __forceinline__ void split_tile(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* acc) {
  split_tf32(acc[0], hi[0], lo[0]);
  split_tf32(acc[2], hi[1], lo[1]);
  split_tf32(acc[1], hi[2], lo[2]);
  split_tf32(acc[3], hi[3], lo[3]);
}

// d (64 x N fp32, accumulator layout) (+)= A (64 x 8 tf32, registers: rows g and g + 8
// of each warp's 16, columns t and t + 4) * B (8 x N tf32, shared memory, K-major);
// acc = 0 overwrites d. tf32 reads only the top 19 bits of each register. N 128
// serves the fp32 LayerNorm GEMMs (`ln_gemm_fp32.cu`).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                              int acc) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 24) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 40) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 56) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 88) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, {%44, %45, %46, %47}, %48, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 104) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else {
    static_assert(N == 16, "a wgmma width this header has no instruction for");
  }
}

// d (64 x N fp32) (+)= A (64 x 8 tf32, shared memory, K-major) * B (8 x N tf32,
// shared memory, K-major); acc = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  } else {
    static_assert(N == 32, "a wgmma width this header has no instruction for");
  }
}

// d (+)= A B^T over kSteps k-steps of 8, fp32-accurate: A_lo B_hi, A_hi B_lo,
// then A_hi B_hi. A: register fragments (hi, lo); B: hi and lo tiles of kRows
// rows (descriptors at their first row); acc = 0 starts d afresh.
template <int N, int kSteps, int kRows>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&ah)[kSteps][4],
                                        const uint32_t (&al)[kSteps][4], uint64_t b_hi,
                                        uint64_t b_lo, int acc) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs<N>(d, al[ks], b_hi + step_k<kRows>(ks), acc || ks > 0);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs<N>(d, ah[ks], b_lo + step_k<kRows>(ks), 1);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) wgmma_tf32_rs<N>(d, ah[ks], b_hi + step_k<kRows>(ks), 1);
}

// The tf32 A fragments (hi, lo) of k-steps kFirst .. kFirst + kCount - 1 of
// this thread's rows of a 64-row block of a split token-major copy
// ([2][B][H][n][D]: `hi` at the block's (b, h), lo `part` elements further),
// rows row0 + warp * 16 + g (+ 8) below n; zeros past n.
template <int D, int kFirst, int kCount>
__device__ __forceinline__ void load_fragments(uint32_t (&ah)[kCount][4], uint32_t (&al)[kCount][4],
                                               const float* hi, long long part, int row0, int n) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + warp * 16 + g + 8 * (i & 1);
#pragma unroll
    for (int ks = 0; ks < kCount; ++ks) {
      const long long at = (long long)row * D + 8 * (kFirst + ks) + t4 + 4 * (i >> 1);
      ah[ks][i] = row < n ? __float_as_uint(hi[at]) : 0u;
      al[ks][i] = row < n ? __float_as_uint(hi[at + part]) : 0u;
    }
  }
}

// The 16 values of a 64 x 32 accumulator tile (kB = 32 columns), thread-major
// in a [4][128] float4 buffer, so that the other warpgroup's thread t reads
// what this warpgroup's thread t wrote (the same positions of the tile).
__device__ __forceinline__ void put16(float* buf, const float (&x)[16]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    reinterpret_cast<float4*>(buf)[v * 128 + t] = make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
}
__device__ __forceinline__ void get16(const float* buf, float (&x)[16]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 y = reinterpret_cast<const float4*>(buf)[v * 128 + t];
    x[4 * v] = y.x, x[4 * v + 1] = y.y, x[4 * v + 2] = y.z, x[4 * v + 3] = y.w;
  }
}
constexpr int kXBytes = 128 * 16 * 4;  // one exchanged 64 x 32 tile

// The masked kernels' pair bits for a thread's part of a 64 x (8 kNt)
// accumulator tile: bit 4 nt + 2 r + c set where its row r (at row0 + 8 r,
// id row_id[r]) and column col0 + 8 nt + 2 t4 + c (below n_cols; id
// col_ids[col], or null without segment ids) form an attended pair: the
// query's id >= the key's (as integers), and under causal the key's position
// <= the query's. kRowsQueries: rows are queries, columns keys (the forward,
// dQ); else the other way (dK/dV).
template <int kNt, bool kRowsQueries>
__device__ __forceinline__ uint32_t pair_bits(const int (&row_id)[2], int row0,
                                              const int* col_ids, int col0, int n_cols,
                                              bool causal) {
  const int t4 = threadIdx.x & 3;
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + nt * 8 + 2 * t4 + c;
      const bool in = col < n_cols;
      const int col_id = col_ids != nullptr && in ? col_ids[col] : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const bool ids_ok = col_ids == nullptr ||
                            (kRowsQueries ? row_id[r] >= col_id : col_id >= row_id[r]);
        const bool causal_ok = !causal || (kRowsQueries ? col <= row : row <= col);
        bits |= (uint32_t)(in && ids_ok && causal_ok) << (4 * nt + 2 * r + c);
      }
    }
  }
  return bits;
}

// This warpgroup's rows (row0 + warp * 16 + g, + 8) of a 64 x kW accumulator,
// at column col0 of dst (a [*, kLd] fp32 array: row stride kLd, even where
// the stores are float2), rows below n; rows at or past `valid` are written
// as zeros (dK/dV past kv_valid).
template <int kLd, int kW>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[kW / 2], int row0, int col0,
                                           int valid, int n) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    const bool keep = row < valid;
#pragma unroll
    for (int dt = 0; dt < kW / 8; ++dt) {
      float* at = dst + (long long)row * kLd + col0 + dt * 8 + 2 * t4;
      const float2 x = keep ? make_float2(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1])
                            : make_float2(0.f, 0.f);
      if constexpr (kLd % 2 == 0) {
        *reinterpret_cast<float2*>(at) = x;
      } else {
        at[0] = x.x;
        at[1] = x.y;
      }
    }
  }
}

// The D-major counterpart of `store_rows` (the DN layout, [D, ld] for one
// (b, h): element (row, col) at col * ld + row). A store instruction's
// lanes hold 8 consecutive rows of each of 4 columns, so each column's part
// fills one 32-byte sector: the stores need no staging to coalesce.
template <int kW>
__device__ __forceinline__ void store_cols(float* dst, const float (&acc)[kW / 2], int row0, int col0,
                                           int valid, int n, long long ld) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    const bool keep = row < valid;
#pragma unroll
    for (int dt = 0; dt < kW / 8; ++dt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dst[(long long)(col0 + dt * 8 + 2 * t4 + c) * ld + row] = keep ? acc[4 * dt + 2 * r + c] : 0.f;
      }
    }
  }
}

// Rows row0 + r (r < 64) below n of dst from a 64 x D tile in shared memory
// (row stride kLd) through the RoPE adjoint R^T of `rope_rotate_t`: lo =
// g_lo c_lo + g_hi s_hi, hi = g_hi c_hi - g_lo s_lo with the tables' row of
// the token, each product and each sum rounded once, as the plain version
// rounds them; rows at or past `valid` are zeros. By `threads` threads, this
// one `tid`. dst is a [*, D] fp32 array, contiguous, and the tables' rows
// unit-stride along d (t_n apart); kDMajor: dst is D-major ([D, ld], the DN
// layout) and the tables [.., D, N] (t_d apart along d, unit along the
// tokens), and consecutive threads take consecutive rows, so that both the
// stores and the tables' reads coalesce (kLd odd keeps the tile's column
// reads off one bank).
template <int D, int kLd, bool kDMajor>
__device__ __forceinline__ void rope_adjoint(float* dst, long long ld, const float* tile,
                                             const float* cos_t, const float* sin_t, long long t_n,
                                             long long t_d, int row0, int valid, int n, int tid,
                                             int threads) {
  constexpr int kHalf = D / 2;
  for (int i = tid; i < 64 * kHalf; i += threads) {
    const int r = kDMajor ? i % 64 : i / kHalf, d = kDMajor ? i / 64 : i - r * kHalf;
    const int row = row0 + r;
    if (row >= n) continue;
    float lo = 0.f, hi = 0.f;
    if (row < valid) {
      const float g_lo = tile[r * kLd + d], g_hi = tile[r * kLd + d + kHalf];
      if constexpr (kDMajor) {
        const long long lo_at = row + d * t_d, hi_at = lo_at + kHalf * t_d;
        lo = __fadd_rn(__fmul_rn(g_lo, cos_t[lo_at]), __fmul_rn(g_hi, sin_t[hi_at]));
        hi = __fsub_rn(__fmul_rn(g_hi, cos_t[hi_at]), __fmul_rn(g_lo, sin_t[lo_at]));
      } else {
        const float* c = cos_t + row * t_n;
        const float* s = sin_t + row * t_n;
        lo = __fadd_rn(__fmul_rn(g_lo, c[d]), __fmul_rn(g_hi, s[d + kHalf]));
        hi = __fsub_rn(__fmul_rn(g_hi, c[d + kHalf]), __fmul_rn(g_lo, s[d]));
      }
    }
    if constexpr (kDMajor) {
      dst[(long long)d * ld + row] = lo;
      dst[(long long)(d + kHalf) * ld + row] = hi;
    } else {
      dst[(long long)row * D + d] = lo;
      dst[(long long)row * D + d + kHalf] = hi;
    }
  }
}
constexpr int kEpilogueBar = 2;  // the named barrier of the two consumer warpgroups' epilogue

// ---- host ------------------------------------------------------------------

// The map of a split copy [2B][H][rows][cols] fp32, contiguous (hi at batch b, lo
// at B + b), with boxes of 32 columns x box_rows rows, 128-byte swizzle, zeros
// outside it.
inline bool encode_split(CUtensorMap* map, const void* ptr, int cols, int rows, int H, int B,
                         int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || !aligned16(ptr) || cols % 4 != 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)(2 * B)};
  const cuuint64_t row = (cuuint64_t)cols * 4;
  const cuuint64_t strides[3] = {row, row * rows, row * rows * H};
  const cuuint32_t box[4] = {32, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tokens of a transposed copy's row: n rounded up to 8 (its permutation groups).
inline int padded8(int n) { return (n + 7) / 8 * 8; }

template <class Fn, class... Args>
int dispatch_width(int D, Args&&... args) {
  switch (D) {
    case 16: return Fn::template run<16>(args...);
    case 32: return Fn::template run<32>(args...);
    case 48: return Fn::template run<48>(args...);
    case 64: return Fn::template run<64>(args...);
    case 80: return Fn::template run<80>(args...);
    case 88: return Fn::template run<88>(args...);
    case 104: return Fn::template run<104>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
