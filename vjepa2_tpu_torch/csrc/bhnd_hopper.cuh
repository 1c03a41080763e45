// The Hopper machinery of the port's wgmma kernels: the BHND flash kernels
// (B3 `flash_fwd_bhnd.cu`, the B4/B5 backward `flash_bwd_bhnd.cu`), the DN
// flash kernels (B1 `flash_fwd_dn.cu`, B2 `flash_bwd_dn.cu`) and the
// LayerNorm GEMMs (B7 and B8 `ln_gemm_hopper.cu`): TMA tile loads into
// 128-byte swizzled shared memory (4-D maps of [B, H, tokens, features] or
// [B, H, features, tokens], 2-D maps of a row-major matrix), mbarrier
// rings, wgmma with its shared-memory descriptors and register A operands,
// named barriers and setmaxnreg, all as inline PTX (no CUTLASS headers, so
// a file builds in seconds), the host side that encodes a tensor map per
// operand and call, and the flash forwards' consumer loop
// (`online_softmax`, `pingpong`), which B1 and B3 share.
//
// Tile layout: a tile of R tokens x D features (bf16, token-major, as the
// caller laid the operand out) is held as ceil(D / 64) chunks of 64 features;
// a chunk is R rows of 128 bytes with the 128-byte swizzle (16-byte group g
// of row r at g ^ (r % 8)) and starts 1024-byte aligned. TMA writes it: the
// tensor map's inner extent is D, so features D..127 arrive as zeros, and
// its box is 64 features x R tokens. wgmma reads it two ways:
//   * K-major (the features are the reduction): 16 features a k-step, so
//     k-step ks starts (ks % 4) * 32 bytes into chunk ks / 4; 8-row groups
//     are 1024 bytes apart (SBO). Used for Q K^T, K Q^T, V dO^T, dO V^T,
//     and for B1's v, B2's do and B7/B8's W, whose rows (features, output
//     columns) hold the reduction (keys, queries, K) contiguous;
//   * MN-major (the tokens are the reduction, the transposed B operand):
//     k-step kk starts 16 rows (2048 bytes) further; 8-row groups are 1024
//     bytes apart (SBO), chunks R * 128 bytes apart (LBO), so one wgmma of
//     N = Dp (80, 96, 112) output features spans both chunks. Used for P V,
//     P^T dO, dS^T Q_u and dS K_rot, so v, do, q_u and k_rot need no
//     feature-major copy.
// A DN tile (64 tokens x D features of a [.., D, tokens] operand: D rows of
// 128 bytes, the same swizzle) is the same layout with the roles swapped:
// B2 reads its v and do tiles MN-major as both operands of V dO^T and
// dO V^T (`wgmma_ss_mn64`, the features the reduction), and its do tile
// K-major as the B operand of P^T dO.
// A register A operand (P, P^T, dS^T, dS; B7/B8's normalised x) is fp32
// values rounded and packed as mma.sync's A fragments are.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up in libcuda at run time)

#include "dn_common.cuh"

namespace {

constexpr int kChunk = 64;               // features per chunk (128 bytes of bf16)
constexpr int kRowBytes = 128;
constexpr int kWgThreads = 128;          // a warpgroup
constexpr int kThreads = 3 * kWgThreads; // two consumer warpgroups and the producer's
constexpr int kConsumerWarps = 8;

__host__ __device__ constexpr int padded_width(int D) { return (D + 15) / 16 * 16; }
__host__ __device__ constexpr int n_chunks(int D) { return (D + kChunk - 1) / kChunk; }
// bytes of a tile of `rows` tokens at head width D
__host__ __device__ constexpr int tile_bytes(int D, int rows) {
  return n_chunks(D) * rows * kRowBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the swizzle's period).
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// Element offset of (token r, feature c) in a swizzled tile of `rows` tokens.
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c >> 6) * rows * kChunk + r * kChunk + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that has not
// ended after ~2^31 polls traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == 0x80000000u) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// Box (64 features, R tokens) at (feature c0, token c1, head c2, batch c3).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16, 16-byte aligned both ends) from global memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Box (64 columns, rows) at (column c0, row c1) of a 2-D map.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// Every consumer tile of `rows` tokens: one TMA box per chunk.
template <int D, int kRows>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, int t0,
                                         int h, int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < n_chunks(D); ++c) {
    tma_load(dst + c * kRows * kRowBytes, map, c * kChunk, t0, h, b, bar);
  }
}

// ---- warpgroups -----------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);  // 128-byte swizzle
}
// K-major operand: rows [row0, row0 + 64 or N) of a tile of kRows tokens;
// k-step ks is at + step_k<kRows>(ks).
template <int kRows>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int row0) {
  return make_desc(smem_addr(tile) + row0 * kRowBytes, 16, 8 * kRowBytes);
}
template <int kRows>
__device__ __forceinline__ uint64_t step_k(int ks) {
  return static_cast<uint64_t>((ks >> 2) * kRows * kRowBytes + (ks & 3) * 32) >> 4;
}
// MN-major operand: a tile of kRows tokens; chunk c, tokens [16 kk, 16 kk + 16)
// are at + step_mn<kRows>(c, kk).
template <int kRows>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile) {
  return make_desc(smem_addr(tile), kRows * kRowBytes, 8 * kRowBytes);
}
template <int kRows>
__device__ __forceinline__ uint64_t step_mn(int c, int kk) {
  return static_cast<uint64_t>(c * kRows * kRowBytes + kk * 16 * kRowBytes) >> 4;
}
// x, as a value the compiler cannot hoist out of a loop: a descriptor per
// k-step kept live across iterations would cost two registers each.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keep the compiler from touching accumulators across an issue or a wait.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N fp32, accumulator layout) (+)= A (64 x 16, shared memory, K-major)
// * B (16 x N, shared memory, K-major); acc = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  } else {
    static_assert(N == 32, "a wgmma width this header has no instruction for");
  }
}

// d (64 x 64 fp32, accumulator layout) (+)= A (64 x 16) * B (16 x 64), both in
// shared memory MN-major (the 64 rows of A and the 64 columns of B
// contiguous: a DN tile of 64 tokens x features read with the features as
// the reduction); acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_mn64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x N fp32, accumulator layout) (+)= A (64 x 16, registers, as
// mma.sync's A fragments) * B (16 x N, shared memory): MN-major B (the
// tokens are the reduction; kTransB 1) or K-major B (kTransB 0).
template <int N, int kTransB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 112) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 160) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 176) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87}, {%88, %89, %90, %91}, %92, p, 1, 1, %94;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  } else {
    static_assert(N == 16, "a wgmma width this header has no instruction for");
  }
}

// One 8-column tile of an accumulator (acc[0..3]: rows r and r + 8, two
// columns each) as half (`hi` 0: columns 0-7, 1: 8-15) of the bf16 A
// fragment of the next product's 16-wide k-step, as mma.sync's A fragments
// are laid out.
__device__ __forceinline__ void pack_tile(uint32_t (&a)[4], int hi, const float* acc) {
  a[hi * 2 + 0] = pack_bf16(acc[0], acc[1]);
  a[hi * 2 + 1] = pack_bf16(acc[2], acc[3]);
}

// ---- the flash forwards' consumers (B3 `flash_fwd_bhnd.cu`, B1 `flash_fwd_dn.cu`)

// The online softmax of one S sub-tile, 64 rows x kSub keys in the
// accumulator layout, base-2 units, masked scores -inf: the running max and
// this thread's share of each row's denominator are updated, P = exp2(S -
// max) is packed as the A fragments of O += P V as it is made (S dies as P
// grows), and O (kO accumulators) is rescaled. A row masked so far keeps p = 0.
template <int kSub, int kO>
__device__ __forceinline__ void online_softmax(float (&s)[kSub / 2], float (&o)[kO],
                                               uint32_t (&pf)[kSub / 16][4], float (&m_run)[2],
                                               float (&l_run)[2]) {
  constexpr int kNt = kSub / 8;
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * nt + 0], s[4 * nt + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
  }
  float base[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    corr[r] = exp2_approx(m_run[r] - base[r]);
    m_run[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * nt + e] = exp2_approx(s[4 * nt + e] - base[e >> 1]);
      rs[e >> 1] += s[4 * nt + e];
    }
    pack_tile(pf[nt / 2], nt & 1, s + 4 * nt);
  }
  l_run[0] = l_run[0] * corr[0] + rs[0];
  l_run[1] = l_run[1] * corr[1] + rs[1];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] *= corr[(i >> 1) & 1];
}

// The denominators of this thread's two rows (the quad's sums; 1 for a row
// with no key) and their natural-log lse.
__device__ __forceinline__ void row_totals(float (&l_run)[2], const float (&m_run)[2],
                                           float (&denom)[2], float (&lse)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    denom[r] = l_run[r] == 0.f ? 1.f : l_run[r];
    lse[r] = (m_run[r] == -INFINITY ? -INFINITY : m_run[r] * kLn2) + logf(denom[r]);
  }
}

// The two consumer warpgroups' turns on the tensor cores (ping-pong) over
// n_u key sub-tiles, kPer of them to a ring stage of kStages: a warpgroup
// waits for its turn (named barrier 1 + wg), issues O += P_{u-1} V_{u-1}
// and S_u = Q K_u^T, hands the turn to the other, waits for its own
// products (`finish`), releases a consumed stage, and runs its softmax
// while the other's products run. Warpgroup 0 takes the first turn and
// warpgroup 1 the last. The callables are taken by reference: copies of
// the closures moved B3's address arithmetic off the uniform datapath (2%
// slower at Dh 80 on an H100).
template <int kPer, int kStages, class IssueS, class IssuePV, class Finish, class Softmax>
__device__ __forceinline__ void pingpong(int wg, int lane, int n_u, uint64_t* full,
                                         uint64_t* empty, const IssueS& issue_s,
                                         const IssuePV& issue_pv, const Finish& finish,
                                         const Softmax& softmax) {
  const int mine = 1 + wg, other = 1 + (wg ^ 1);
  if (wg == 1) bar_arrive(other, 2 * kWgThreads);
  mbar_wait(&full[0], 0);
  bar_sync(mine, 2 * kWgThreads);
  wgmma_fence();
  issue_s(0);
  bar_arrive(other, 2 * kWgThreads);
  finish();
  softmax(0);
  for (int u = 1; u < n_u; ++u) {
    const int j = u / kPer;
    if (u % kPer == 0) mbar_wait(&full[j % kStages], (j / kStages) & 1);
    bar_sync(mine, 2 * kWgThreads);
    wgmma_fence();
    issue_pv(u - 1);
    issue_s(u);
    bar_arrive(other, 2 * kWgThreads);
    finish();
    if (u % kPer == 0 && lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);  // tile j - 1 consumed
    softmax(u);
  }
  bar_sync(mine, 2 * kWgThreads);
  wgmma_fence();
  issue_pv(n_u - 1);
  if (wg == 0) bar_arrive(other, 2 * kWgThreads);
  finish();
}

// ---- the prologues' elementwise work: four features a thread ---------------

// x[0], x[sd], x[2 sd], x[3 sd] as floats; one 8-byte load when `vec`.
__device__ __forceinline__ float4 load4(const bf16* x, long long sd, bool vec) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(x);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(__bfloat162float(x[0]), __bfloat162float(x[sd]),
                     __bfloat162float(x[2 * sd]), __bfloat162float(x[3 * sd]));
}

// bf16(v * mul) into x[0..3] (8-byte aligned), one store.
__device__ __forceinline__ void store4(bf16* x, float4 v, float mul) {
  uint2 u;
  u.x = pack_bf16(__fmul_rn(v.x, mul), __fmul_rn(v.y, mul));
  u.y = pack_bf16(__fmul_rn(v.z, mul), __fmul_rn(v.w, mul));
  *reinterpret_cast<uint2*>(x) = u;
}

// The split-half rotation of pairs (d + j, d + j + half), j < 4, with the
// tables' row at token n (`rope_pair`, so every kernel rounds alike).
__device__ __forceinline__ void rope4(float4& lo, float4& hi, const float* cos_n,
                                      const float* sin_n, int d, int half, long long t_d) {
  float* l = &lo.x;
  float* h = &hi.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i_lo = (d + j) * t_d, i_hi = (d + j + half) * t_d;
    rope_pair(l[j], h[j], cos_n[i_lo], sin_n[i_lo], cos_n[i_hi], sin_n[i_hi]);
  }
}

// Whether load4 may take the 8-byte path for an operand with these element
// strides (b, h, n, d).
inline bool vec4_ok(const void* ptr, long long b, long long h, long long n, long long d) {
  return d == 1 && n % 4 == 0 && h % 4 == 0 && b % 4 == 0 &&
         reinterpret_cast<uintptr_t>(ptr) % 8 == 0;
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A token-major bf16 operand [B, H, n, D] with element strides (n, h, b) and
// unit stride along d.
struct Operand {
  const void* ptr;
  long long n, h, b;
};

// What an entry point returns when an operand that TMA reads is not
// TMA-ready (`tma_ok`, `encode_2d`): nothing was launched. The wrapper then
// calls again with what makes it ready: a fresh contiguous copy of the
// operand (B3, B4/B5, B8), or, for B1's v, a buffer into which its own
// prologue copies v. The rule lives here; a call that passes pays no check
// on the host.
constexpr int kNotTmaReady = -1;

// x of `rows` tokens with the strides of its length-1 dims (never stepped)
// replaced by packed values, which a tensor map takes whatever they were.
inline Operand operand(const void* ptr, long long n, long long h, long long b, int D, int rows,
                       int H, int B) {
  auto up8 = [](long long v) { return (v + 7) / 8 * 8; };
  if (rows == 1) n = up8(D);
  if (H == 1) h = up8(n * rows);
  if (B == 1) b = up8(h * H);
  return Operand{ptr, n, h, b};
}

// TMA needs a 16-byte aligned base and strides that are multiples of 16 bytes.
inline bool tma_ok(const Operand& x) {
  return aligned16(x.ptr) && x.n % 8 == 0 && x.h % 8 == 0 && x.b % 8 == 0 && x.n > 0 &&
         x.h > 0 && x.b > 0;
}

// The map of x with boxes of 64 features x `box_rows` tokens, 128-byte
// swizzle, zeros outside [0, D) x [0, rows).
inline bool encode(CUtensorMap* map, const Operand& x, int D, int rows, int H, int B,
                   int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || !tma_ok(x)) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)x.n * 2, (cuuint64_t)x.h * 2, (cuuint64_t)x.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major bf16 matrix [rows, cols] (row stride `ld`
// elements) with boxes of 64 columns x `box_rows` rows, 128-byte swizzle,
// zeros outside it. False if TMA cannot read it (alignment, stride).
inline bool encode_2d(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                      long long ld, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || !aligned16(ptr) || ld % 8 != 0 || rows <= 0 || cols <= 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets `Kernel` take `bytes` of dynamic shared memory: once per device, not
// at every launch (a driver call that the host-bound steps would pay).
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The current device's SM count, read once per device.
inline int sm_count() {
  static int count[64] = {};
  int dev = 0, other = 0;
  cudaGetDevice(&dev);
  int& n = dev < 64 ? count[dev] : other;
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace
