// Device helpers shared by the port's kernels: bf16 packing, exp2, and the
// split-half RoPE rotation and rounding, which every flash kernel (B1
// `flash_fwd_dn.cu`, B2 `flash_bwd_dn.cu`, B3 `flash_fwd_bhnd.cu`, the B4/B5
// backward `flash_bwd_bhnd.cu`) and B7's epilogue (`ln_gemm.cu`) take through
// `rope_pair` and `round_scaled`, so a backward recomputes exactly the
// scores its forward's log-sum-exp was taken over; plus the mma.sync and
// cp.async primitives of the kernels still on them (B2, B7). The Hopper
// kernels' machinery (TMA, wgmma) is in `bhnd_hopper.cuh`, B2's prologue
// and tile movers in `flash_bwd_common.cuh`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 elements of row padding: fragment loads hit 32 distinct banks
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_smem_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rotate the split-half pair (lo = x[d], hi = x[d + D/2]) in fp32:
// x * cos + [-x_hi, x_lo] * sin. Rounded products and sums (no FMA
// contraction), so every kernel that calls it gets the same bits.
__device__ __forceinline__ void rope_pair(float& lo, float& hi, float c_lo, float s_lo,
                                          float c_hi, float s_hi) {
  const float r_lo = __fsub_rn(__fmul_rn(lo, c_lo), __fmul_rn(hi, s_lo));
  hi = __fadd_rn(__fmul_rn(hi, c_hi), __fmul_rn(lo, s_hi));
  lo = r_lo;
}

__device__ __forceinline__ bf16 round_scaled(float x, float mul) {
  return __float2bfloat16_rn(__fmul_rn(x, mul));
}

// 16-byte asynchronous copy from global to shared memory; zero-fills the
// destination instead when `pred` is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace
