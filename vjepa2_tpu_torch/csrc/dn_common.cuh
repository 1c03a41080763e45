// Device helpers shared by the port's kernels: bf16 packing, exp2, and the
// split-half RoPE rotation and rounding, which every flash kernel (B1
// `flash_fwd_dn.cu`, B2 `flash_bwd_dn.cu`, B3 `flash_fwd_bhnd.cu`, the B4/B5
// backward `flash_bwd_bhnd.cu`) takes through `rope_pair` and
// `round_scaled`, so a backward recomputes exactly the scores its forward's
// log-sum-exp was taken over (B7's epilogue, `ln_gemm_hopper.cu`, rounds as
// `rope_pair` does). The Hopper machinery (TMA, wgmma) is in
// `bhnd_hopper.cuh`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 elements of row padding of the prologues' staging tiles
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace
