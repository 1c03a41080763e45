// LayerNorm row statistics shared by B6 (`layernorm.cu`) and the fused
// LayerNorm prologues B7 and B8 (`ln_gemm.cu`), for Hopper (sm_90a).
//
// One warp owns one row of C bf16 values (C in {384, 1024, 1280, 1408}): lane
// l holds the 16-byte chunks l, l + 32, ... in registers, so the row is read
// from device memory once. The statistics are the two-pass ones of the TPU
// kernels and of `ln_forward_f32` (`vjepa2_tpu/ops/layernorm.py:73,103`):
// mean = sum(x) / C, var = sum((x - mean)^2) / C, rstd = rsqrt(var + eps),
// all in fp32; the affine output is ((x - mean) * rstd) * gamma + beta with
// rounded products and sums (no FMA contraction), as the plain version
// computes it.
//
// `ln_fwd_kernel` is B6's forward; with a null output it writes only mean and
// rstd, and B7/B8 launch it that way as their first launch.

#pragma once

#include "dn_common.cuh"

namespace {

constexpr int kLnWarps = 8;                // rows per block in the row kernels
constexpr int kLnThreads = kLnWarps * 32;  // 256

template <int C>
struct RowLayout {
  static constexpr int kChunks = C / 8;                  // 16-byte chunks per row
  static constexpr int kPerLane = (kChunks + 31) / 32;   // chunks a lane holds (some hold one less)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// ((x - mean) * rstd) * gamma + beta, each step rounded on its own.
__device__ __forceinline__ float ln_affine(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

// This lane's chunks of a row (16-byte aligned), packed bf16; chunks past the
// row are zero.
template <int C>
__device__ __forceinline__ void load_row(uint4 (&u)[RowLayout<C>::kPerLane], const bf16* row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RowLayout<C>::kPerLane; ++i) {
    const int c = lane + 32 * i;
    u[i] = c < RowLayout<C>::kChunks ? *reinterpret_cast<const uint4*>(row + c * 8)
                                     : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Two-pass mean and rstd of the warp's row.
template <int C>
__device__ __forceinline__ void row_stats(const uint4 (&u)[RowLayout<C>::kPerLane], float eps,
                                          float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < RowLayout<C>::kPerLane; ++i) {
    float f[8];
    unpack8(u[i], f);  // chunks past the row are zero
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < RowLayout<C>::kPerLane; ++i) {
    if (lane + 32 * i < RowLayout<C>::kChunks) {
      float f[8];
      unpack8(u[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[e] - mean;
        q += d * d;
      }
    }
  }
  rstd = rsqrtf(warp_sum(q) / C + eps);
}

// B6 forward: one warp per row of x [R, C]; mean and rstd [R] fp32 and, when
// y is not null, y [R, C] bf16.
template <int C>
__global__ void __launch_bounds__(kLnThreads)
    ln_fwd_kernel(const bf16* x, const float* gamma, const float* beta, bf16* y, float* mean_out,
                  float* rstd_out, int R, float eps) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= R) return;  // uniform across the warp
  uint4 u[RowLayout<C>::kPerLane];
  load_row<C>(u, x + (long long)row * C);
  float mean, rstd;
  row_stats<C>(u, eps, mean, rstd);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  if (y == nullptr) return;
#pragma unroll
  for (int i = 0; i < RowLayout<C>::kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < RowLayout<C>::kChunks) {
      float f[8];
      unpack8(u[i], f);
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + c * 8);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + c * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(beta + c * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(beta + c * 8 + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = ln_affine(f[e], mean, rstd, g[e], b[e]);
      *reinterpret_cast<uint4*>(y + (long long)row * C + c * 8) = pack8(f);
    }
  }
}

// Launch `ln_fwd_kernel` for a width the kernels take (else cudaErrorInvalidValue).
inline cudaError_t launch_ln_fwd(const bf16* x, const float* gamma, const float* beta, bf16* y,
                                 float* mean, float* rstd, int R, int C, float eps,
                                 cudaStream_t stream) {
  const dim3 grid((R + kLnWarps - 1) / kLnWarps);
  auto run = [&](auto kernel) {
    kernel<<<grid, kLnThreads, 0, stream>>>(x, gamma, beta, y, mean, rstd, R, eps);
  };
  switch (C) {
    case 384: run(ln_fwd_kernel<384>); break;
    case 1024: run(ln_fwd_kernel<1024>); break;
    case 1280: run(ln_fwd_kernel<1280>); break;
    case 1408: run(ln_fwd_kernel<1408>); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

inline bool ln_width_ok(int C) { return C == 384 || C == 1024 || C == 1280 || C == 1408; }

}  // namespace
