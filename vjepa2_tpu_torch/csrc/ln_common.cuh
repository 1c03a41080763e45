// LayerNorm rows shared by B6 (`layernorm.cu`) and the fused LayerNorm
// prologues B7 and B8 (`ln_gemm_hopper.cu`), for Hopper (sm_90a): the row
// layout (lanes a row, 16-byte chunks a lane), the two-pass statistics, and
// B6's statistics launch (the forward writing only mean and rstd), which B7
// and B8 launch first.
//
// Statistics: the two-pass ones of the TPU kernels and of `ln_forward_f32`
// (`vjepa2_tpu/ops/layernorm.py:73,103`): mean = sum(x) / C,
// var = sum((x - mean)^2) / C, rstd = rsqrt(var + eps), all in fp32; the
// affine output is ((x - mean) * rstd) * gamma + beta with rounded products
// and sums (no FMA contraction), as the plain version computes it.
//
// A lane group reads a row 16 bytes a lane, with no idle lane on a last
// chunk where the width allows: C 384 is 48 chunks as 16 lanes x 3 (two rows
// a warp), 1024 is 32 x 4, 1280 is 32 x 5, and 1408 is 176 chunks as 32
// lanes x 6 with the sixth on half the lanes (16 lanes x 11 ran 4-12%
// slower on an H100: eleven loads a lane in a row, and in the backward 176
// dgamma/dbeta sums in registers). The statistics are shuffles within the
// lane group.
//
// The statistics launch (`ln_stats_kernel`) only reads, ~1 fp32 operation a
// byte: memory bounds it. Blocks of eight warps load one row a lane group
// straight into registers and exit, as many resident as the SMs take; the
// persistent ring of B6's forward and backward (`layernorm.cu`) read these
// rows 9-20% slower there (H100, `PERF.md` §6 "PR 8").

#pragma once

#include "dn_common.cuh"

namespace {

// for the layouts of B6's ring kernels (`layernorm.cu`)
constexpr int kLnMaxStages = 8;          // ring stages at most
constexpr int kLnRingBytes = 96 * 1024;  // a ring at most (two blocks an SM)
constexpr int kLnRegChunks = 5;          // gamma/beta in registers up to this many chunks a lane

constexpr int kLnStatsWarps = 8;  // warps of a statistics block

// Lanes a row: 16 at C 384, else 32 (`ops/layernorm.py:ln_lanes` states the
// same rule).
template <int C>
__host__ __device__ constexpr int ln_lanes() {
  return C == 384 ? 16 : 32;
}

// A row kernel's layout: kLanes lanes a row, kRows rows a lane group at
// once, kWarps consumer warps and a producer warp a block, a ring of stages
// of kSrcs tensors' rows, 2 to kLnMaxStages stages as kLnRingBytes holds them.
template <int C, int kLanes, int kWarps_, int kRows_, int kSrcs>
struct RowLayout {
  static constexpr int kChunks = C / 8;                          // 16-byte chunks a row
  static constexpr int kPerLane = (kChunks + kLanes - 1) / kLanes;  // chunks a lane holds
  static constexpr bool kFull = kChunks % kLanes == 0;           // every lane every chunk
  static constexpr int kRowsPerWarp = 32 / kLanes;
  static constexpr int kWarps = kWarps_;
  static constexpr int kRows = kRows_;
  static constexpr int kThreads = (kWarps + 1) * 32;
  static constexpr int kGroups = kWarps * kRowsPerWarp;          // lane groups a block
  static constexpr int kStageRows = kGroups * kRows;             // rows a ring stage
  static constexpr int kStageBytes = kSrcs * kStageRows * C * 2;
  static constexpr int kFit = kLnRingBytes / kStageBytes;        // stages the ring room holds
  static constexpr int kStages = kFit < 2 ? 2 : kFit > kLnMaxStages ? kLnMaxStages : kFit;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr bool kParamsInSmem = kPerLane > kLnRegChunks;
  static constexpr int kLanes_ = kLanes;
  // chunk i of lane-in-group gl, and whether the row has it
  static __device__ __forceinline__ int chunk(int gl, int i) { return gl + kLanes * i; }
  static __device__ __forceinline__ bool has(int gl, int i) {
    return kFull || chunk(gl, i) < kChunks;
  }
  // the stage row of lane group grp's k-th row: a partial stage's rows spread over the warps
  static __device__ __forceinline__ int row_of(int grp, int k) { return k * kGroups + grp; }
};

template <int C>
using StatsLayout = RowLayout<C, ln_lanes<C>(), kLnStatsWarps, 1, 1>;

// Sums v[k] over the lane group, for each k: the shuffles of the N sums
// interleave, so that N rows wait for one chain of them.
template <int kLanes, int N>
__device__ __forceinline__ void group_sums(float (&v)[N]) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
}

__device__ __forceinline__ float sum8(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
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

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// ((x - mean) * rstd) * gamma + beta, each step rounded on its own.
__device__ __forceinline__ float ln_affine(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

// A lane's chunks of a row, in shared or device memory (zeros for a row
// that is not there, and past the row's end).
template <class L>
__device__ __forceinline__ void load_row(uint4 (&u)[L::kPerLane], const bf16* row, bool valid,
                                         int gl) {
#pragma unroll
  for (int i = 0; i < L::kPerLane; ++i) {
    u[i] = valid && L::has(gl, i) ? *reinterpret_cast<const uint4*>(row + L::chunk(gl, i) * 8)
                                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Two-pass mean and rstd of each of the lane group's kRows rows.
template <class L, int C>
__device__ __forceinline__ void row_stats(const uint4 (&u)[L::kRows][L::kPerLane], int gl,
                                          float eps, float (&mean)[L::kRows],
                                          float (&rstd)[L::kRows]) {
#pragma unroll
  for (int k = 0; k < L::kRows; ++k) {
    float s[8] = {};  // eight sums, so that no add waits for the one before
#pragma unroll
    for (int i = 0; i < L::kPerLane; ++i) {
      float f[8];
      unpack8(u[k][i], f);  // chunks past the row are zero
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] += f[e];
    }
    mean[k] = sum8(s);
  }
  group_sums<L::kLanes_>(mean);
#pragma unroll
  for (int k = 0; k < L::kRows; ++k) {
    mean[k] /= C;
    float q[8] = {};
#pragma unroll
    for (int i = 0; i < L::kPerLane; ++i) {
      if (L::has(gl, i)) {
        float f[8];
        unpack8(u[k][i], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - mean[k];
          q[e] += d * d;
        }
      }
    }
    rstd[k] = sum8(q);
  }
  group_sums<L::kLanes_>(rstd);
#pragma unroll
  for (int k = 0; k < L::kRows; ++k) rstd[k] = rsqrtf(rstd[k] / C + eps);
}

// B6's statistics launch: mean and rstd [R] of x [R, C]. A block of
// kLnStatsWarps warps takes one row a lane group straight into registers,
// reduces it, writes mean and rstd and exits; the grid covers R.
template <int C>
__global__ void __launch_bounds__(kLnStatsWarps * 32)
    ln_stats_kernel(const bf16* __restrict__ x, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int R, float eps) {
  using L = StatsLayout<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp * L::kRowsPerWarp + lane / L::kLanes_, gl = lane % L::kLanes_;
  const long long row = static_cast<long long>(blockIdx.x) * L::kGroups + grp;
  uint4 u[1][L::kPerLane];
  load_row<L>(u[0], x + row * C, row < R, gl);
  float mean[1], rstd[1];
  row_stats<L, C>(u, gl, eps, mean, rstd);
  if (row < R && gl == 0) {
    mean_out[row] = mean[0];
    rstd_out[row] = rstd[0];
  }
}

// Launch `ln_stats_kernel` for a width the kernels take (else
// cudaErrorInvalidValue).
inline cudaError_t launch_ln_stats(const bf16* x, float* mean, float* rstd, int R, int C,
                                   float eps, cudaStream_t stream) {
  if (R <= 0) return cudaErrorInvalidValue;
  auto run = [&](auto kernel, int rows) {
    kernel<<<(R + rows - 1) / rows, kLnStatsWarps * 32, 0, stream>>>(x, mean, rstd, R, eps);
    return cudaGetLastError();
  };
  switch (C) {
    case 384: return run(ln_stats_kernel<384>, StatsLayout<384>::kGroups);
    case 1024: return run(ln_stats_kernel<1024>, StatsLayout<1024>::kGroups);
    case 1280: return run(ln_stats_kernel<1280>, StatsLayout<1280>::kGroups);
    case 1408: return run(ln_stats_kernel<1408>, StatsLayout<1408>::kGroups);
    default: return cudaErrorInvalidValue;
  }
}

inline bool ln_width_ok(int C) { return C == 384 || C == 1024 || C == 1280 || C == 1408; }

}  // namespace
