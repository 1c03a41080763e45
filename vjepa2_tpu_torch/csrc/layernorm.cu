// LayerNorm forward and backward over bf16 rows, for Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernels `vjepa2_tpu/ops/layernorm.py:103 _ln_fwd_kernel`
// (`pallas_call` `:137`) and `:115 _ln_bwd_kernel` (`:164`). Same contract:
//   * forward: x [R, C] bf16 -> y [R, C] bf16 with fp32 two-pass statistics
//     and affine (`ln_common.cuh`), saving mean and rstd [R] fp32;
//   * backward: from x, dy (bf16, the dtype of x), gamma and the saved mean
//     and rstd: xhat = (x - mean) * rstd, wdy = dy * gamma,
//     c1 = mean(wdy), c2 = mean(wdy * xhat), dx = (wdy - c1 - xhat * c2) * rstd
//     in x's dtype (`ln_backward_f32:88`); dgamma = sum(dy * xhat) and
//     dbeta = sum(dy) over the rows as fp32 partials, one row of C per block
//     of 64 rows, summed by the caller, as the TPU sums its per-cell
//     partials (`:129-130,186`). A block sums its warps' partials in a fixed
//     order, so the result is the same from run to run (no atomics).
// C in {384, 1024, 1280, 1408}; rows 16-byte aligned.
//
// What bounds it on this card: memory. Per element the forward does ~8 and
// the backward ~15 fp32 operations against 4 and 6 bytes moved, far below
// the ~295 operations per byte at which the tensor cores' peak would bind
// (and there are no products to give them).
//
// What the design does about it: each row is read once, 16 bytes a thread,
// into registers (one warp per row; lane l holds chunks l, l + 32, ...), the
// statistics are warp shuffles, and each output is written once; the
// backward keeps dy and x packed in registers for its two passes over the
// row and its dgamma/dbeta partials in registers across the warp's eight
// rows. Not done yet, for later work: rows per warp tuned per width, a
// persistent grid.

#include "ln_common.cuh"

namespace {

constexpr int kBwdRowsPerWarp = 8;
constexpr int kBwdRowsPerBlock = kLnWarps * kBwdRowsPerWarp;  // 64 rows: one partial row

template <int C>
__global__ void __launch_bounds__(kLnThreads)
    ln_bwd_kernel(const bf16* x, const bf16* dy, const float* gamma, const float* mean,
                  const float* rstd, bf16* dx, float* dg_part, float* db_part, int R) {
  using L = RowLayout<C>;
  __shared__ float s_red[kLnWarps * C];  // 45 KB at C 1408
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float dg[L::kPerLane][8], db[L::kPerLane][8];
#pragma unroll
  for (int i = 0; i < L::kPerLane; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[i][e] = db[i][e] = 0.f;
  }

  for (int j = 0; j < kBwdRowsPerWarp; ++j) {
    const int row = blockIdx.x * kBwdRowsPerBlock + warp * kBwdRowsPerWarp + j;
    if (row >= R) break;  // uniform across the warp
    uint4 xu[L::kPerLane], du[L::kPerLane];
    load_row<C>(xu, x + (long long)row * C);
    load_row<C>(du, dy + (long long)row * C);
    const float m = mean[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < L::kPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < L::kChunks) {
        float xf[8], df[8];
        unpack8(xu[i], xf);
        unpack8(du[i], df);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xhat = (xf[e] - m) * r;
          const float wdy = df[e] * gamma[c * 8 + e];
          s1 += wdy;
          s2 += wdy * xhat;
        }
      }
    }
    const float c1 = warp_sum(s1) / C, c2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < L::kPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < L::kChunks) {
        float xf[8], df[8], out[8];
        unpack8(xu[i], xf);
        unpack8(du[i], df);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xhat = (xf[e] - m) * r;
          const float wdy = df[e] * gamma[c * 8 + e];
          out[e] = (wdy - c1 - xhat * c2) * r;
          dg[i][e] += df[e] * xhat;
          db[i][e] += df[e];
        }
        *reinterpret_cast<uint4*>(dx + (long long)row * C + c * 8) = pack8(out);
      }
    }
  }

  // the block's partial row: the warps' sums added in warp order
  auto reduce = [&](const float (&acc)[L::kPerLane][8], float* part) {
#pragma unroll
    for (int i = 0; i < L::kPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < L::kChunks) {
#pragma unroll
        for (int e = 0; e < 8; ++e) s_red[warp * C + c * 8 + e] = acc[i][e];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < C; col += kLnThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kLnWarps; ++w) s += s_red[w * C + col];
      part[(long long)blockIdx.x * C + col] = s;
    }
    __syncthreads();
  };
  reduce(dg, dg_part);
  reduce(db, db_part);
}

}  // namespace

// Rows of dgamma/dbeta partials `vjepa2_layernorm_bwd_bf16` writes for R rows.
extern "C" int vjepa2_layernorm_bwd_blocks(int R) {
  return (R + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
}

// x [R, C] bf16 -> y [R, C] bf16 (y may be null: statistics only), mean and
// rstd [R] fp32; gamma, beta [C] fp32. Every array contiguous and 16-byte
// aligned. Returns the cudaError_t of the launch (0 on success).
extern "C" int vjepa2_layernorm_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                         void* y, void* mean, void* rstd, int R, int C,
                                         float eps, void* stream) {
  if (R <= 0 || !ln_width_ok(C) || !aligned16(x) || !aligned16(gamma) || !aligned16(beta) ||
      (y != nullptr && !aligned16(y)))
    return cudaErrorInvalidValue;
  return launch_ln_fwd(static_cast<const bf16*>(x), static_cast<const float*>(gamma),
                       static_cast<const float*>(beta), static_cast<bf16*>(y),
                       static_cast<float*>(mean), static_cast<float*>(rstd), R, C, eps,
                       static_cast<cudaStream_t>(stream));
}

// x, dy [R, C] bf16, gamma [C], mean and rstd [R] fp32 -> dx [R, C] bf16 and
// the partials dg_part, db_part [vjepa2_layernorm_bwd_blocks(R), C] fp32.
// Every array contiguous; x, dy and dx 16-byte aligned.
extern "C" int vjepa2_layernorm_bwd_bf16(const void* x, const void* dy, const void* gamma,
                                         const void* mean, const void* rstd, void* dx,
                                         void* dg_part, void* db_part, int R, int C,
                                         void* stream) {
  if (R <= 0 || !ln_width_ok(C) || !aligned16(x) || !aligned16(dy) || !aligned16(dx))
    return cudaErrorInvalidValue;
  const dim3 grid(vjepa2_layernorm_bwd_blocks(R));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dyp = static_cast<const bf16*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  bf16* dxp = static_cast<bf16*>(dx);
  float* dgp = static_cast<float*>(dg_part);
  float* dbp = static_cast<float*>(db_part);
  auto run = [&](auto kernel) {
    kernel<<<grid, kLnThreads, 0, s>>>(xp, dyp, g, m, r, dxp, dgp, dbp, R);
  };
  switch (C) {
    case 384: run(ln_bwd_kernel<384>); break;
    case 1024: run(ln_bwd_kernel<1024>); break;
    case 1280: run(ln_bwd_kernel<1280>); break;
    case 1408: run(ln_bwd_kernel<1408>); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
