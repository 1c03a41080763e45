// The FlashAttention-2 forward loop shared by B1 (`flash_fwd_dn.cu`, head
// widths 16-64 over [B, H, D, N]) and B3 (`flash_fwd_bhnd.cu`, 32-104 over
// [B, H, N, D]). Both prologues write q and k rotated and rounded,
// token-major, and both main kernels stage v feature-major; from there one
// block of 128 queries (8 warps of 16 rows) runs the same loop over 64-key
// tiles, at the head width W (D, or D padded to a whole mma k-step):
//   * S = Q K^T with mma.sync m16n8k16, already in base-2 units (q carries
//     scale*log2(e));
//   * keys at or past kv_lim, pairs with seg_q < seg_k and, with `causal`,
//     keys after the query are masked;
//   * the running max and denominator in fp32, one exp2 per score, P
//     re-packed from the accumulators as the A operand of P.V;
//   * the epilogue's denominators and, after the output is staged, the
//     natural-log lse; a row with no key gives output 0 and lse -inf.
// The prologues and the epilogues' output layouts stay in the two files.

#pragma once

#include "dn_common.cuh"

namespace {

constexpr int kBlockQ = 128;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;  // 256

// Rows [t0, t0 + kR) of a token-major [n, W] array (rows at or past lim
// become 0) into dst[row][d], 16 bytes a copy.
template <int W, int kR>
__device__ __forceinline__ void copy_rows_async(bf16* dst, const bf16* src, int t0, int lim) {
  constexpr int kChunks = W / 8, kStride = W + kPad;
  for (int i = threadIdx.x; i < kR * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = t0 + r < lim;
    cp_async16(&dst[r * kStride + c * 8], src + (ok ? (long long)(t0 + r) * W + c * 8 : 0), ok);
  }
}

// q [kBlockQ][W + kPad], two k and two v buffers ([kBlockK][W + kPad] and
// [W][kBlockK + kPad]), two key-side segment-id buffers.
template <int W>
constexpr int main_smem_bytes() {
  return (kBlockQ * (W + kPad) + 2 * kBlockK * (W + kPad) + 2 * W * (kBlockK + kPad)) * 2 +
         2 * kBlockK * 4;
}

// This thread's A fragments of the q tile (rows row0 and row0 + 8).
template <int W>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[W / 16][4], const bf16* s_q,
                                             int row0) {
  constexpr int kStride = W + kPad;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) {
    const bf16* r = &s_q[row0 * kStride + ks * 16 + 2 * t4];
    qf[ks][0] = ld_smem_u32(r);
    qf[ks][1] = ld_smem_u32(r + 8 * kStride);
    qf[ks][2] = ld_smem_u32(r + 8);
    qf[ks][3] = ld_smem_u32(r + 8 * kStride + 8);
  }
}

// One k/v tile (keys k0 ..) for this thread's query rows qrow and qrow + 8:
// sk [key][d], sv [d][key], segk the tile's key ids.
template <int W>
__device__ __forceinline__ void attend_tile(float (&acc)[W / 8][4], float (&m_run)[2],
                                            float (&l_run)[2], const uint32_t (&qf)[W / 16][4],
                                            const bf16* sk, const bf16* sv, const int* segk,
                                            const int (&segq)[2], bool use_seg, bool causal,
                                            int k0, int kv_lim, int qrow) {
  constexpr int kSteps = W / 16, kDTiles = W / 8, kNTiles = kBlockK / 8;
  constexpr int kStride = W + kPad, kVStride = kBlockK + kPad;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;

  // S = Q K^T for this warp's 16 rows x 64 keys, already in base-2 units.
  float s[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const bf16* kr = &sk[(nt * 8 + g) * kStride + ks * 16 + 2 * t4];
      mma_bf16(s[nt], qf[ks], ld_smem_u32(kr), ld_smem_u32(kr + 8));
    }
  }

  if (use_seg || causal || k0 + kBlockK > kv_lim) {
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t4 + (e & 1);
        bool ok = k0 + kl < kv_lim;
        if (use_seg) ok = ok && segq[e >> 1] >= segk[kl];
        if (causal) ok = ok && k0 + kl <= qrow + 8 * (e >> 1);
        if (!ok) s[nt][e] = -INFINITY;
      }
    }
  }

  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float base[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row masked so far keeps p = 0
    corr[r] = exp2_approx(m_run[r] - base[r]);
    m_run[r] = mx[r];
  }

  // P = exp2(S - m), re-packed as bf16 A fragments of P.V (16 keys per k-step).
  uint32_t pf[kNTiles / 2][4];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    const float p0 = exp2_approx(s[nt][0] - base[0]);
    const float p1 = exp2_approx(s[nt][1] - base[0]);
    const float p2 = exp2_approx(s[nt][2] - base[1]);
    const float p3 = exp2_approx(s[nt][3] - base[1]);
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
    pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  l_run[0] = l_run[0] * corr[0] + rs[0];
  l_run[1] = l_run[1] * corr[1] + rs[1];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc[dt][0] *= corr[0];
    acc[dt][1] *= corr[0];
    acc[dt][2] *= corr[1];
    acc[dt][3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < kNTiles / 2; ++kk) {
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const bf16* vr = &sv[(dt * 8 + g) * kVStride + kk * 16 + 2 * t4];
      mma_bf16(acc[dt], pf[kk], ld_smem_u32(vr), ld_smem_u32(vr + 8));
    }
  }
}

// The denominators of this thread's two rows: the quad's sums (1 for a row
// with no key).
__device__ __forceinline__ void row_denominators(float (&denom)[2], float (&l_run)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    denom[r] = l_run[r] == 0.f ? 1.f : l_run[r];
  }
}

// The natural-log lse of rows qrow and qrow + 8 written to lse[row] for rows
// below N.
__device__ __forceinline__ void write_lse(float* lse, const float (&denom)[2],
                                          const float (&m_run)[2], int qrow, int N) {
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gn = qrow + 8 * r;
      if (gn < N) {
        const float m_nat = m_run[r] == -INFINITY ? -INFINITY : m_run[r] * kLn2;
        lse[gn] = m_nat + logf(denom[r]);
      }
    }
  }
}

}  // namespace
