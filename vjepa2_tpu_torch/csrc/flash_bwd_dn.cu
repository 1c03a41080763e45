// Flash-attention backward over [B, H, D, N] ("DN") operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vjepa2_tpu/ops/flash_attention_dn.py:298
// _bwd_fused_kernel_dn` (wrapper `_flash_bwd_bhdn:379`, `pallas_call` `:444`).
// Same contract, given what the forward (B1, `flash_fwd_dn.cu`) saved:
//   * q, k, v, out, do bf16 [B, H, D, N|M], any element strides;
//     lse [B, H, N] fp32, natural log; D in {16, 32, 48, 64};
//   * the scores are recomputed from q and k rotated and rounded exactly as
//     B1's prologue does (`dn_common.cuh:rope_pair`, `round_scaled`): q rounded
//     after folding in scale*log2(e), k rounded after the rotation; then
//     p = exp2(s - lse*log2(e)) is the forward's softmax. A row whose lse is
//     -inf (no key to attend) gets p = 0; keys at or past kv_lim and pairs
//     with seg_q < seg_k get p = 0;
//   * delta = rowsum(do * out) in fp32; dv = p^T do; dp = do v^T;
//     ds = p (dp - delta) scale, rounded to bf16 as the TPU kernel does;
//     dk = ds^T q_u with q_u the rotated q rounded WITHOUT the scale (`:335`);
//     dq = ds k_rot;
//   * the RoPE adjoint (`_rope_rotate_dn_t:109`; not R(-theta), the tables'
//     pairs carry different angles) on dq and dk in fp32 after accumulation;
//     dq, dk, dv written bf16 [B, H, D, N|M] contiguous.
//
// What bounds it on this card: per score the tensor cores do 2.5x the
// forward's products (S, dP, dV, dK and dQ against S and PV: 10*Dh FLOPs,
// 640 at Dh 64), while p is recomputed (one exp2) and ds costs about ten more
// scalar operations (mask, subtract, multiply, two conversions, packing). As
// in B1 the scalar work and the latency of dependent mma.sync chains bound it,
// not the tensor-core rate or memory; at these lengths (N <= 2048) every
// operand tile is re-read from L2 by N/64 blocks.
//
// What this version does about it (the FlashAttention-2 backward layout, not
// the TPU kernel's fp32 dk/dv partials [B, H, nq, D, M] summed in XLA, which
// work around scoped VMEM):
//   * a prologue (`flash_bwd_common.cuh:bwd_prologue_kernel`, shared with the
//     BHND backward) runs once per call: it rotates and rounds q and k as B1
//     does, computes delta and lse*log2(e), and writes
//     every operand in the layout its mma.sync fragments want (token-major
//     q_s, do, k_rot, v; feature-major q_u, do, k_rot), padded to whole
//     64-token tiles with zeros, so the main kernels copy 16 bytes a thread
//     with cp.async and never re-rotate or read a RoPE table in their loops;
//   * `flash_bwd_dkdv_kernel`: one block per (b, h, 64 keys) loops over the
//     query tiles (double-buffered cp.async) and keeps dk and dv in fp32
//     registers; p and ds never leave registers (accumulators re-packed as
//     the A operand of the next product); the dk adjoint is its epilogue;
//   * `flash_bwd_dq_kernel`: one block per (b, h, 64 queries) loops over the
//     key tiles, recomputes p and ds, and keeps dq in fp32 registers. dq thus
//     comes from a second kernel rather than from fp32 atomics: the result is
//     deterministic, at the price of S and dP computed twice (7 products per
//     score instead of 5).
// Not done yet, for later work: wgmma, TMA, warp specialisation, skipping
// query tiles that a segment mask hides entirely.

#include "flash_bwd_common.cuh"

namespace {

// A fragments (m16n8k16, rows row0 and row0 + 8) of a [row][d] tile.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* s, int row0) {
  constexpr int kStride = D + kPad;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* r = &s[row0 * kStride + ks * 16 + 2 * (threadIdx.x & 3)];
    f[ks][0] = ld_smem_u32(r);
    f[ks][1] = ld_smem_u32(r + 8 * kStride);
    f[ks][2] = ld_smem_u32(r + 8);
    f[ks][3] = ld_smem_u32(r + 8 * kStride + 8);
  }
}

// acc[nt] = A (this warp's 16 rows, fragments f) times B^T, B a [col][d] tile:
// 16 rows x kTile columns.
template <int D>
__device__ __forceinline__ void rows_times_tile(float (&acc)[kTile / 8][4],
                                                const uint32_t (&f)[D / 16][4], const bf16* s) {
  constexpr int kStride = D + kPad;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* r = &s[(nt * 8 + g) * kStride + ks * 16 + 2 * t4];
      mma_bf16(acc[nt], f[ks], ld_smem_u32(r), ld_smem_u32(r + 8));
    }
  }
}

// RoPE adjoint of accumulator rows (tokens n0 and n0 + 8, each < lim or
// skipped): pairs (d, d + D/2) sit in tiles dt and dt + D/16 of one thread.
template <int D>
__device__ __forceinline__ void rope_adjoint(float (&acc)[D / 8][4], const float* cos_t,
                                             const float* sin_t, const BwdParams& p, int n0,
                                             int lim) {
  constexpr int kHalfTiles = D / 16, kHalf = D / 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int dt = 0; dt < kHalfTiles; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 8 * (e >> 1);
      if (n >= lim) continue;
      const int d = dt * 8 + 2 * t4 + (e & 1);
      const long long i_lo = d * p.t_d + n * p.t_n;
      const long long i_hi = (d + kHalf) * p.t_d + n * p.t_n;
      const float g_lo = acc[dt][e], g_hi = acc[dt + kHalfTiles][e];
      acc[dt][e] = g_lo * cos_t[i_lo] + g_hi * sin_t[i_hi];
      acc[dt + kHalfTiles][e] = g_hi * cos_t[i_hi] - g_lo * sin_t[i_lo];
    }
  }
}

// Accumulator rows (this warp's 16 rows of the block's tile starting at t0)
// -> dst [D, len] bf16 contiguous, through s_o [d][row] in shared memory.
template <int D>
__device__ __forceinline__ void write_dn(bf16* dst, const float (&acc)[D / 8][4], bf16* s_o,
                                         int t0, int len) {
  constexpr int kTStride = kTile + kPad;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int row0 = warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d0 = dt * 8 + 2 * t4;
    s_o[d0 * kTStride + row0] = __float2bfloat16_rn(acc[dt][0]);
    s_o[(d0 + 1) * kTStride + row0] = __float2bfloat16_rn(acc[dt][1]);
    s_o[d0 * kTStride + row0 + 8] = __float2bfloat16_rn(acc[dt][2]);
    s_o[(d0 + 1) * kTStride + row0 + 8] = __float2bfloat16_rn(acc[dt][3]);
  }
  __syncthreads();
  if (len % 8 == 0) {
    for (int i = threadIdx.x; i < D * (kTile / 8); i += kThreads) {
      const int d = i / (kTile / 8), grp = i % (kTile / 8), n = t0 + grp * 8;
      if (n < len) {
        *reinterpret_cast<uint4*>(dst + (long long)d * len + n) =
            *reinterpret_cast<const uint4*>(&s_o[d * kTStride + grp * 8]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < D * kTile; i += kThreads) {
      const int d = i / kTile, r = i % kTile, n = t0 + r;
      if (n < len) dst[(long long)d * len + n] = s_o[d * kTStride + r];
    }
  }
}

template <int D>
constexpr int dkdv_smem_bytes() {
  // two stages of: q_s, do [kTile][D + kPad]; q_u, do [D][kTile + kPad]; lse2, delta, seg_q
  return 2 * ((2 * kTile * (D + kPad) + 2 * D * (kTile + kPad)) * 2 + 3 * kTile * 4);
}

template <int D>
constexpr int dq_smem_bytes() {
  // two stages of: k_rot, v [kTile][D + kPad]; k_rot [D][kTile + kPad]; seg_k
  return 2 * ((2 * kTile * (D + kPad) + D * (kTile + kPad)) * 2 + kTile * 4);
}

// dk and dv for 64 keys of one (b, h), looping over the query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int kDTiles = D / 8, kNTiles = kTile / 8;
  constexpr int kStride = D + kPad, kTStride = kTile + kPad;
  constexpr int kStageBf = 2 * kTile * kStride + 2 * D * kTStride;  // bf16 elements
  constexpr int kStageBytes = kStageBf * 2 + 3 * kTile * 4;

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int buf) { return smem + buf * kStageBytes; };

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;
  const long long bh = (long long)b * p.H + h;
  const bf16* qs = p.qs_tok + bh * p.Np * D;
  const bf16* dot = p.do_tok + bh * p.Np * D;
  const bf16* qu = p.qu_dn + bh * D * p.Np;
  const bf16* dodn = p.do_dn + bh * D * p.Np;
  const float* lse2 = p.lse2 + bh * p.Np;
  const float* delta = p.delta + bh * p.Np;
  const bool use_seg = p.seg_q != nullptr;
  const int* segq_p = use_seg ? p.seg_q + b * p.segq_b : nullptr;
  const int* segk_p = use_seg ? p.seg_k + b * p.segk_b : nullptr;

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  if (k0 < p.kv_lim) {  // uniform; a tile wholly past kv_lim keeps dk = dv = 0
    // this warp's rows of k_rot and v as A fragments, staged in stage 1
    bf16* s_k = reinterpret_cast<bf16*>(stage(1));
    bf16* s_v = s_k + kTile * kStride;
    copy_tok_async<D>(s_k, p.kr_tok + bh * p.Mp * D, k0);
    copy_tok_async<D>(s_v, p.v_tok + bh * p.Mp * D, k0);
    cp_async_commit();

    auto load_q = [&](int qt, int buf) {
      const int q0 = qt * kTile;
      bf16* s_qs = reinterpret_cast<bf16*>(stage(buf));
      bf16* s_do = s_qs + kTile * kStride;
      bf16* s_qu = s_do + kTile * kStride;
      bf16* s_dt = s_qu + D * kTStride;
      float* s_f = reinterpret_cast<float*>(s_dt + D * kTStride);
      copy_tok_async<D>(s_qs, qs, q0);
      copy_tok_async<D>(s_do, dot, q0);
      copy_dn_async<D>(s_qu, qu, q0, p.Np);
      copy_dn_async<D>(s_dt, dodn, q0, p.Np);
      if (tid < kTile) {
        s_f[tid] = lse2[q0 + tid];
        s_f[kTile + tid] = delta[q0 + tid];
        if (use_seg) {
          reinterpret_cast<int*>(s_f)[2 * kTile + tid] = q0 + tid < p.N ? segq_p[q0 + tid] : 0;
        }
      }
    };
    load_q(0, 0);
    cp_async_commit();
    cp_async_wait<1>();  // k and v have landed
    __syncthreads();
    uint32_t kf[D / 16][4], vf[D / 16][4];
    load_a_frags<D>(kf, s_k, row0);
    load_a_frags<D>(vf, s_v, row0);
    int segk[2] = {0, 0};
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + row0 + 8 * r;
      key_ok[r] = key < p.kv_lim;
      if (use_seg && key < p.M) segk[r] = segk_p[key];
    }
    __syncthreads();  // stage 1 is refilled below

    const int n_qtiles = p.Np / kTile;
    for (int qt = 0; qt < n_qtiles; ++qt) {
      const int buf = qt & 1;
      if (qt + 1 < n_qtiles) {
        load_q(qt + 1, buf ^ 1);  // that stage was released by the last barrier
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* s_qs = reinterpret_cast<const bf16*>(stage(buf));
      const bf16* s_do = s_qs + kTile * kStride;
      const bf16* s_qu = s_do + kTile * kStride;
      const bf16* s_dt = s_qu + D * kTStride;
      const float* s_lse = reinterpret_cast<const float*>(s_dt + D * kTStride);
      const float* s_delta = s_lse + kTile;
      const int* s_segq = reinterpret_cast<const int*>(s_delta + kTile);

      float s[kNTiles][4], dp[kNTiles][4];
      rows_times_tile<D>(s, kf, s_qs);   // S^T = K_rot Q_s^T, base-2 units
      rows_times_tile<D>(dp, vf, s_do);  // dP^T = V dO^T

      uint32_t pf[kNTiles / 2][4], dsf[kNTiles / 2][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          bool ok = key_ok[e >> 1];
          if (use_seg) ok = ok && s_segq[col] >= segk[e >> 1];
          pv[e] = ok ? exp2_approx(s[nt][e] - s_lse[col]) : 0.f;
          dsv[e] = pv[e] * (dp[nt][e] - s_delta[col]) * p.scale;
        }
        pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(pv[0], pv[1]);
        pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
        dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }
      packed_times_dn<D>(dv, pf, s_dt);   // dV += P^T dO
      packed_times_dn<D>(dk, dsf, s_qu);  // dK += dS^T Q_u
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    if (p.cos != nullptr) {
      rope_adjoint<D>(dk, p.cos + b * p.t_b, p.sin + b * p.t_b, p, k0 + row0, p.M);
    }
  }
  bf16* s_o = reinterpret_cast<bf16*>(stage(0));
  write_dn<D>(p.dk + bh * D * p.M, dk, s_o, k0, p.M);
  __syncthreads();
  write_dn<D>(p.dv + bh * D * p.M, dv, s_o, k0, p.M);
}

// dq for 64 queries of one (b, h), looping over the key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kDTiles = D / 8, kNTiles = kTile / 8;
  constexpr int kStride = D + kPad, kTStride = kTile + kPad;
  constexpr int kStageBf = 2 * kTile * kStride + D * kTStride;
  constexpr int kStageBytes = kStageBf * 2 + kTile * 4;

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int buf) { return smem + buf * kStageBytes; };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;
  const long long bh = (long long)b * p.H + h;
  const bf16* kr = p.kr_tok + bh * p.Mp * D;
  const bf16* vt = p.v_tok + bh * p.Mp * D;
  const bf16* krdn = p.kr_dn + bh * D * p.Mp;
  const bool use_seg = p.seg_q != nullptr;
  const int* segq_p = use_seg ? p.seg_q + b * p.segq_b : nullptr;
  const int* segk_p = use_seg ? p.seg_k + b * p.segk_b : nullptr;

  // this warp's rows of q_s and do as A fragments, staged in stage 1
  bf16* s_q = reinterpret_cast<bf16*>(stage(1));
  bf16* s_d = s_q + kTile * kStride;
  copy_tok_async<D>(s_q, p.qs_tok + bh * p.Np * D, q0);
  copy_tok_async<D>(s_d, p.do_tok + bh * p.Np * D, q0);
  cp_async_commit();

  auto load_k = [&](int kt, int buf) {
    const int k0 = kt * kTile;
    bf16* s_k = reinterpret_cast<bf16*>(stage(buf));
    bf16* s_v = s_k + kTile * kStride;
    bf16* s_kt = s_v + kTile * kStride;
    int* s_segk = reinterpret_cast<int*>(s_kt + D * kTStride);
    copy_tok_async<D>(s_k, kr, k0);
    copy_tok_async<D>(s_v, vt, k0);
    copy_dn_async<D>(s_kt, krdn, k0, p.Mp);
    if (use_seg && tid < kTile) s_segk[tid] = k0 + tid < p.M ? segk_p[k0 + tid] : 0;
  };
  load_k(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D>(qf, s_q, row0);
  load_a_frags<D>(df, s_d, row0);
  float l2[2], dl[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + row0 + 8 * r;  // < Np: the scratch is padded
    l2[r] = p.lse2[bh * p.Np + n];
    dl[r] = p.delta[bh * p.Np + n];
    if (use_seg && n < p.N) segq[r] = segq_p[n];
  }
  __syncthreads();

  float dq[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  const int n_ktiles = (p.kv_lim + kTile - 1) / kTile;  // tiles past kv_lim are all masked
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kTile, buf = kt & 1;
    if (kt + 1 < n_ktiles) {
      load_k(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* s_k = reinterpret_cast<const bf16*>(stage(buf));
    const bf16* s_v = s_k + kTile * kStride;
    const bf16* s_kt = s_v + kTile * kStride;
    const int* s_segk = reinterpret_cast<const int*>(s_kt + D * kTStride);

    float s[kNTiles][4], dp[kNTiles][4];
    rows_times_tile<D>(s, qf, s_k);   // S = Q_s K_rot^T, base-2 units
    rows_times_tile<D>(dp, df, s_v);  // dP = dO V^T

    uint32_t dsf[kNTiles / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t4 + (e & 1);
        bool ok = k0 + kl < p.kv_lim;
        if (use_seg) ok = ok && segq[e >> 1] >= s_segk[kl];
        const float pv = ok ? exp2_approx(s[nt][e] - l2[e >> 1]) : 0.f;
        dsv[e] = pv * (dp[nt][e] - dl[e >> 1]) * p.scale;
      }
      dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }
    packed_times_dn<D>(dq, dsf, s_kt);  // dQ += dS K_rot
    __syncthreads();
  }
  if (p.cos != nullptr) {
    rope_adjoint<D>(dq, p.cos + b * p.t_b, p.sin + b * p.t_b, p, q0 + row0, p.N);
  }
  write_dn<D>(p.dq + bh * D * p.N, dq, reinterpret_cast<bf16*>(stage(0)), q0, p.N);
}

template <int D>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int kDkdvSmem = dkdv_smem_bytes<D>();
  constexpr int kDqSmem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return err;
  const int longest = p.Np > p.Mp ? p.Np : p.Mp;
  bwd_prologue_kernel<D, D><<<dim3(longest / kTile, p.H, B), kPrologueThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<dim3(p.Mp / kTile, p.H, B), kThreads, kDkdvSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3(p.Np / kTile, p.H, B), kThreads, kDqSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch `vjepa2_flash_bwd_dn_bf16` needs for these sizes.
extern "C" long long vjepa2_flash_bwd_dn_scratch_bytes(int B, int H, int D, int N, int M) {
  return carve(nullptr, nullptr, B, H, D, N, M);
}

// strides: 24 element strides, in order
//   q (b, h, d, n), k (b, h, d, n), v (b, h, d, n), out (b, h, d, n),
//   do (b, h, d, n), RoPE tables (b, d, n), segment ids (b).
// cos/sin null: no RoPE. seg null: no segment mask. lse is [B, H, N]
// contiguous; dq [B, H, D, N], dk and dv [B, H, D, M] are written contiguous.
// scratch: vjepa2_flash_bwd_dn_scratch_bytes(B, H, D, N, M) bytes, 256-byte
// aligned. qscale: scale*log2(e) exactly as B1 received it, so q rounds the
// same. Returns the cudaError_t of the launches (0 on success).
extern "C" int vjepa2_flash_bwd_dn_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        const void* cos_t, const void* sin_t, const void* seg,
                                        void* dq, void* dk, void* dv, void* scratch, int B,
                                        int H, int D, int N, int M, int kv_lim,
                                        const long long* strides, float scale, float qscale,
                                        void* stream) {
  BwdParams p;
  Strides* all[] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo};
  for (int i = 0; i < 5; ++i) {  // (b, h, d, n) here, (b, h, n, d) in Strides
    *all[i] = {strides[4 * i], strides[4 * i + 1], strides[4 * i + 3], strides[4 * i + 2]};
  }
  p.t_b = strides[20];
  p.t_d = strides[21];
  p.t_n = strides[22];
  p.seg_q = p.seg_k = static_cast<const int*>(seg);  // one id array for queries and keys
  p.segq_b = p.segk_b = strides[23];
  p.causal = 0;
  set_common(p, q, k, v, out, dout, lse, cos_t, sin_t, dq, dk, dv, H, N, M, kv_lim, scale,
             qscale);
  if (N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M || reinterpret_cast<uintptr_t>(scratch) % 256 ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorInvalidValue;
  carve(&p, static_cast<char*>(scratch), B, H, D, N, M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 48: return launch<48>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
