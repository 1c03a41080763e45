// Flash-attention backward over [B, H, N, D] ("BHND") operands, for Hopper (sm_90a).
//
// Replaces both TPU backward kernels of the BHND family:
//   * `vjepa2_tpu/ops/flash_attention.py:511 _bwd_fused_kernel` (B4, one
//     pass, `pallas_call` `:688`, fp32 dk/dv partials [B, H, nq, M, D]
//     summed in XLA), and
//   * `:361 _dq_kernel` plus `:434 _dkv_kernel` (B5, two passes, `:713`,
//     `:755`),
// between which `_flash_bwd_bhnd:613` chooses by a scoped-VMEM rule of the
// TPU (`:660-664`). Both compute one function, and so does this file, given
// what the forward (B3, `flash_fwd_bhnd.cu`) saved:
//   * q, k, v, out, do bf16 [B, H, N|M, D], any element strides; lse
//     [B, H, N] fp32, natural log (the forward's, or a global one passed in
//     from outside, as a ring hop does); D in {80, 88, 104};
//   * the scores are recomputed from q and k rotated and rounded exactly as
//     B3's prologue does (`dn_common.cuh:rope_pair`, `round_scaled`), so
//     p = exp2(s - lse*log2(e)) is the forward's softmax. A row whose lse is
//     -inf gets p = 0; keys at or past kv_lim, pairs with seg_q < seg_k and,
//     with `causal`, keys after the query get p = 0;
//   * delta = rowsum(do * out) in fp32; dv = p^T do; dp = do v^T;
//     ds = p (dp - delta) scale, rounded to bf16 as the TPU kernels do;
//     dk = ds^T q_u with q_u the rotated q rounded WITHOUT the scale (B4's
//     choice; B5 folds the scale into k instead, `:473-475`, a rounding
//     choice of the TPU, not part of the function); dq = ds k_rot;
//   * the RoPE adjoint (`_rope_rotate_t:120`; not R(-theta): the two slots of
//     a pair carry different angles) on dq and dk in fp32 after
//     accumulation; dq, dk, dv written bf16 [B, H, N|M, D] contiguous.
//
// What bounds it on this card: 10*Dh FLOPs per score on the tensor cores
// (S, dP, dV, dK, dQ) against a dozen scalar operations (exp2, mask,
// subtract, multiply, conversions, packing), as in B2: issue and the latency
// of dependent mma.sync chains, not the tensor-core rate or memory.
//
// What this version does about it: B2's design (`flash_bwd_dn.cu`), which is
// B5's two-pass structure computing B4's function, with the head dim padded
// to Dp, a whole mma k-step (80 -> 80, 88 -> 96, 104 -> 112):
//   * B2's prologue (`flash_bwd_common.cuh:bwd_prologue_kernel`) rotates and
//     rounds q and k once, computes delta and lse*log2(e), and writes every
//     operand in the layout its mma.sync fragments want (token-major q_s,
//     do, k_rot, v; feature-major q_u, do, k_rot), zero-padded to whole
//     64-token tiles and to Dp features;
//   * `flash_bwd_bhnd_dkdv_kernel`: one block per (b, h, 64 keys) loops over
//     the query tiles (double-buffered cp.async), dk and dv in fp32
//     registers; k and v stay in shared memory and their A fragments are
//     loaded per k-step, which keeps the wider accumulators in registers;
//   * `flash_bwd_bhnd_dq_kernel`: one block per (b, h, 64 queries) loops
//     over the key tiles, deterministic (no atomics);
//   * both epilogues stage the fp32 accumulators in shared memory: the
//     split-half pairs (d, d + D/2) of D 88 and 104 do not fall in one
//     thread's accumulator tiles, so the adjoint reads them from there.
// Not done yet, for later work: wgmma, TMA, warp specialisation, skipping
// tiles that a segment mask hides entirely.

#include "flash_bwd_common.cuh"

namespace {

// acc[nt] = A B^T, A a [row][d] tile (this warp's rows row0 and row0 + 8),
// B a [col][d] tile: 16 rows x kTile columns. A's fragments are loaded per
// k-step, so only four of its registers are live.
template <int Dp>
__device__ __forceinline__ void rows_times_tile(float (&acc)[kTile / 8][4], const bf16* a,
                                                const bf16* bt, int row0) {
  constexpr int kStride = Dp + kPad;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Dp / 16; ++ks) {
    const bf16* r = &a[row0 * kStride + ks * 16 + 2 * t4];
    const uint32_t f[4] = {ld_smem_u32(r), ld_smem_u32(r + 8 * kStride), ld_smem_u32(r + 8),
                           ld_smem_u32(r + 8 * kStride + 8)};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const bf16* c = &bt[(nt * 8 + g) * kStride + ks * 16 + 2 * t4];
      mma_bf16(acc[nt], f, ld_smem_u32(c), ld_smem_u32(c + 8));
    }
  }
}

// Accumulator rows (this warp's 16 rows of the block's tile at t0) -> rows
// t0 + r < lim of dst, a [*, D] bf16 array, through fp32 staging in s_f
// [kTile][Dp + 4]; the RoPE adjoint R^T first when cos_t is given (pairs
// (d, d + D/2) read back from s_f, wherever their accumulators were).
template <int D, int Dp>
__device__ __forceinline__ void write_rows(bf16* dst, const float (&acc)[Dp / 8][4], float* s_f,
                                           const float* cos_t, const float* sin_t,
                                           const BwdParams& p, int t0, int lim) {
  constexpr int kFStride = Dp + 4, kHalf = D / 2;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int row0 = warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < Dp / 8; ++dt) {
    const int d0 = dt * 8 + 2 * t4;
    s_f[row0 * kFStride + d0] = acc[dt][0];
    s_f[row0 * kFStride + d0 + 1] = acc[dt][1];
    s_f[(row0 + 8) * kFStride + d0] = acc[dt][2];
    s_f[(row0 + 8) * kFStride + d0 + 1] = acc[dt][3];
  }
  __syncthreads();
  if (cos_t != nullptr) {
    for (int i = threadIdx.x; i < kTile * kHalf; i += kThreads) {
      const int r = i / kHalf, d = i % kHalf, n = t0 + r;
      if (n >= lim) continue;
      const long long i_lo = n * p.t_n + d * p.t_d;
      const long long i_hi = n * p.t_n + (d + kHalf) * p.t_d;
      const float g_lo = s_f[r * kFStride + d], g_hi = s_f[r * kFStride + d + kHalf];
      dst[(long long)n * D + d] = __float2bfloat16_rn(g_lo * cos_t[i_lo] + g_hi * sin_t[i_hi]);
      dst[(long long)n * D + d + kHalf] =
          __float2bfloat16_rn(g_hi * cos_t[i_hi] - g_lo * sin_t[i_lo]);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i % D, n = t0 + r;
      if (n < lim) dst[(long long)n * D + d] = __float2bfloat16_rn(s_f[r * kFStride + d]);
    }
  }
}

template <int Dp>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  // q_s, do [kTile][Dp + kPad]; q_u, do [Dp][kTile + kPad]; lse2, delta, seg_q
  return (2 * kTile * (Dp + kPad) + 2 * Dp * (kTile + kPad)) * 2 + 3 * kTile * 4;
}

template <int Dp>
constexpr int dkdv_smem_bytes() {
  // two stages, then k_rot and v [kTile][Dp + kPad] for the whole block
  return 2 * dkdv_stage_bytes<Dp>() + 2 * kTile * (Dp + kPad) * 2;
}

template <int Dp>
__host__ __device__ constexpr int dq_stage_bytes() {
  // k_rot, v [kTile][Dp + kPad]; k_rot [Dp][kTile + kPad]; seg_k
  return (2 * kTile * (Dp + kPad) + Dp * (kTile + kPad)) * 2 + kTile * 4;
}

template <int Dp>
constexpr int dq_smem_bytes() {
  // two stages, then q_s and do [kTile][Dp + kPad] for the whole block
  return 2 * dq_stage_bytes<Dp>() + 2 * kTile * (Dp + kPad) * 2;
}

// dk and dv for 64 keys of one (b, h), looping over the query tiles.
template <int D, int Dp>
__global__ void __launch_bounds__(kThreads) flash_bwd_bhnd_dkdv_kernel(const BwdParams p) {
  constexpr int kDTiles = Dp / 8, kNTiles = kTile / 8;
  constexpr int kStride = Dp + kPad, kTStride = kTile + kPad;
  constexpr int kStageBytes = dkdv_stage_bytes<Dp>();
  static_assert(kTile * (Dp + 4) * 4 <= kStageBytes, "the fp32 epilogue fits in one stage");

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int buf) { return smem + buf * kStageBytes; };
  bf16* s_k = reinterpret_cast<bf16*>(smem + 2 * kStageBytes);
  bf16* s_v = s_k + kTile * kStride;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);
  const long long bh = (long long)b * p.H + h;
  const bf16* qs = p.qs_tok + bh * p.Np * Dp;
  const bf16* dot = p.do_tok + bh * p.Np * Dp;
  const bf16* qu = p.qu_dn + bh * Dp * p.Np;
  const bf16* dodn = p.do_dn + bh * Dp * p.Np;
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

  const int n_qtiles = p.Np / kTile;
  const int qt_begin = p.causal ? k0 / kTile : 0;  // earlier queries see none of these keys
  if (k0 < p.kv_lim && qt_begin < n_qtiles) {  // uniform; else dk = dv = 0
    copy_tok_async<Dp>(s_k, p.kr_tok + bh * p.Mp * Dp, k0);
    copy_tok_async<Dp>(s_v, p.v_tok + bh * p.Mp * Dp, k0);
    cp_async_commit();

    auto load_q = [&](int qt, int buf) {
      const int q0 = qt * kTile;
      bf16* s_qs = reinterpret_cast<bf16*>(stage(buf));
      bf16* s_do = s_qs + kTile * kStride;
      bf16* s_qu = s_do + kTile * kStride;
      bf16* s_dt = s_qu + Dp * kTStride;
      float* s_fl = reinterpret_cast<float*>(s_dt + Dp * kTStride);
      copy_tok_async<Dp>(s_qs, qs, q0);
      copy_tok_async<Dp>(s_do, dot, q0);
      copy_dn_async<Dp>(s_qu, qu, q0, p.Np);
      copy_dn_async<Dp>(s_dt, dodn, q0, p.Np);
      if (tid < kTile) {
        s_fl[tid] = lse2[q0 + tid];
        s_fl[kTile + tid] = delta[q0 + tid];
        if (use_seg) {
          reinterpret_cast<int*>(s_fl)[2 * kTile + tid] = q0 + tid < p.N ? segq_p[q0 + tid] : 0;
        }
      }
    };
    load_q(qt_begin, 0);
    cp_async_commit();
    int segk[2] = {0, 0};
    bool key_ok[2];
    int key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      key[r] = k0 + row0 + 8 * r;
      key_ok[r] = key[r] < p.kv_lim;
      if (use_seg && key[r] < p.M) segk[r] = segk_p[key[r]];
    }

    for (int qt = qt_begin; qt < n_qtiles; ++qt) {
      const int buf = (qt - qt_begin) & 1, q0 = qt * kTile;
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
      const bf16* s_dt = s_qu + Dp * kTStride;
      const float* s_lse = reinterpret_cast<const float*>(s_dt + Dp * kTStride);
      const float* s_delta = s_lse + kTile;
      const int* s_segq = reinterpret_cast<const int*>(s_delta + kTile);

      float s[kNTiles][4];
      rows_times_tile<Dp>(s, s_k, s_qs, row0);  // S^T = K_rot Q_s^T, base-2 units
      uint32_t pf[kNTiles / 2][4];
      float pv[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          bool ok = key_ok[e >> 1];
          if (use_seg) ok = ok && s_segq[col] >= segk[e >> 1];
          if (p.causal) ok = ok && key[e >> 1] <= q0 + col;
          pv[nt][e] = ok ? exp2_approx(s[nt][e] - s_lse[col]) : 0.f;
        }
        pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(pv[nt][0], pv[nt][1]);
        pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[nt][2], pv[nt][3]);
      }
      packed_times_dn<Dp>(dv, pf, s_dt);  // dV += P^T dO

      rows_times_tile<Dp>(s, s_v, s_do, row0);  // dP^T = V dO^T (reuses s)
      uint32_t dsf[kNTiles / 2][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          dsv[e] = pv[nt][e] * (s[nt][e] - s_delta[col]) * p.scale;
        }
        dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
        dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }
      packed_times_dn<Dp>(dk, dsf, s_qu);  // dK += dS^T Q_u
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  }
  float* s_f = reinterpret_cast<float*>(stage(0));
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  write_rows<D, Dp>(p.dk + bh * p.M * D, dk, s_f, cos_t, sin_t, p, k0, p.M);
  __syncthreads();
  write_rows<D, Dp>(p.dv + bh * p.M * D, dv, s_f, nullptr, nullptr, p, k0, p.M);
}

// dq for 64 queries of one (b, h), looping over the key tiles.
template <int D, int Dp>
__global__ void __launch_bounds__(kThreads) flash_bwd_bhnd_dq_kernel(const BwdParams p) {
  constexpr int kDTiles = Dp / 8, kNTiles = kTile / 8;
  constexpr int kStride = Dp + kPad, kTStride = kTile + kPad;
  constexpr int kStageBytes = dq_stage_bytes<Dp>();
  static_assert(kTile * (Dp + 4) * 4 <= kStageBytes, "the fp32 epilogue fits in one stage");

  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int buf) { return smem + buf * kStageBytes; };
  bf16* s_q = reinterpret_cast<bf16*>(smem + 2 * kStageBytes);
  bf16* s_d = s_q + kTile * kStride;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);
  const long long bh = (long long)b * p.H + h;
  const bf16* kr = p.kr_tok + bh * p.Mp * Dp;
  const bf16* vt = p.v_tok + bh * p.Mp * Dp;
  const bf16* krdn = p.kr_dn + bh * Dp * p.Mp;
  const bool use_seg = p.seg_q != nullptr;
  const int* segq_p = use_seg ? p.seg_q + b * p.segq_b : nullptr;
  const int* segk_p = use_seg ? p.seg_k + b * p.segk_b : nullptr;

  copy_tok_async<Dp>(s_q, p.qs_tok + bh * p.Np * Dp, q0);
  copy_tok_async<Dp>(s_d, p.do_tok + bh * p.Np * Dp, q0);
  cp_async_commit();

  auto load_k = [&](int kt, int buf) {
    const int k0 = kt * kTile;
    bf16* s_k = reinterpret_cast<bf16*>(stage(buf));
    bf16* s_v = s_k + kTile * kStride;
    bf16* s_kt = s_v + kTile * kStride;
    int* s_segk = reinterpret_cast<int*>(s_kt + Dp * kTStride);
    copy_tok_async<Dp>(s_k, kr, k0);
    copy_tok_async<Dp>(s_v, vt, k0);
    copy_dn_async<Dp>(s_kt, krdn, k0, p.Mp);
    if (use_seg && tid < kTile) s_segk[tid] = k0 + tid < p.M ? segk_p[k0 + tid] : 0;
  };
  int n_ktiles = (p.kv_lim + kTile - 1) / kTile;  // tiles past kv_lim are all masked
  if (p.causal) n_ktiles = min(n_ktiles, (min(q0 + kTile, p.N) - 1) / kTile + 1);
  load_k(0, 0);
  cp_async_commit();
  float l2[2], dl[2];
  int segq[2] = {0, 0}, qry[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qry[r] = q0 + row0 + 8 * r;  // < Np: the scratch is padded
    l2[r] = p.lse2[bh * p.Np + qry[r]];
    dl[r] = p.delta[bh * p.Np + qry[r]];
    if (use_seg && qry[r] < p.N) segq[r] = segq_p[qry[r]];
  }

  float dq[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

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
    const int* s_segk = reinterpret_cast<const int*>(s_kt + Dp * kTStride);

    float s[kNTiles][4], dp[kNTiles][4];
    rows_times_tile<Dp>(s, s_q, s_k, row0);   // S = Q_s K_rot^T, base-2 units
    rows_times_tile<Dp>(dp, s_d, s_v, row0);  // dP = dO V^T

    uint32_t dsf[kNTiles / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t4 + (e & 1);
        bool ok = k0 + kl < p.kv_lim;
        if (use_seg) ok = ok && segq[e >> 1] >= s_segk[kl];
        if (p.causal) ok = ok && k0 + kl <= qry[e >> 1];
        const float pv = ok ? exp2_approx(s[nt][e] - l2[e >> 1]) : 0.f;
        dsv[e] = pv * (dp[nt][e] - dl[e >> 1]) * p.scale;
      }
      dsf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }
    packed_times_dn<Dp>(dq, dsf, s_kt);  // dQ += dS K_rot
    __syncthreads();
  }
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  write_rows<D, Dp>(p.dq + bh * p.N * D, dq, reinterpret_cast<float*>(stage(0)), cos_t, sin_t,
                    p, q0, p.N);
}

int padded_width(int D) {
  switch (D) {
    case 80: return 80;
    case 88: return 96;
    case 104: return 112;
    default: return 0;
  }
}

template <int D, int Dp>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int kDkdvSmem = dkdv_smem_bytes<Dp>();
  constexpr int kDqSmem = dq_smem_bytes<Dp>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bhnd_dkdv_kernel<D, Dp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_bhnd_dq_kernel<D, Dp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  const int longest = p.Np > p.Mp ? p.Np : p.Mp;
  bwd_prologue_kernel<D, Dp><<<dim3(longest / kTile, p.H, B), kPrologueThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_bhnd_dkdv_kernel<D, Dp><<<dim3(p.Mp / kTile, p.H, B), kThreads, kDkdvSmem,
                                       stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_bhnd_dq_kernel<D, Dp><<<dim3(p.Np / kTile, p.H, B), kThreads, kDqSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch `vjepa2_flash_bwd_bhnd_bf16` needs for these sizes (0 for
// an unsupported head width).
extern "C" long long vjepa2_flash_bwd_bhnd_scratch_bytes(int B, int H, int D, int N, int M) {
  const int Dp = padded_width(D);
  return Dp == 0 ? 0 : carve(nullptr, nullptr, B, H, Dp, N, M);
}

// strides: 25 element strides, in order
//   q (b, h, n, d), k (b, h, n, d), v (b, h, n, d), out (b, h, n, d),
//   do (b, h, n, d), RoPE tables (b, n, d), query segment ids (b), key
//   segment ids (b).
// cos/sin null: no RoPE (else N == M). seg_q null: no segment mask (else
// seg_k is given too). lse is [B, H, N] contiguous; dq [B, H, N, D], dk and
// dv [B, H, M, D] are written contiguous. scratch:
// vjepa2_flash_bwd_bhnd_scratch_bytes(B, H, D, N, M) bytes, 256-byte aligned.
// qscale: scale*log2(e) exactly as B3 received it, so q rounds the same.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int vjepa2_flash_bwd_bhnd_bf16(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          const void* cos_t, const void* sin_t,
                                          const void* seg_q, const void* seg_k, void* dq,
                                          void* dk, void* dv, void* scratch, int B, int H, int D,
                                          int N, int M, int kv_lim, int causal,
                                          const long long* strides, float scale, float qscale,
                                          void* stream) {
  BwdParams p;
  p.sq = {strides[0], strides[1], strides[2], strides[3]};
  p.sk = {strides[4], strides[5], strides[6], strides[7]};
  p.sv = {strides[8], strides[9], strides[10], strides[11]};
  p.so = {strides[12], strides[13], strides[14], strides[15]};
  p.sdo = {strides[16], strides[17], strides[18], strides[19]};
  p.t_b = strides[20];
  p.t_n = strides[21];
  p.t_d = strides[22];
  p.segq_b = strides[23];
  p.segk_b = strides[24];
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.causal = causal;
  set_common(p, q, k, v, out, dout, lse, cos_t, sin_t, dq, dk, dv, H, N, M, kv_lim, scale,
             qscale);
  const int Dp = padded_width(D);
  if (Dp == 0 || N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M ||
      (seg_q != nullptr && seg_k == nullptr) || (cos_t != nullptr && N != M) ||
      reinterpret_cast<uintptr_t>(scratch) % 256)
    return cudaErrorInvalidValue;
  carve(&p, static_cast<char*>(scratch), B, H, Dp, N, M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80: return launch<80, 80>(p, B, s);
    case 88: return launch<88, 96>(p, B, s);
    case 104: return launch<104, 112>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
