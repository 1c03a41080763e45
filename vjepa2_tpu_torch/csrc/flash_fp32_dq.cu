// The fp32 BHND flash backward's first launch, dQ, on the tensor cores
// (3xTF32; the design and the contract: `flash_fp32.cuh`). B4/B5 on fp32
// operands is two launches after the pre-pass (`flash_fp32_split.cu`): this
// one, then dK/dV (`flash_fp32_dkdv.cu`).
//
// One block a 64-query tile of one (b, h): two warpgroups on the same 64
// queries; 32-key tiles of K and V (token-major hi/lo) and K^T
// (feature-major hi/lo) stream through the ring (`refill`).
// Warpgroup 0 holds Q's fragments and makes S = Q K^T and P = exp2(S * scale
// * log2(e) - lse * log2(e)); warpgroup 1 holds dO's and makes dP = dO V^T.
// They trade P and dP through shared memory (one named barrier a tile, the
// buffer double-buffered), both form dS = P (dP - delta) scale as A
// fragments, and each adds dS K for its half of dQ's features to its running
// sum: the two products a tile run side by side on the tensor cores. With
// RoPE, Q, K and K^T are the pre-pass's rotated copies, so the sum is the
// gradient of the rotated q; the epilogue stages both halves in the ring's
// shared memory (free once both warpgroups leave it) and writes dQ through
// the adjoint R^T (`rope_adjoint`; `_rope_rotate_t :120`, applied at
// `flash_attention.py:429-430`), reading the tables' rows of the block's
// queries once. With kv_valid, M is the valid keys' count. Segment ids and
// the causal mask are the kMasked variant (the forward's): the ring takes
// the plan's key tiles, and on a partial one warpgroup 0 (its rows' query
// ids in registers) sets a bit a pair it attends while S's products run; P
// is 0 at the others. A block with no tile writes zeros.

#include "flash_fp32.cuh"

namespace {

constexpr int kBlockQ = 64;  // queries a block
constexpr int kB = 32;       // keys a tile

template <int D>
struct DqCfg {
  static constexpr int kK = nat_bytes(D, kB);  // one part of a k or v tile
  static constexpr int kKt = tr_bytes(D, kB);  // one part of a k^T tile
  static constexpr int kStage = 4 * kK + 2 * kKt;
  static constexpr int kX = 2 * 2 * kXBytes;   // P and dP, two buffers
  static constexpr int kStages = cmin(3, (kSmemMax - kX - kSlack) / kStage);
  static constexpr bool kProducer = D <= 64;  // the consumers fit in 168 registers
  static constexpr int kThreads = block_threads(kProducer);
  static constexpr int kSmem = kX + kStages * kStage + kSlack;
  static_assert(kStages >= 1 && kSmem <= kSmemMax, "the tiles fit");
};

struct DqParams {
  CUtensorMap tm_k, tm_v, tm_kt;  // the pre-pass's split copies
  const float* q_nat;             // [2][B][H][N][D]
  const float* do_nat;
  const float* delta;             // [B, H, Np]
  const float* lse2;              // [B, H, Np], lse * log2(e)
  const float* cos;               // RoPE tables [B|1, N, D] at (t_b, t_n), unit along d, or
  const float* sin;               // (dn) [B|1, D, N] at (t_b, t_d), unit along n; or null
  const int* seg_q;               // segment ids [B, N] at batch stride segq_b, or null
  const int* seg_k;               // [B, M] at segk_b
  const int* plan;                // kMasked: [B|1][query blocks][plan_w] (count, tiles)
  float* dq;                      // [B, H, N, D], or (dn) [B, H, D, N]
  long long t_b, t_n, t_d, segq_b, segk_b, plan_b, plan_w;
  int B, H, N, M, Np, causal, dn;
  float scale, qscale;
};

// kMasked: the plan's entries for the block at blockIdx.x (its count just
// before them); null otherwise.
template <bool kMasked>
__device__ __forceinline__ const int* dq_tiles(const DqParams& p, int b) {
  return kMasked ? p.plan + b * p.plan_b + blockIdx.x * p.plan_w + 1 : nullptr;
}

// Warpgroup kWg's loop: its first product (S or dP) with the A fragments
// ah/al, the trade, dS, and its kW columns of dQ from column col0.
template <int D, int kWg, bool kMasked, class Load>
__device__ __forceinline__ void dq_consumer(const DqParams& p, unsigned char* stages,
                                            float* xbuf, uint64_t* full, uint64_t* empty,
                                            const uint32_t (&ah)[D / 8][4],
                                            const uint32_t (&al)[D / 8][4], int b, int h, int q0,
                                            const Load& load) {
  using C = DqCfg<D>;
  constexpr int wg = kWg, col0 = kWg == 0 ? 0 : half_width(D);
  constexpr int kW = kWg == 0 ? half_width(D) : D - half_width(D);
  const int t = threadIdx.x % kWgThreads, warp = t >> 5, lane = t & 31, t4 = lane & 3;
  const long long bh = (long long)b * p.H + h;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  float l2[2], dl[2];
  int segq[2] = {0, 0};  // kMasked, warpgroup 0: their segment ids
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;  // < Np: the statistics are padded
    l2[r] = p.lse2[bh * p.Np + row];
    dl[r] = p.delta[bh * p.Np + row];
    if (kMasked && wg == 0 && p.seg_q != nullptr && row < p.N) {
      segq[r] = p.seg_q[b * p.segq_b + row];
    }
  }
  float run[kW / 2], part[kW / 2];
#pragma unroll
  for (int i = 0; i < kW / 2; ++i) run[i] = 0.f;
  const int* tiles = dq_tiles<kMasked>(p, b);
  const int n_kt = kMasked ? tiles[-1] : (p.M + kB - 1) / kB;
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % C::kStages, k0 = (kMasked ? tiles[j] & (kPartialTile - 1) : j) * kB;
    unsigned char* st = stages + s * C::kStage;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1)
    float x[16], y[16];
    const unsigned char* bt = st + wg * 2 * C::kK;
    wgmma_fence();
    mma3_rs<kB, D / 8, kB>(x, ah, al, opaque(desc_k<kB>(bt, 0)), opaque(desc_k<kB>(bt + C::kK, 0)), 0);
    wgmma_commit();
    // kMasked: this thread's pair bits (`pair_bits`), while S's products run
    uint32_t bits = ~0u;  // every bit on a tile the plan marks full
    if constexpr (kMasked && wg == 0) {
      if (tiles[j] & kPartialTile) {
        bits = pair_bits<4, true>(segq, row0,
                                  p.seg_k != nullptr ? p.seg_k + b * p.segk_b : nullptr, k0,
                                  p.M, p.causal);
      }
    }
    wgmma_wait<0>();
    fence_regs(x);
    if constexpr (wg == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kMasked) {  // P, 0 where the pair is masked
            const bool ok = (bits >> (4 * nt + e)) & 1u;
            x[4 * nt + e] = exp2f(ok ? x[4 * nt + e] * p.qscale - l2[e >> 1] : -INFINITY);
          } else {
            const bool ok = k0 + nt * 8 + 2 * t4 + (e & 1) < p.M;
            x[4 * nt + e] = ok ? exp2f(x[4 * nt + e] * p.qscale - l2[e >> 1]) : 0.f;  // P
          }
        }
      }
    }
    float* mine = xbuf + ((j & 1) * 2 + wg) * (kXBytes / 4);
    put16(mine, x);
    bar_sync(1, 2 * kWgThreads);
    get16(xbuf + ((j & 1) * 2 + (wg ^ 1)) * (kXBytes / 4), y);
    const float(&pr)[16] = wg == 0 ? x : y;
    const float(&dp)[16] = wg == 0 ? y : x;
    uint32_t dh[4][4], dlo[4][4];  // dS's A fragments
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = pr[4 * nt + e] * (dp[4 * nt + e] - dl[e >> 1]) * p.scale;
      split_tile(dh[nt], dlo[nt], ds);
    }
    // this warpgroup's columns of dS K, afresh, then into the running sum
    const unsigned char* kt = st + 4 * C::kK;
    wgmma_fence();
    mma3_rs<kW, 4, D>(part, dh, dlo, opaque(desc_k<D>(kt, col0)), opaque(desc_k<D>(kt + C::kKt, col0)), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < kW / 2; ++i) run[i] += part[i];
    if (lane == 0) mbar_arrive(&empty[s]);
    if constexpr (!C::kProducer) refill<C::kStages>(empty, j, n_kt, load);
  }
  float* dq = p.dq + bh * p.N * D;
  if (p.cos == nullptr) {
    if (p.dn) {
      store_cols<kW>(dq, run, q0, col0, p.N, p.N, p.N);
    } else {
      store_rows<D, kW>(dq, run, q0, col0, p.N, p.N);
    }
    return;
  }
  float* tile = reinterpret_cast<float*>(stages);  // [64][D], or (dn) [64][D + 1]
  bar_sync(kEpilogueBar, 2 * kWgThreads);        // both warpgroups are out of the ring
  const float *cos_t = p.cos + b * p.t_b, *sin_t = p.sin + b * p.t_b;
  if (p.dn) {
    store_rows<D + 1, kW>(tile, run, 0, col0, kBlockQ, kBlockQ);
    bar_sync(kEpilogueBar, 2 * kWgThreads);
    rope_adjoint<D, D + 1, true>(dq, p.N, tile, cos_t, sin_t, p.t_n, p.t_d, q0, p.N, p.N,
                                 threadIdx.x, 2 * kWgThreads);
  } else {
    store_rows<D, kW>(tile, run, 0, col0, kBlockQ, kBlockQ);
    bar_sync(kEpilogueBar, 2 * kWgThreads);
    rope_adjoint<D, D, false>(dq, D, tile, cos_t, sin_t, p.t_n, p.t_d, q0, p.N, p.N,
                              threadIdx.x, 2 * kWgThreads);
  }
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
    flash_fp32_dq_kernel(const __grid_constant__ DqParams p) {
  using C = DqCfg<D>;
  constexpr int kChunks = (D + 31) / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);  // [kStages][k hi, k lo, v hi, v lo, k^T hi, k^T lo]
  float* xbuf = reinterpret_cast<float*>(stages + C::kStages * C::kStage);  // [2][P, dP]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + C::kStages * C::kStage + C::kX);
  uint64_t* empty = full + C::kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int* tiles = dq_tiles<kMasked>(p, b);
  const int n_kt = kMasked ? tiles[-1] : (p.M + kB - 1) / kB;
  if (kMasked && n_kt == 0) {  // no key for any query of the block: dq 0
    float* dq = p.dq + ((long long)b * p.H + h) * p.N * D;
    for (int i = threadIdx.x; i < kBlockQ * D; i += blockDim.x) {
      const int row = q0 + (p.dn ? i % kBlockQ : i / D), d = p.dn ? i / kBlockQ : i % D;
      if (row < p.N) dq[p.dn ? (long long)d * p.N + row : (long long)row * D + d] = 0.f;
    }
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  auto load = [&](int j) {  // key tile j (kMasked: the plan's j-th) into its stage, by one thread
    const int s = j % C::kStages, k0 = (kMasked ? tiles[j] & (kPartialTile - 1) : j) * kB;
    unsigned char* st = stages + s * C::kStage;
    mbar_expect_tx(&full[s], C::kStage);
    for (int part = 0; part < 2; ++part) {
      const int bb = part * p.B + b;
      for (int c = 0; c < kChunks; ++c) {
        tma_load(st + part * C::kK + c * kB * kRowBytes, &p.tm_k, 32 * c, k0, h, bb, &full[s]);
        tma_load(st + (2 + part) * C::kK + c * kB * kRowBytes, &p.tm_v, 32 * c, k0, h, bb,
                 &full[s]);
      }
      tma_load(st + 4 * C::kK + part * C::kKt, &p.tm_kt, k0, 0, h, bb, &full[s]);
    }
  };
  const int wg = threadIdx.x / kWgThreads;
  if constexpr (C::kProducer) {
    if (wg == 2) {
      if (threadIdx.x == 2 * kWgThreads) produce<C::kStages>(empty, n_kt, load);
      return;
    }
  } else if (threadIdx.x == kLoader) {
    for (int j = 0; j < C::kStages && j < n_kt; ++j) load(j);
  }

  // warpgroup 0: Q's fragments, S and P, dQ's first columns; 1: dO's, dP, the rest
  uint32_t ah[D / 8][4], al[D / 8][4];
  const long long bh = (long long)b * p.H + h, part = (long long)p.B * p.H * p.N * D;
  load_fragments<D, 0, D / 8>(ah, al, (wg == 0 ? p.q_nat : p.do_nat) + bh * p.N * D, part, q0, p.N);
  if (wg == 0) {
    dq_consumer<D, 0, kMasked>(p, stages, xbuf, full, empty, ah, al, b, h, q0, load);
  } else {
    dq_consumer<D, 1, kMasked>(p, stages, xbuf, full, empty, ah, al, b, h, q0, load);
  }
}

template <int D, bool kMasked>
int launch_dq(const DqParams& p, cudaStream_t s) {
  using C = DqCfg<D>;
  cudaError_t err = allow_smem<flash_fp32_dq_kernel<D, kMasked>>(C::kSmem);
  if (err != cudaSuccess) return err;
  flash_fp32_dq_kernel<D, kMasked>
      <<<dim3((p.N + kBlockQ - 1) / kBlockQ, p.H, p.B), C::kThreads, C::kSmem, s>>>(p);
  return cudaGetLastError();
}

struct RunDq {
  template <int D>
  static int run(const DqParams& p, cudaStream_t s) {
    return p.plan != nullptr ? launch_dq<D, true>(p, s) : launch_dq<D, false>(p, s);
  }
};

}  // namespace

// dq [B, H, N, D] contiguous fp32 (dn: [B, H, D, N], the DN layout), after
// `vjepa2_flash_fp32_prepass_bwd` on the same stream: q_nat, k_nat, v_nat,
// do_nat ([2][B][H][N|M][D]) and k_tr ([2][B][H][D][padded8(M)]) are its
// split copies (q and k rotated where cos and sin are given: split-half
// [B|1, N, D] at batch stride t_b, 0 when shared, and row stride t_n, t_d 1;
// dn: [B|1, D, N] at feature stride t_d, t_n 1), delta and lse2 [B, H, Np]
// its statistics (Np: N rounded up to 64). M: the keys the pre-pass split. seg_q [B, N] and
// seg_k [B, M] int32 at batch strides segq_b, segk_b (both or neither), and
// causal, mask as the forward does; with either, plan (`mask_tile_plan`,
// blocks of 64 queries, tiles of 32 keys) at batch stride plan_b and row
// width plan_w. Returns the cudaError_t of the launch (0 on success).
extern "C" int vjepa2_flash_bwd_fp32_dq(const void* q_nat, const void* k_nat, const void* v_nat,
                                        const void* do_nat, const void* k_tr, const void* delta,
                                        const void* lse2, const void* cos, const void* sin,
                                        const void* seg_q, const void* seg_k, const void* plan,
                                        void* dq, int B, int H, int D, int N, int M, int Np,
                                        int causal, int dn, long long t_b, long long t_n,
                                        long long t_d, long long segq_b, long long segk_b,
                                        long long plan_b, long long plan_w, float scale,
                                        float qscale, void* stream) {
  const bool masked = seg_q != nullptr || causal != 0;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B > 32767 || H > 65535 || Np < N || Np % 64 != 0 ||
      q_nat == nullptr || do_nat == nullptr || delta == nullptr || lse2 == nullptr ||
      !aligned16(dq) || (cos == nullptr) != (sin == nullptr) ||
      (cos != nullptr && (M > N || t_b < 0 ||
                          (dn ? (t_n != 1 || t_d < N) : (t_d != 1 || t_n < D)))) ||
      (seg_q == nullptr) != (seg_k == nullptr) || segq_b < 0 || segk_b < 0 ||
      masked != (plan != nullptr) || plan_b < 0 || (masked && plan_w < 1 + (M + kB - 1) / kB))
    return cudaErrorInvalidValue;
  DqParams p;
  if (!encode_split(&p.tm_k, k_nat, D, M, H, B, kB) || !encode_split(&p.tm_v, v_nat, D, M, H, B, kB) ||
      !encode_split(&p.tm_kt, k_tr, padded8(M), D, H, B, D))
    return cudaErrorInvalidValue;
  p.q_nat = static_cast<const float*>(q_nat);
  p.do_nat = static_cast<const float*>(do_nat);
  p.delta = static_cast<const float*>(delta);
  p.lse2 = static_cast<const float*>(lse2);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.dq = static_cast<float*>(dq);
  p.t_b = t_b;
  p.t_n = t_n;
  p.t_d = t_d;
  p.dn = dn != 0;
  p.segq_b = segq_b;
  p.segk_b = segk_b;
  p.plan = static_cast<const int*>(plan);
  p.plan_b = plan_b;
  p.plan_w = plan_w;
  p.causal = causal != 0;
  p.B = B;
  p.H = H;
  p.N = N;
  p.M = M;
  p.Np = Np;
  p.scale = scale;
  p.qscale = qscale;
  return dispatch_width<RunDq>(D, p, static_cast<cudaStream_t>(stream));
}
