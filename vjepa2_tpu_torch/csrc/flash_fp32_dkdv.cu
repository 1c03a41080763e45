// The fp32 BHND flash backward's second launch, dK and dV, on the tensor
// cores (3xTF32; the design and the contract: `flash_fp32.cuh`), after the
// dQ launch (`flash_fp32_dq.cu`) on the same stream.
//
// One block a 64-key tile of one (b, h): two warpgroups on the same 64 keys;
// 32-query tiles of Q and dO (token-major hi/lo), Q^T and dO^T
// (feature-major hi/lo) and the queries' lse * log2(e) and delta stream
// through the ring (`refill`). Warpgroup 0 holds K's fragments,
// makes S^T = K Q^T and P^T, hands P^T to warpgroup 1 through shared memory
// (double-buffered, one named barrier a tile) and adds P^T dO to dV; warpgroup 1 holds V's fragments, makes dP^T = V dO^T,
// dS^T = P^T (dP^T - delta) scale, and adds dS^T Q to dK. Each tile's
// product goes to dV's or dK's running sum in two column blocks (halves of
// D), so that a block's fresh accumulator costs a quarter of D in registers.
// With RoPE, K, Q and Q^T are the pre-pass's rotated copies: dK leaves
// through the adjoint R^T (`rope_adjoint`, `flash_attention.py:505-506`)
// from a tile in the ring's shared memory, once both warpgroups leave it.
// On the DN layout (kDn: B2 on fp32 operands) dV and dK leave D-major
// (`store_cols`, `rope_adjoint`).
// With kv_valid, M is the valid keys' count and Mo the keys' full count (the
// rows of dk and dv): the grid covers Mo, rows at or past M are written as
// zeros, and a block wholly past M writes its zeros and leaves. Segment ids
// and the causal mask are the kMasked variant (the forward's): the ring
// takes the plan's query tiles (keys-major: for each block of keys, the
// tiles of queries that attend one of them), and on a partial one
// warpgroup 0 (its rows' key ids in registers) loads the tile's query ids
// and sets a bit a pair it attends while S^T's products run; P^T is 0 at
// the others. A block with no tile writes zeros and leaves.

#include "flash_fp32.cuh"

namespace {

constexpr int kBlockK = 64;  // keys a block
constexpr int kB = 32;       // queries a tile

template <int D>
struct DkdvCfg {
  static constexpr int kQ = nat_bytes(D, kB);  // one part of a q or do tile
  static constexpr int kQt = tr_bytes(D, kB);  // one part of a q^T or do^T tile
  static constexpr int kStats = 1024;          // lse2 and delta, [2][kB] fp32, padded
  static constexpr int kStage = 4 * kQ + 4 * kQt + kStats;
  static constexpr int kX = 2 * kXBytes;       // P^T, two buffers
  static constexpr int kStages = cmin(3, (kSmemMax - kX - kSlack) / kStage);
  static constexpr bool kProducer = D <= 64;  // the consumers fit in 168 registers
  static constexpr int kThreads = block_threads(kProducer);
  static constexpr int kSmem = kX + kStages * kStage + kSlack;
  static_assert(kStages >= 1 && kSmem <= kSmemMax, "the tiles fit");
};

struct DkdvParams {
  CUtensorMap tm_q, tm_do, tm_qt, tm_dot;  // the pre-pass's split copies
  const float* k_nat;                      // [2][B][H][M][D]
  const float* v_nat;
  const float* delta;                      // [B, H, Np]
  const float* lse2;
  const float* cos;                        // RoPE tables [B|1, N, D] at (t_b, t_n), unit along d,
  const float* sin;                        // or (dn) [B|1, D, N] at (t_b, t_d); or null
  const int* seg_q;                        // segment ids [B, N] at batch stride segq_b, or null
  const int* seg_k;                        // [B, M] at segk_b
  const int* plan;                         // kMasked: [B|1][key blocks][plan_w] (count, tiles)
  float* dk;                               // [B, H, Mo, D], or (dn) [B, H, D, Mo]
  float* dv;
  long long t_b, t_n, t_d, segq_b, segk_b, plan_b, plan_w;
  int B, H, N, M, Mo, Np, causal, dn;
  float scale, qscale;
};

// Warpgroup kWg's loop: its first product (S^T or dP^T), the trade, and its
// output (dV or dK), both column blocks; kDn: stored D-major (the DN layout).
template <int D, int kWg, bool kMasked, bool kDn, class Load>
__device__ __forceinline__ void dkdv_consumer(const DkdvParams& p, unsigned char* stages,
                                              float* xbuf, uint64_t* full, uint64_t* empty,
                                              const uint32_t (&ah)[D / 8][4],
                                              const uint32_t (&al)[D / 8][4], int b, int h, int k0,
                                              const int* tiles, int n, const Load& load) {
  using C = DkdvCfg<D>;
  constexpr int kW0 = half_width(D), kW1 = D - kW0;
  const int t = threadIdx.x % kWgThreads, warp = t >> 5, lane = t & 31, t4 = lane & 3;
  const long long bh = (long long)b * p.H + h;
  const int krow = k0 + warp * 16 + (lane >> 2);  // this thread's keys (P^T's rows): krow, + 8
  int segk[2] = {0, 0};                           // kMasked, warpgroup 0: their ids
  if constexpr (kMasked && kWg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (p.seg_k != nullptr && krow + 8 * r < p.M) segk[r] = p.seg_k[b * p.segk_b + krow + 8 * r];
    }
  }
  float run[D / 2];  // dV (warpgroup 0) or dK (1), 64 keys x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) run[i] = 0.f;
  for (int j = 0; j < n; ++j) {  // the ring's j-th query tile: j, or kMasked the plan's j-th
    const int s = j % C::kStages, q0 = (kMasked ? tiles[j] & (kPartialTile - 1) : j) * kB;
    unsigned char* st = stages + s * C::kStage;
    const float* s_l2 = reinterpret_cast<const float*>(st + 4 * C::kQ + 4 * C::kQt);
    const float* s_dl = s_l2 + kB;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    float x[16];
    const unsigned char* bt = st + kWg * 2 * C::kQ;
    wgmma_fence();
    mma3_rs<kB, D / 8, kB>(x, ah, al, opaque(desc_k<kB>(bt, 0)), opaque(desc_k<kB>(bt + C::kQ, 0)), 0);
    wgmma_commit();
    // kMasked: this thread's pair bits (`pair_bits`), rows keys and columns
    // queries, while S^T's products run
    uint32_t bits = ~0u;  // every bit on a tile the plan marks full
    if constexpr (kMasked && kWg == 0) {
      if (tiles[j] & kPartialTile) {
        bits = pair_bits<4, false>(segk, krow,
                                   p.seg_q != nullptr ? p.seg_q + b * p.segq_b : nullptr, q0,
                                   p.N, p.causal);
      }
    }
    wgmma_wait<0>();
    fence_regs(x);
    float* buf = xbuf + (j & 1) * (kXBytes / 4);
    if constexpr (kWg == 0) {  // P^T; queries past N have lse2 = +inf, so p = 0
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = x[4 * nt + e] * p.qscale - s_l2[nt * 8 + 2 * t4 + (e & 1)];
          if constexpr (kMasked) {  // 0 where the pair is masked
            x[4 * nt + e] = exp2f((bits >> (4 * nt + e)) & 1u ? y : -INFINITY);
          } else {
            x[4 * nt + e] = exp2f(y);
          }
        }
      }
      put16(buf, x);
      bar_sync(1, 2 * kWgThreads);
    } else {  // dS^T
      float pt[16];
      bar_sync(1, 2 * kWgThreads);
      get16(buf, pt);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t4 + (e & 1);
          x[4 * nt + e] = pt[4 * nt + e] * (x[4 * nt + e] - s_dl[c]) * p.scale;
        }
      }
    }
    uint32_t fh[4][4], fl[4][4];  // P^T or dS^T as A fragments
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) split_tile(fh[nt], fl[nt], x + 4 * nt);
    // dV += P^T dO (B: dO^T) or dK += dS^T Q (B: Q^T), a column block at a time
    const unsigned char* tt = st + 4 * C::kQ + (kWg == 0 ? 2 : 0) * C::kQt;
    const uint64_t t_hi = opaque(desc_k<D>(tt, 0)), t_lo = opaque(desc_k<D>(tt + C::kQt, 0));
    {
      float part[kW0 / 2];
      wgmma_fence();
      mma3_rs<kW0, 4, D>(part, fh, fl, t_hi, t_lo, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < kW0 / 2; ++k) run[k] += part[k];
    }
    {
      float part[kW1 / 2];
      const uint64_t rows = (uint64_t)(kW0 * kRowBytes) >> 4;  // descriptor units
      wgmma_fence();
      mma3_rs<kW1, 4, D>(part, fh, fl, t_hi + rows, t_lo + rows, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < kW1 / 2; ++k) run[kW0 / 2 + k] += part[k];
    }
    if (lane == 0) mbar_arrive(&empty[s]);
    if constexpr (!C::kProducer) refill<C::kStages>(empty, j, n, load);
  }
  float* out = (kWg == 0 ? p.dv : p.dk) + bh * p.Mo * D;
  auto store = [&]() {  // this warpgroup's dV or dK, zeros past kv_valid
    if constexpr (kDn) {
      store_cols<D>(out, run, k0, 0, p.M, p.Mo, p.Mo);
    } else {
      store_rows<D, D>(out, run, k0, 0, p.M, p.Mo);
    }
  };
  if (p.cos == nullptr) {
    store();
    return;
  }
  // dK before the adjoint: [64][kLd] (kDn: an odd row stride, `rope_adjoint`)
  constexpr int kLd = kDn ? D + 1 : D;
  float* tile = reinterpret_cast<float*>(stages);
  bar_sync(kEpilogueBar, 2 * kWgThreads);  // both warpgroups are out of the ring
  if constexpr (kWg == 0) {
    store();
  } else {
    store_rows<kLd, D>(tile, run, 0, 0, kBlockK, kBlockK);
  }
  bar_sync(kEpilogueBar, 2 * kWgThreads);
  rope_adjoint<D, kLd, kDn>(p.dk + bh * p.Mo * D, kDn ? p.Mo : D, tile, p.cos + b * p.t_b,
                            p.sin + b * p.t_b, p.t_n, p.t_d, k0, p.M, p.Mo, threadIdx.x,
                            2 * kWgThreads);
}

template <int D, bool kMasked, bool kDn>
__global__ void __launch_bounds__(DkdvCfg<D>::kThreads, 1)
    flash_fp32_dkdv_kernel(const __grid_constant__ DkdvParams p) {
  using C = DkdvCfg<D>;
  constexpr int kChunks = (D + 31) / 32;
  extern __shared__ unsigned char smem_raw[];
  // [kStages][q hi, q lo, do hi, do lo, q^T hi, q^T lo, do^T hi, do^T lo, lse2, delta]
  unsigned char* stages = align1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(stages + C::kStages * C::kStage);  // [2] P^T
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + C::kStages * C::kStage + C::kX);
  uint64_t* empty = full + C::kStages;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBlockK;
  const long long bh = (long long)b * p.H + h;
  // query tiles: every one below N, or kMasked the plan's for this key block
  const int* tiles = kMasked && k0 < p.M ? p.plan + b * p.plan_b + blockIdx.x * p.plan_w + 1
                                         : nullptr;
  const int n_qt = kMasked ? (tiles != nullptr ? tiles[-1] : 0) : (p.N + kB - 1) / kB;
  if (k0 >= p.M || n_qt == 0) {  // no key below kv_valid, or no query attends one: no gradient
    const int rows = cmin(kBlockK, p.Mo - k0);
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const long long at = kDn ? bh * p.Mo * D + (long long)(i / rows) * p.Mo + k0 + i % rows
                               : (bh * p.Mo + k0) * D + i;
      p.dk[at] = p.dv[at] = 0.f;
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

  auto load = [&](int j) {  // query tile j (kMasked: the plan's j-th) into its stage, by one thread
    const int s = j % C::kStages, q0 = (kMasked ? tiles[j] & (kPartialTile - 1) : j) * kB;
    unsigned char* st = stages + s * C::kStage;
    mbar_expect_tx(&full[s], 4 * C::kQ + 4 * C::kQt + 2 * kB * 4);
    for (int part = 0; part < 2; ++part) {
      const int bb = part * p.B + b;
      for (int c = 0; c < kChunks; ++c) {
        tma_load(st + part * C::kQ + c * kB * kRowBytes, &p.tm_q, 32 * c, q0, h, bb, &full[s]);
        tma_load(st + (2 + part) * C::kQ + c * kB * kRowBytes, &p.tm_do, 32 * c, q0, h, bb,
                 &full[s]);
      }
      tma_load(st + 4 * C::kQ + part * C::kQt, &p.tm_qt, q0, 0, h, bb, &full[s]);
      tma_load(st + 4 * C::kQ + (2 + part) * C::kQt, &p.tm_dot, q0, 0, h, bb, &full[s]);
    }
    unsigned char* stats = st + 4 * C::kQ + 4 * C::kQt;
    bulk_load(stats, p.lse2 + bh * p.Np + q0, kB * 4, &full[s]);
    bulk_load(stats + kB * 4, p.delta + bh * p.Np + q0, kB * 4, &full[s]);
  };
  const int wg = threadIdx.x / kWgThreads;
  if constexpr (C::kProducer) {
    if (wg == 2) {
      if (threadIdx.x == 2 * kWgThreads) produce<C::kStages>(empty, n_qt, load);
      return;
    }
  } else if (threadIdx.x == kLoader) {
    for (int j = 0; j < C::kStages && j < n_qt; ++j) load(j);
  }

  // warpgroup 0: K's fragments, P^T and dV; 1: V's, dP^T, dS^T and dK
  uint32_t ah[D / 8][4], al[D / 8][4];
  const long long part = (long long)p.B * p.H * p.M * D;
  load_fragments<D, 0, D / 8>(ah, al, (wg == 0 ? p.k_nat : p.v_nat) + bh * p.M * D, part, k0, p.M);
  if (wg == 0) {
    dkdv_consumer<D, 0, kMasked, kDn>(p, stages, xbuf, full, empty, ah, al, b, h, k0, tiles,
                                      n_qt, load);
  } else {
    dkdv_consumer<D, 1, kMasked, kDn>(p, stages, xbuf, full, empty, ah, al, b, h, k0, tiles,
                                      n_qt, load);
  }
}

template <int D, bool kMasked, bool kDn>
int launch_dkdv(const DkdvParams& p, cudaStream_t s) {
  using C = DkdvCfg<D>;
  cudaError_t err = allow_smem<flash_fp32_dkdv_kernel<D, kMasked, kDn>>(C::kSmem);
  if (err != cudaSuccess) return err;
  flash_fp32_dkdv_kernel<D, kMasked, kDn>
      <<<dim3((p.Mo + kBlockK - 1) / kBlockK, p.H, p.B), C::kThreads, C::kSmem, s>>>(p);
  return cudaGetLastError();
}

// The DN layout is its own instantiation, at the DN route's widths only: with
// a runtime layout test in the epilogue, ptxas allocated the BHND kernels at
// Dh 64 (168 registers with the producer warpgroup) otherwise than before
// (12 more bytes of spill unmasked, 68 more bytes of spill loads masked).
struct RunDkdv {
  template <int D>
  static int run(const DkdvParams& p, cudaStream_t s) {
    if (!p.dn) return p.plan != nullptr ? launch_dkdv<D, true, false>(p, s)
                                        : launch_dkdv<D, false, false>(p, s);
    if constexpr (D <= 64) {
      return p.plan != nullptr ? launch_dkdv<D, true, true>(p, s) : launch_dkdv<D, false, true>(p, s);
    }
    return cudaErrorInvalidValue;
  }
};

}  // namespace

// dk and dv [B, H, Mo, D] contiguous fp32 (dn: [B, H, D, Mo], the DN layout),
// after `vjepa2_flash_bwd_fp32_dq` on the same stream, from the pre-pass's
// copies (`vjepa2_flash_fp32_prepass_bwd`: q_nat, k_nat, v_nat, do_nat
// [2][B][H][N|M][D]; q_tr, do_tr [2][B][H][D][padded8(N)]; q and k rotated
// where cos and sin are given, split-half [B|1, N, D] at batch stride t_b, 0
// when shared, and row stride t_n, t_d 1; dn: [B|1, D, N] at feature stride
// t_d, t_n 1) and statistics (delta, lse2 [B, H, Np], Np: N rounded up to 64). M:
// the keys the pre-pass split (kv_valid), Mo >= M the keys' count; rows M to
// Mo of dk and dv are zeros. seg_q [B, N] and seg_k [B, M] int32 at batch
// strides segq_b, segk_b (both or neither), and causal, mask as the forward
// does; with either, plan (`mask_tile_plan` keys-major: blocks of 64 keys
// below M, tiles of 32 queries) at batch stride plan_b and row width plan_w.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vjepa2_flash_bwd_fp32_dkdv(const void* q_nat, const void* k_nat,
                                          const void* v_nat, const void* do_nat, const void* q_tr,
                                          const void* do_tr, const void* delta, const void* lse2,
                                          const void* cos, const void* sin, const void* seg_q,
                                          const void* seg_k, const void* plan, void* dk, void* dv,
                                          int B, int H, int D, int N, int M, int Mo, int Np,
                                          int causal, int dn, long long t_b, long long t_n,
                                          long long t_d, long long segq_b, long long segk_b,
                                          long long plan_b, long long plan_w, float scale,
                                          float qscale, void* stream) {
  const bool masked = seg_q != nullptr || causal != 0;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || Mo < M || B > 32767 || H > 65535 || Np < N ||
      Np % 64 != 0 || k_nat == nullptr || v_nat == nullptr || !aligned16(delta) ||
      !aligned16(lse2) || !aligned16(dk) || !aligned16(dv) || (cos == nullptr) != (sin == nullptr) ||
      (cos != nullptr && (Mo != N || t_b < 0 ||
                          (dn ? (t_n != 1 || t_d < N) : (t_d != 1 || t_n < D)))) ||
      (seg_q == nullptr) != (seg_k == nullptr) || segq_b < 0 || segk_b < 0 ||
      masked != (plan != nullptr) || plan_b < 0 || (masked && plan_w < 1 + (N + kB - 1) / kB))
    return cudaErrorInvalidValue;
  DkdvParams p;
  if (!encode_split(&p.tm_q, q_nat, D, N, H, B, kB) || !encode_split(&p.tm_do, do_nat, D, N, H, B, kB) ||
      !encode_split(&p.tm_qt, q_tr, padded8(N), D, H, B, D) ||
      !encode_split(&p.tm_dot, do_tr, padded8(N), D, H, B, D))
    return cudaErrorInvalidValue;
  p.k_nat = static_cast<const float*>(k_nat);
  p.v_nat = static_cast<const float*>(v_nat);
  p.delta = static_cast<const float*>(delta);
  p.lse2 = static_cast<const float*>(lse2);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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
  p.Mo = Mo;
  p.Np = Np;
  p.scale = scale;
  p.qscale = qscale;
  return dispatch_width<RunDkdv>(D, p, static_cast<cudaStream_t>(stream));
}
