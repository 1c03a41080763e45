// The fp32 BHND flash forward on the tensor cores (3xTF32; the design and
// the contract: `flash_fp32.cuh`). B3 on fp32 operands,
// `vjepa2_tpu/ops/flash_attention.py:166 _fwd_kernel`.
//
// One block a 128-query tile of one (b, h): two warpgroups of 64 queries.
// Q's hi and lo tiles are loaded once (its first 96 features; at D 104 the
// last 8 are register fragments, so two ring stages still fit); kB-key tiles
// of K (token-major hi/lo) and V^T (feature-major hi/lo, the pre-pass's
// copies) stream through a ring of kStages stages (`refill`). A warpgroup
// issues S_u = Q K_u^T (both operands in shared memory, N = kB) and
// O_part = P_{u-1} V_{u-1} (P's fragments in registers, N = D) in its turn
// on the tensor cores, then, while the other's products run,
// adds O_part to its running O in fp32 (rescaled by the previous tile's
// correction) and runs the online softmax of S_u in base 2, which leaves P_u
// split as the next turn's A fragments. kB is 64 keys at D <= 64 and 32 above
// (the shared-memory budget of Q's and the ring's hi/lo tiles).
//
// The masks are a variant of their own (kMasked: segment ids or the causal
// mask; without them the kernel is the unmasked one, which masks only its
// ragged key edge at M). The wrapper's plan (`ops/flash_attention.py
// mask_tile_plan`) lists, for each block, the key tiles that hold an
// attended pair, each marked partial where one of its pairs is masked: the
// ring loads only those, and on a partial one a thread, while the tile's
// products run on the tensor cores, loads its key ids and sets one bit a
// pair it attends (`mask_bits`: its two query rows' ids, kept in registers,
// compared with each key's as integers; key <= query under causal; key <
// M); the softmax sets the others to -inf before the running max. A row
// left with no key writes 0 and lse -inf (`row_totals`; a block with no
// tile at all writes them alone).

#include "flash_fp32.cuh"

namespace {

constexpr int kBlockQ = 128;  // queries a block, 64 a warpgroup

template <int D>
struct FwdCfg {
  static constexpr int kB = D <= 64 ? 64 : 32;     // keys a tile
  static constexpr int kQChunks = cmin((D + 31) / 32, 3);  // Q's chunks in shared memory
  static constexpr int kQSteps = cmin(D, 96) / 8;          // Q's k-steps there
  static constexpr int kQRegSteps = D / 8 - kQSteps;       // the rest, in registers
  static constexpr int kQ = kQChunks * kBlockQ * kRowBytes;  // one part of the query tile
  static constexpr int kK = nat_bytes(D, kB);       // one part of a key tile
  static constexpr int kV = tr_bytes(D, kB);        // one part of a v^T tile
  static constexpr int kStage = 2 * (kK + kV);
  static constexpr int kStages = cmin(4, (kSmemMax - 2 * kQ - kSlack) / kStage);
  static constexpr int kSmem = 2 * kQ + kStages * kStage + kSlack;
  static_assert(kStages >= 1 && kSmem <= kSmemMax, "the tiles fit");
};

struct FwdParams {
  CUtensorMap tm_q, tm_k, tm_vt;  // the pre-pass's split copies (`encode_split`)
  const float* q_nat;             // q's copy itself ([2][B][H][N][D]), for kQRegSteps
  const int* seg_q;               // segment ids [B, N] at batch stride segq_b, or null
  const int* seg_k;               // [B, M] at segk_b
  const int* plan;                // kMasked: [B|1][query blocks][plan_w] (count, tiles)
  float* o;
  float* lse;                     // [B, H, N]
  long long o_n, o_h, o_b, o_d;   // out's element strides (unit along d, or along n: DN)
  long long segq_b, segk_b, plan_b, plan_w;
  int B, H, N, M, causal;
  float qscale;                   // scale * log2(e)
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(block_threads(false), 1)
    flash_fp32_fwd_kernel(const __grid_constant__ FwdParams p) {
  using C = FwdCfg<D>;
  constexpr int kB = C::kB, kStages = C::kStages, kKSteps = kB / 8;
  constexpr int kChunks = (D + 31) / 32, kQSteps = C::kQSteps, kQRegSteps = C::kQRegSteps;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_q = align1024(smem_raw);      // hi, lo
  unsigned char* stages = s_q + 2 * C::kQ;        // [kStages][k hi, k lo, v^T hi, v^T lo]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + kStages * C::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  // key tiles: every one below M, or kMasked the plan's (tile u is entry u)
  const int* tiles = kMasked ? p.plan + b * p.plan_b + blockIdx.x * p.plan_w + 1 : nullptr;
  const int n_u = kMasked ? tiles[-1] : (p.M + kB - 1) / kB;
  if (kMasked && n_u == 0) {  // no key for any query of the block: out 0, lse -inf
    const long long bh = (long long)b * p.H + h;
    float* out = p.o + b * p.o_b + h * p.o_h;
    for (int i = threadIdx.x; i < kBlockQ * D; i += blockDim.x) {
      const int row = q0 + i / D;
      if (row < p.N) out[row * p.o_n + (i % D) * p.o_d] = 0.f;
    }
    const int row = q0 + threadIdx.x;
    if (threadIdx.x < kBlockQ && row < p.N) p.lse[bh * p.N + row] = -INFINITY;
    return;
  }
  auto tile_of = [&](int u) { return kMasked ? tiles[u] & (kPartialTile - 1) : u; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  auto load = [&](int j) {  // key tile j into its stage, by one thread
    const int s = j % kStages;
    unsigned char* st = stages + s * C::kStage;
    const int k0 = tile_of(j) * kB;
    mbar_expect_tx(&full[s], C::kStage);
    for (int part = 0; part < 2; ++part) {
      for (int c = 0; c < kChunks; ++c) {
        tma_load(st + part * C::kK + c * kB * kRowBytes, &p.tm_k, 32 * c, k0, h,
                 part * p.B + b, &full[s]);
      }
      for (int c = 0; c < kB / 32; ++c) {
        tma_load(st + 2 * C::kK + part * C::kV + c * D * kRowBytes, &p.tm_vt, k0 + 32 * c, 0,
                 h, part * p.B + b, &full[s]);
      }
    }
  };
  if (threadIdx.x == kLoader) {  // Q once, then the first stages
    mbar_expect_tx(q_full, 2 * C::kQ);
    for (int part = 0; part < 2; ++part) {
      for (int c = 0; c < C::kQChunks; ++c) {
        tma_load(s_q + part * C::kQ + c * kBlockQ * kRowBytes, &p.tm_q, 32 * c, q0, h,
                 part * p.B + b, q_full);
      }
    }
    for (int j = 0; j < kStages && j < n_u; ++j) load(j);
  }

  const int wg = threadIdx.x / kWgThreads;
  const int t = threadIdx.x % kWgThreads, warp = t >> 5, lane = t & 31, t4 = lane & 3;
  const int rbase = wg * 64;
  const int row0 = rbase + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const long long bh = (long long)b * p.H + h;
  int segq[2] = {0, 0};  // kMasked: this thread's query rows' segment ids
  if constexpr (kMasked) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      if (p.seg_q != nullptr && row < p.N) segq[r] = p.seg_q[b * p.segq_b + row];
    }
  }
  // kMasked: this thread's pair bits (`pair_bits`) of the plan's tile u,
  // every bit on a tile it marks full; called while tile u's products run
  auto mask_bits = [&](int u) -> uint32_t {
    if (!(tiles[u] & kPartialTile)) return ~0u;
    return pair_bits<kKSteps, true>(segq, q0 + row0,
                                    p.seg_k != nullptr ? p.seg_k + b * p.segk_b : nullptr,
                                    tile_of(u) * kB, p.M, p.causal);
  };

  float s[kB / 2];                        // S, 64 rows x kB keys
  float op[D / 2];                        // this tile's P V
  float o[D / 2];                         // the running O, rescaled to the running max
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t ph[kKSteps][4], pl[kKSteps][4];  // P's A fragments, hi and lo
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the denominator
  float corr[2] = {0.f, 0.f};               // rescale of O before the pending P V

  // Q's k-steps past its shared-memory chunks (D 104: features 96-103)
  uint32_t qh[kQRegSteps > 0 ? kQRegSteps : 1][4], ql[kQRegSteps > 0 ? kQRegSteps : 1][4];
  if constexpr (kQRegSteps > 0) {
    load_fragments<D, kQSteps, kQRegSteps>(qh, ql, p.q_nat + bh * p.N * D,
                                           (long long)p.B * p.H * p.N * D, q0 + rbase, p.N);
  }
  mbar_wait(q_full, 0);
  const uint64_t dq_hi = desc_k<kBlockQ>(s_q, rbase);
  const uint64_t dq_lo = desc_k<kBlockQ>(s_q + C::kQ, rbase);
  auto issue_s = [&](int u) {  // S_u = Q K_u^T, Q_lo K_hi + Q_hi K_lo + Q_hi K_hi
    const unsigned char* st = stages + (u % kStages) * C::kStage;
    const uint64_t k_hi = opaque(desc_k<kB>(st, 0)), k_lo = opaque(desc_k<kB>(st + C::kK, 0));
#pragma unroll
    for (int ks = 0; ks < kQSteps; ++ks)
      wgmma_tf32_ss<kB>(s, dq_lo + step_k<kBlockQ>(ks), k_hi + step_k<kB>(ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < kQRegSteps; ++ks)
      wgmma_tf32_rs<kB>(s, ql[ks], k_hi + step_k<kB>(kQSteps + ks), 1);
#pragma unroll
    for (int ks = 0; ks < kQSteps; ++ks)
      wgmma_tf32_ss<kB>(s, dq_hi + step_k<kBlockQ>(ks), k_lo + step_k<kB>(ks), 1);
#pragma unroll
    for (int ks = 0; ks < kQRegSteps; ++ks)
      wgmma_tf32_rs<kB>(s, qh[ks], k_lo + step_k<kB>(kQSteps + ks), 1);
#pragma unroll
    for (int ks = 0; ks < kQSteps; ++ks)
      wgmma_tf32_ss<kB>(s, dq_hi + step_k<kBlockQ>(ks), k_hi + step_k<kB>(ks), 1);
#pragma unroll
    for (int ks = 0; ks < kQRegSteps; ++ks)
      wgmma_tf32_rs<kB>(s, qh[ks], k_hi + step_k<kB>(kQSteps + ks), 1);
  };
  auto issue_pv = [&](int u) {  // O_part = P_u V_u, afresh
    const unsigned char* st = stages + (u % kStages) * C::kStage + 2 * C::kK;
    const uint64_t v_hi = opaque(desc_k<D>(st, 0)), v_lo = opaque(desc_k<D>(st + C::kV, 0));
    mma3_rs<D, kKSteps, D>(op, ph, pl, v_hi, v_lo, 0);
  };
  auto finish = [&]() {
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(op);
  };
  auto flush = [&]() {  // O = O * corr + P_{u-1} V_{u-1}
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], op[i]);
  };
  auto softmax = [&](int u, uint32_t bits) {
    if (u > 0) flush();
    const int k0 = u * kB;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kKSteps; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * nt + e] * p.qscale;
        if constexpr (kMasked) {
          if (!((bits >> (4 * nt + e)) & 1u)) x = -INFINITY;
        } else if (k0 + kB > p.M && k0 + nt * 8 + 2 * t4 + (e & 1) >= p.M) {
          x = -INFINITY;
        }
        s[4 * nt + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kKSteps; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * nt + e] = exp2f(s[4 * nt + e] - base[e >> 1]);
        rs[e >> 1] += s[4 * nt + e];
      }
      split_tile(ph[nt], pl[nt], s + 4 * nt);
    }
    l_run[0] = l_run[0] * corr[0] + rs[0];
    l_run[1] = l_run[1] * corr[1] + rs[1];
  };

  // The tensor cores in turns, as `pingpong` (bhnd_hopper.cuh) takes them: a
  // warpgroup waits for its turn (named barrier 1 + wg), issues O_part =
  // P_{u-1} V_{u-1} and S_u, hands the turn over, waits for its products,
  // releases tile u - 1's stage (warpgroup 1, the last to read it, refills
  // it) and runs its softmax while the other's products run.
  const int mine = 1 + wg, other = 1 + (wg ^ 1);
  if (wg == 1) bar_arrive(other, 2 * kWgThreads);
  mbar_wait(&full[0], 0);
  bar_sync(mine, 2 * kWgThreads);
  wgmma_fence();
  issue_s(0);
  bar_arrive(other, 2 * kWgThreads);
  uint32_t bits = kMasked ? mask_bits(0) : 0u;
  finish();
  softmax(0, bits);
  for (int u = 1; u < n_u; ++u) {
    mbar_wait(&full[u % kStages], (u / kStages) & 1);
    bar_sync(mine, 2 * kWgThreads);
    wgmma_fence();
    issue_pv(u - 1);
    issue_s(u);
    bar_arrive(other, 2 * kWgThreads);
    if constexpr (kMasked) bits = mask_bits(u);
    finish();
    if (lane == 0) mbar_arrive(&empty[(u - 1) % kStages]);
    refill<kStages>(empty, u - 1, n_u, load);
    softmax(u, bits);
  }
  bar_sync(mine, 2 * kWgThreads);
  wgmma_fence();
  issue_pv(n_u - 1);
  if (wg == 0) bar_arrive(other, 2 * kWgThreads);
  finish();
  flush();

  float denom[2], lse[2];
  row_totals(l_run, m_run, denom, lse);
  float* out = p.o + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= p.N) continue;
    float* orow = out + row * p.o_n;
    if (p.o_d == 1) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<float2*>(orow + dt * 8 + 2 * t4) =
            make_float2(o[4 * dt + 2 * r] / denom[r], o[4 * dt + 2 * r + 1] / denom[r]);
      }
    } else {  // D-major (DN): a column's 8 rows of a warp fill a 32-byte sector (`store_cols`)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        orow[(dt * 8 + 2 * t4) * p.o_d] = o[4 * dt + 2 * r] / denom[r];
        orow[(dt * 8 + 2 * t4 + 1) * p.o_d] = o[4 * dt + 2 * r + 1] / denom[r];
      }
    }
    if (t4 == 0) p.lse[bh * p.N + row] = lse[r];
  }
}

template <int D, bool kMasked>
int launch_fwd(const FwdParams& p, cudaStream_t s) {
  using C = FwdCfg<D>;
  cudaError_t err = allow_smem<flash_fp32_fwd_kernel<D, kMasked>>(C::kSmem);
  if (err != cudaSuccess) return err;
  flash_fp32_fwd_kernel<D, kMasked>
      <<<dim3((p.N + kBlockQ - 1) / kBlockQ, p.H, p.B), block_threads(false), C::kSmem, s>>>(p);
  return cudaGetLastError();
}

struct RunFwd {
  template <int D>
  static int run(const FwdParams& p, cudaStream_t s) {
    return p.plan != nullptr ? launch_fwd<D, true>(p, s) : launch_fwd<D, false>(p, s);
  }
};

}  // namespace

// The forward, after `vjepa2_flash_fp32_prepass_fwd` on the same stream:
// q_nat, k_nat ([2][B][H][N|M][D]) and v_tr ([2][B][H][D][padded8(M)]) are its
// split copies. out: fp32 at element strides (b, h, n, d): unit along d and
// the others even, or unit along n (the DN layout [B, H, D, N]);
// lse [B, H, N] contiguous fp32. seg_q [B, N] and seg_k [B, M] int32 (both or
// neither): query i attends key j iff seg_q[i] >= seg_k[j]; causal: iff j <= i.
// With either, plan (`mask_tile_plan`, blocks of 128 queries, tiles of 64
// keys at D <= 64 and 32 above) at batch stride plan_b and row width plan_w.
// strides: out's (b, h, n, d), seg_q's and seg_k's batch strides, plan_b,
// plan_w. qscale = scale * log2(e). Returns the cudaError_t of the launch (0
// on success).
extern "C" int vjepa2_flash_fwd_fp32(const void* q_nat, const void* k_nat, const void* v_tr,
                                     void* out, void* lse, const void* seg_q, const void* seg_k,
                                     const void* plan, int B, int H, int D, int N, int M,
                                     int causal, const long long* strides, float qscale,
                                     void* stream) {
  const long long* o_str = strides;
  const bool masked = seg_q != nullptr || causal != 0;
  const bool d_major = o_str[3] != 1;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B > 32767 || H > 65535 || !aligned16(out) ||
      lse == nullptr ||
      (d_major ? o_str[2] != 1
               : (o_str[0] % 2 != 0 || o_str[1] % 2 != 0 || (N > 1 && o_str[2] % 2 != 0))) ||
      (seg_q == nullptr) != (seg_k == nullptr) || strides[4] < 0 || strides[5] < 0 ||
      masked != (plan != nullptr) || strides[6] < 0 ||
      (masked && strides[7] < 1 + (M + (D <= 64 ? 64 : 32) - 1) / (D <= 64 ? 64 : 32)))
    return cudaErrorInvalidValue;
  FwdParams p;
  if (!encode_split(&p.tm_q, q_nat, D, N, H, B, kBlockQ) ||
      !encode_split(&p.tm_k, k_nat, D, M, H, B, D <= 64 ? 64 : 32) ||
      !encode_split(&p.tm_vt, v_tr, padded8(M), D, H, B, D))
    return cudaErrorInvalidValue;
  p.q_nat = static_cast<const float*>(q_nat);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.segq_b = strides[4];
  p.segk_b = strides[5];
  p.plan = static_cast<const int*>(plan);
  p.plan_b = strides[6];
  p.plan_w = strides[7];
  p.causal = causal != 0;
  p.o = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_b = o_str[0];
  p.o_h = o_str[1];
  p.o_n = o_str[2];
  p.o_d = o_str[3];
  p.B = B;
  p.H = H;
  p.N = N;
  p.M = M;
  p.qscale = qscale;
  return dispatch_width<RunFwd>(D, p, static_cast<cudaStream_t>(stream));
}
