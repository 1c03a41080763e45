// Flash-attention forward over [B, H, D, N] ("DN") operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vjepa2_tpu/ops/flash_attention_dn.py:129 _fwd_kernel_dn`
// (wrapper `_flash_fwd_bhdn:198`). Same contract:
//   * q, k, v bf16 [B, H, D, N] with unit stride along N (the wrapper checks
//     it), D in {16, 32, 48, 64};
//   * split-half RoPE on q and k in fp32 (pairs d and d + D/2), tables fp32
//     with strides (batch, d, n), batch stride 0 when shared; q takes
//     scale*log2(e) before it is rounded to bf16, k is rounded after the
//     rotation, as the TPU kernel does (`:156-164`), through `dn_common.cuh`'s
//     `rope_pair` / `round_scaled`, so B2's prologue recomputes the same bits;
//   * online softmax in base 2 with fp32 statistics and fp32 accumulation;
//   * optional segment mask, attend iff seg_q >= seg_k, compared as int32;
//   * keys at or beyond `kv_lim` (the static kv_valid, or M) are masked; the
//     kernel masks its own ragged edge, so N and M need no padding;
//   * out in the layout given by its strides, lse [B, H, N] fp32 natural log;
//     a row with no key gives output 0 and lse -inf.
//
// What bounds it on this card: per score the tensor cores do 4*Dh FLOPs
// (256 at Dh 64) against about 10 scalar operations of softmax, so the
// scalar work and its latency set the pace unless the two overlap; memory
// traffic is ~1/50 of the FLOP bound.
//
// Design, on `bhnd_hopper.cuh` (B3's machinery: TMA, mbarrier rings, wgmma,
// named barriers, setmaxnreg, and the consumers' `online_softmax` and
// `pingpong` turns, which B3 runs too):
//   * launch 1 (`rope_pack_kernel`) rotates q and k once, folds
//     scale*log2(e) into q, and writes both rounded to bf16 token-major
//     [B, H, N|M, D] into scratch; v is read in place unless TMA cannot step
//     it (its key rows must be 16-byte aligned: M % 8 == 0 for a contiguous
//     v), and then this launch also copies it into [B, H, D, Mp], Mp = M
//     rounded up to 8 (the entry point refuses such a v without that
//     buffer, and the wrapper calls again with one);
//   * launch 2 (`flash_fwd_dn_kernel`): 128 queries a block, two consumer
//     warpgroups of 64 rows (232 registers after setmaxnreg) and a producer
//     warp (40). The producer loads q once and 128-key tiles of k and v
//     through a 3-stage ring by TMA (boxes of 64 features x 128 tokens for q
//     and k, 64 keys x D features for v), with the tile's key segment ids
//     copied beside them by the producer warp's lanes;
//   * S = Q K^T is wgmma m64n128k16 over D/16 k-steps, both operands in
//     shared memory; masks, running max and one exp2 per score in
//     registers. With segments the producer also stages each tile's least
//     and largest key id, and a warpgroup whose queries' ids all reach the
//     largest skips the mask, and one whose ids all lie below the least
//     skips the softmax (P = 0); only the other tiles mask score by score; P stays in registers as the A
//     operand of O += P V, one wgmma of N = D per 16 keys. v's keys are
//     contiguous, the reduction of P V, so its tile is the K-major B operand
//     as it lies: no transpose of v exists;
//   * the two consumers take turns on the tensor cores (ping-pong), each
//     running its softmax while the other's products run; key tiles wholly
//     past kv_lim are skipped;
//   * the epilogue normalises O, transposes it through shared memory and
//     writes out along N, 16 bytes a store where the strides allow.

#include <limits.h>

#include "bhnd_hopper.cuh"

namespace {

constexpr int kPrologueThreads = 256;
constexpr int kBlockQ = 128;  // queries a block, 64 a consumer warpgroup
constexpr int kBlockK = 128;  // keys a tile
constexpr int kStages = 3;
constexpr int kQTile = kBlockQ * kRowBytes;  // q or k tile: 128 tokens x 64 features (bf16)
constexpr int kOStride = 72;  // the output stage's row: 64 queries + 8 (bank spread)

struct Strides {
  long long b, h, d, n;
};

// The prologue's arguments.
struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* cos;  // null: no RoPE
  const float* sin;
  __nv_bfloat16* v_copy;  // null: v is read in place
  Strides sq, sk, sv;
  long long t_b, t_d, t_n;  // RoPE table strides
  int H, N, M, Mp;
  float qscale;  // scale * log2(e)
};

// The main kernel's arguments.
struct MainParams {
  CUtensorMap tm_q, tm_k;  // q', k' [B, H, N|M, D]: boxes of 64 features x 128 tokens
  CUtensorMap tm_v;        // v [B, H, D, M] (or its copy): boxes of 64 keys x D features
  const int* seg;          // null: no segment mask; [B|1, N] int32 (N == M)
  __nv_bfloat16* o;
  float* lse;              // [B, H, N]
  long long o_b, o_h, o_d, o_n;
  long long seg_b;
  int H, N, M, kv_lim;
  int vec_out;             // 16-byte stores of out along N
};

// Eight consecutive bf16 (16 bytes, aligned) as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// Eight consecutive fp32 (32 bytes, 16-byte aligned).
__device__ __forceinline__ void load8f(const float* src, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Stage rows [t0, t0 + kRows) of q or k (tokens at or past n_lim read as 0)
// into dst[token][d] as bf16: rotate the pair (d, d + D/2) in fp32 when
// tables are given, x * cos + [-x_hi, x_lo] * sin, multiply by `mul`, round.
template <int D, int kRows, bool kVec>
__device__ __forceinline__ void stage_rotated(__nv_bfloat16* dst, const __nv_bfloat16* x,
                                              const Strides& s, const float* cos_t,
                                              const float* sin_t, const Params& p, int t0,
                                              int n_lim, float mul) {
  constexpr int kHalf = D / 2, kStride = D + kPad;
  if constexpr (kVec) {
    // a work item is 8 consecutive tokens of one pair; neighbouring lanes
    // take neighbouring 16-byte halves of one 32-byte sector
    constexpr int kGroups = kRows / 8;
    for (int i = threadIdx.x; i < kHalf * kGroups; i += kPrologueThreads) {
      const int rest = i >> 1;
      const int d = rest % kHalf;
      const int grp = (rest / kHalf) * 2 + (i & 1);
      const int n = t0 + grp * 8;
      float lo[8], hi[8];
      if (n < n_lim) {  // n_lim is a multiple of 8 on this path
        load8(x + d * s.d + n, lo);
        load8(x + (d + kHalf) * s.d + n, hi);
        if (cos_t != nullptr) {
          float c_lo[8], s_lo[8], c_hi[8], s_hi[8];
          load8f(cos_t + d * p.t_d + n, c_lo);
          load8f(sin_t + d * p.t_d + n, s_lo);
          load8f(cos_t + (d + kHalf) * p.t_d + n, c_hi);
          load8f(sin_t + (d + kHalf) * p.t_d + n, s_hi);
#pragma unroll
          for (int j = 0; j < 8; ++j) rope_pair(lo[j], hi[j], c_lo[j], s_lo[j], c_hi[j], s_hi[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[(grp * 8 + j) * kStride + d] = round_scaled(lo[j], mul);
        dst[(grp * 8 + j) * kStride + d + kHalf] = round_scaled(hi[j], mul);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kHalf * kRows; i += kPrologueThreads) {
      const int d = i / kRows, r = i % kRows, n = t0 + r;
      float lo = 0.f, hi = 0.f;
      if (n < n_lim) {
        lo = __bfloat162float(x[d * s.d + n * s.n]);
        hi = __bfloat162float(x[(d + kHalf) * s.d + n * s.n]);
        if (cos_t != nullptr) {
          const long long i_lo = d * p.t_d + n * p.t_n;
          const long long i_hi = (d + kHalf) * p.t_d + n * p.t_n;
          rope_pair(lo, hi, cos_t[i_lo], sin_t[i_lo], cos_t[i_hi], sin_t[i_hi]);
        }
      }
      dst[r * kStride + d] = round_scaled(lo, mul);
      dst[r * kStride + d + kHalf] = round_scaled(hi, mul);
    }
  }
}

// Prologue: q' = bf16(rot(q) * scale*log2(e)), k' = bf16(rot(k)), written
// token-major [B, H, N|M, D] for the main kernel, and, when `v_copy` is set,
// v's rows copied into it with a row length of Mp (M rounded up to 8), which
// TMA can step. One block per (b, h, 64 tokens).
template <int D, bool kVec>
__global__ void __launch_bounds__(kPrologueThreads)
    rope_pack_kernel(const Params p, __nv_bfloat16* qr, __nv_bfloat16* kr) {
  constexpr int kRows = 64, kStride = D + kPad, kChunks = D / 8;
  __shared__ __align__(16) __nv_bfloat16 s_t[kRows * kStride];
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRows;
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  for (int which = 0; which < 2; ++which) {
    const bool is_q = which == 0;
    const int n_lim = is_q ? p.N : p.M;
    if (t0 >= n_lim) continue;  // uniform across the block
    const Strides& s = is_q ? p.sq : p.sk;
    const __nv_bfloat16* src = (is_q ? p.q : p.k) + b * s.b + h * s.h;
    stage_rotated<D, kRows, kVec>(s_t, src, s, cos_t, sin_t, p, t0, n_lim,
                                  is_q ? p.qscale : 1.f);
    __syncthreads();
    __nv_bfloat16* dst = (is_q ? qr : kr) + ((long long)b * p.H + h) * n_lim * D;
    for (int i = threadIdx.x; i < kRows * kChunks; i += kPrologueThreads) {
      const int r = i / kChunks, c = i % kChunks;
      if (t0 + r < n_lim) {
        *reinterpret_cast<uint4*>(dst + (long long)(t0 + r) * D + c * 8) =
            *reinterpret_cast<const uint4*>(&s_t[r * kStride + c * 8]);
      }
    }
    __syncthreads();
  }
  if (p.v_copy != nullptr && t0 < p.M) {
    const __nv_bfloat16* src = p.v + b * p.sv.b + h * p.sv.h;
    __nv_bfloat16* dst = p.v_copy + ((long long)b * p.H + h) * D * p.Mp;
    for (int i = threadIdx.x; i < D * kRows; i += kPrologueThreads) {
      const int d = i / kRows, n = t0 + i % kRows;
      if (n < p.M) dst[(long long)d * p.Mp + n] = src[d * p.sv.d + n * p.sv.n];
    }
  }
}

// v's ring tile: two 64-key chunks of D feature rows (128 bytes each).
template <int D>
__host__ __device__ constexpr int v_tile_bytes() {
  return 2 * D * kRowBytes;
}

template <int D>
constexpr int main_smem_bytes() {  // q, the k and v rings, the output stage, ids, barriers
  return kQTile + kStages * (kQTile + v_tile_bytes<D>()) + 2 * D * kOStride * 2 +
         kStages * (kBlockK + 2) * 4 + 16 * 4 + (1 + 2 * kStages) * 8 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_dn_kernel(const __grid_constant__ MainParams p) {
  constexpr int kVTile = v_tile_bytes<D>(), kSteps = D / 16, kNt = kBlockK / 8;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_q = align1024(smem_raw);
  unsigned char* s_k = s_q + kQTile;              // [kStages][kQTile]
  unsigned char* s_v = s_k + kStages * kQTile;    // [kStages][kVTile]
  bf16* s_o = reinterpret_cast<bf16*>(s_v + kStages * kVTile);  // [2][D][kOStride]
  int* s_seg = reinterpret_cast<int*>(s_o + 2 * D * kOStride);   // [kStages][kBlockK]
  int* s_krange = s_seg + kStages * kBlockK;  // [kStages][2]: a tile's least and largest key id
  int* s_qrange = s_krange + 2 * kStages;     // [2 warpgroups][4 warps][2]: the same of queries
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_qrange + 16);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int n_kt = (p.kv_lim + kBlockK - 1) / kBlockK;  // tiles past kv_lim are all masked
  const bool use_seg = p.seg != nullptr;
  const int* seg = use_seg ? p.seg + b * p.seg_b : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], use_seg ? 1 + 32 : 1);  // the TMA bytes, and each lane's ids
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {  // producer: one warp; its first lane issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x < 2 * kWgThreads + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(q_full, kQTile);
        tma_load(s_q, &p.tm_q, 0, q0, h, b, q_full);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages, k0 = j * kBlockK;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], kQTile + kVTile);
          tma_load(s_k + s * kQTile, &p.tm_k, 0, k0, h, b, &full[s]);
          tma_load(s_v + s * kVTile, &p.tm_v, k0, 0, h, b, &full[s]);
          tma_load(s_v + s * kVTile + D * kRowBytes, &p.tm_v, k0 + kChunk, 0, h, b, &full[s]);
        }
        if (use_seg) {
          int lo = INT_MAX, hi = INT_MIN;
          for (int i = lane; i < kBlockK; i += 32) {
            const int id = k0 + i < p.M ? seg[k0 + i] : 0;
            s_seg[s * kBlockK + i] = id;
            if (k0 + i < p.M) {
              lo = min(lo, id);
              hi = max(hi, id);
            }
          }
          for (int o = 16; o > 0; o >>= 1) {
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
          }
          if (lane == 0) {
            s_krange[2 * s] = lo;
            s_krange[2 * s + 1] = hi;
          }
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int t = threadIdx.x % kWgThreads, warp = t >> 5, lane = t & 31;
  const int t4 = lane & 3;
  const int rbase = wg * 64;                       // this warpgroup's rows in the block
  const int ql = warp * 16 + (lane >> 2);          // this thread's rows in them: ql, ql + 8
  int qrow[2], segq[2] = {0, 0};
  int qlo = INT_MAX, qhi = INT_MIN;  // the least and largest id of this warpgroup's queries
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + rbase + ql + 8 * r;
    if (use_seg && qrow[r] < p.N) {
      segq[r] = seg[qrow[r]];
      qlo = min(qlo, segq[r]);
      qhi = max(qhi, segq[r]);
    }
  }
  if (use_seg) {
    for (int o = 16; o > 0; o >>= 1) {
      qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, o));
      qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, o));
    }
    int* qr = s_qrange + 8 * wg;
    if (lane == 0) {
      qr[2 * warp] = qlo;
      qr[2 * warp + 1] = qhi;
    }
    bar_sync(3 + wg, kWgThreads);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      qlo = min(qlo, qr[2 * w]);
      qhi = max(qhi, qr[2 * w + 1]);
    }
  }

  float s[kBlockK / 2];                           // S, 64 rows x 128 keys
  float o[D / 2];                                 // O, 64 rows x D features
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pf[kBlockK / 16][4];                   // P as A fragments, k-steps of 16 keys
  float m_run[2] = {-INFINITY, -INFINITY};        // running max, base-2 units
  float l_run[2] = {0.f, 0.f};                    // this thread's share of the denominator

  mbar_wait(q_full, 0);
  const uint64_t d_q = desc_k<kBlockQ>(s_q, rbase);
  auto issue_s = [&](int u) {  // S_u = Q K_u^T
    const uint64_t d_k = opaque(desc_k<kBlockK>(s_k + (u % kStages) * kQTile, 0));
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      wgmma_ss<kBlockK>(s, d_q + step_k<kBlockQ>(ks), d_k + step_k<kBlockK>(ks), ks > 0);
    }
  };
  auto issue_pv = [&](int u) {  // O += P_u V_u, v's rows K-major (keys contiguous)
    const uint64_t d_v = opaque(desc_k<D>(s_v + (u % kStages) * kVTile, 0));
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      wgmma_rs<D, 0>(o, pf[kk], d_v + step_k<D>(kk), 1);
    }
  };
  auto finish = [&]() {  // the products issued this turn, done
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
  };
  // masks, running max and denominators, P_u as A fragments, O rescaled.
  // With segments a tile is classed for this warpgroup's rows by the id
  // ranges: every pair attended (no mask), none (P = 0, which leaves O and
  // the statistics as they are), or some (masked score by score).
  auto softmax = [&](int u) {
    const int k0 = u * kBlockK, st = u % kStages;
    bool partial = k0 + kBlockK > p.kv_lim;
    if (use_seg) {
      if (qhi < s_krange[2 * st]) {
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) pf[kk][0] = pf[kk][1] = pf[kk][2] = pf[kk][3] = 0u;
        return;
      }
      partial = partial || qlo < s_krange[2 * st + 1];
    }
    if (partial) {
      const int* segk = s_seg + st * kBlockK;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int kl = nt * 8 + 2 * t4;
        const int2 ids = use_seg ? *reinterpret_cast<const int2*>(segk + kl)
                                 : make_int2(INT_MIN, INT_MIN);
        const bool in0 = k0 + kl < p.kv_lim, in1 = k0 + kl + 1 < p.kv_lim;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!(in0 && segq[r] >= ids.x)) s[4 * nt + 2 * r] = -INFINITY;
          if (!(in1 && segq[r] >= ids.y)) s[4 * nt + 2 * r + 1] = -INFINITY;
        }
      }
    }
    online_softmax<kBlockK>(s, o, pf, m_run, l_run);
  };

  pingpong<1, kStages>(wg, lane, n_kt, full, empty, issue_s, issue_pv, finish, softmax);

  // out = O / denominator, staged [feature][query] and written along N
  float denom[2], lse[2];
  row_totals(l_run, m_run, denom, lse);
  bf16* so = s_o + wg * D * kOStride;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      so[d * kOStride + ql + 8 * r] = __float2bfloat16_rn(o[4 * dt + 2 * r] / denom[r]);
      so[(d + 1) * kOStride + ql + 8 * r] = __float2bfloat16_rn(o[4 * dt + 2 * r + 1] / denom[r]);
    }
  }
  if (t4 == 0) {
    float* lse_bh = p.lse + ((long long)b * p.H + h) * p.N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] < p.N) lse_bh[qrow[r]] = lse[r];
    }
  }
  bar_sync(3 + wg, kWgThreads);
  bf16* op = p.o + b * p.o_b + h * p.o_h;
  const int n0 = q0 + rbase;
  if (p.vec_out) {  // N % 8 == 0: a group of 8 queries lies wholly below N or past it
    for (int i = t; i < D * 8; i += kWgThreads) {
      const int d = i / 8, n = n0 + (i % 8) * 8;
      if (n < p.N) {
        *reinterpret_cast<uint4*>(op + d * p.o_d + n) =
            *reinterpret_cast<const uint4*>(so + d * kOStride + (i % 8) * 8);
      }
    }
  } else {
    for (int i = t; i < D * 64; i += kWgThreads) {
      const int d = i / 64, n = n0 + i % 64;
      if (n < p.N) op[d * p.o_d + n * p.o_n] = so[d * kOStride + i % 64];
    }
  }
}

// The prologue's 16-byte path needs q and k unit-stride along N with rows
// that start 16-byte aligned, N and M multiples of 8, and tables likewise.
bool prologue_vec_ok(const Params& p) {
  const Strides* all[] = {&p.sq, &p.sk};
  const void* ptrs[] = {p.q, p.k};
  for (int i = 0; i < 2; ++i) {
    const Strides& s = *all[i];
    if (s.n != 1 || s.b % 8 || s.h % 8 || s.d % 8 || !aligned16(ptrs[i])) return false;
  }
  if (p.N % 8 || p.M % 8) return false;
  if (p.cos != nullptr &&
      (p.t_n != 1 || p.t_d % 4 || p.t_b % 4 || !aligned16(p.cos) || !aligned16(p.sin)))
    return false;
  return true;
}

template <int D>
cudaError_t launch(const Params& pp, const MainParams& mp, int B, __nv_bfloat16* qr,
                   __nv_bfloat16* kr, cudaStream_t stream) {
  constexpr int kSmem = main_smem_bytes<D>();
  cudaError_t err = allow_smem<flash_fwd_dn_kernel<D>>(kSmem);
  if (err != cudaSuccess) return err;
  const dim3 pro_grid(((pp.N > pp.M ? pp.N : pp.M) + 63) / 64, pp.H, B);
  if (prologue_vec_ok(pp)) {
    rope_pack_kernel<D, true><<<pro_grid, kPrologueThreads, 0, stream>>>(pp, qr, kr);
  } else {
    rope_pack_kernel<D, false><<<pro_grid, kPrologueThreads, 0, stream>>>(pp, qr, kr);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((pp.N + kBlockQ - 1) / kBlockQ, pp.H, B);
  flash_fwd_dn_kernel<D><<<grid, kThreads, kSmem, stream>>>(mp);
  return cudaGetLastError();
}

}  // namespace

// strides: 20 element strides, in order
//   q (b, h, d, n), k (b, h, d, n), v (b, h, d, n), out (b, h, d, n),
//   RoPE tables (b, d, n), segment ids (b).
// cos/sin null: no RoPE. seg null: no segment mask. lse is [B, H, N]
// contiguous. q_scratch [B, H, N, D] and k_scratch [B, H, M, D] bf16 receive
// the rotated, rounded q and k. v_scratch null: TMA reads v in place, and
// kNotTmaReady is returned, launching nothing, when it cannot (v's strides
// other than along N must be multiples of 8 and its base 16-byte aligned);
// else [B, H, D, Mp] bf16 with Mp = M rounded up to 8, into which the
// prologue copies v. Returns the cudaError_t of the launches (0 on
// success); cudaErrorInvalidValue, launching nothing, for arguments it does
// not take.
extern "C" int vjepa2_flash_fwd_dn_bf16(const void* q, const void* k, const void* v,
                                        const void* cos_t, const void* sin_t, const void* seg,
                                        void* out, void* lse, void* q_scratch, void* k_scratch,
                                        void* v_scratch, int B, int H, int D, int N, int M,
                                        int kv_lim, const long long* strides, float qscale,
                                        void* stream) {
  Params pp;
  pp.q = static_cast<const __nv_bfloat16*>(q);
  pp.k = static_cast<const __nv_bfloat16*>(k);
  pp.v = static_cast<const __nv_bfloat16*>(v);
  pp.cos = static_cast<const float*>(cos_t);
  pp.sin = static_cast<const float*>(sin_t);
  pp.v_copy = static_cast<__nv_bfloat16*>(v_scratch);
  pp.sq = {strides[0], strides[1], strides[2], strides[3]};
  pp.sk = {strides[4], strides[5], strides[6], strides[7]};
  pp.sv = {strides[8], strides[9], strides[10], strides[11]};
  pp.t_b = strides[16];
  pp.t_d = strides[17];
  pp.t_n = strides[18];
  pp.H = H;
  pp.N = N;
  pp.M = M;
  pp.Mp = (M + 7) / 8 * 8;
  pp.qscale = qscale;
  auto* qr = static_cast<__nv_bfloat16*>(q_scratch);
  auto* kr = static_cast<__nv_bfloat16*>(k_scratch);
  if (N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M || !aligned16(qr) || !aligned16(kr) ||
      (seg != nullptr && N != M))
    return cudaErrorInvalidValue;

  MainParams mp;
  mp.seg = static_cast<const int*>(seg);
  mp.o = static_cast<__nv_bfloat16*>(out);
  mp.lse = static_cast<float*>(lse);
  mp.o_b = strides[12];
  mp.o_h = strides[13];
  mp.o_d = strides[14];
  mp.o_n = strides[15];
  mp.seg_b = strides[19];
  mp.H = H;
  mp.N = N;
  mp.M = M;
  mp.kv_lim = kv_lim;
  mp.vec_out = mp.o_n == 1 && mp.o_d % 8 == 0 && mp.o_h % 8 == 0 && mp.o_b % 8 == 0 &&
               aligned16(out) && N % 8 == 0;
  const Operand oq = operand(qr, D, (long long)N * D, (long long)H * N * D, D, N, H, B);
  const Operand ok = operand(kr, D, (long long)M * D, (long long)H * M * D, D, M, H, B);
  // v as a map whose inner dim is the keys and whose rows are the features
  const Operand ov =
      v_scratch != nullptr
          ? operand(v_scratch, pp.Mp, (long long)D * pp.Mp, (long long)H * D * pp.Mp, M, D, H, B)
          : operand(v, pp.sv.d, pp.sv.h, pp.sv.b, M, D, H, B);
  if (pp.sv.n != 1) return cudaErrorInvalidValue;
  if (v_scratch == nullptr && !tma_ok(ov)) return kNotTmaReady;
  if (!encode(&mp.tm_q, oq, D, N, H, B, kBlockQ) || !encode(&mp.tm_k, ok, D, M, H, B, kBlockK) ||
      !encode(&mp.tm_v, ov, M, D, H, B, D))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(pp, mp, B, qr, kr, s);
    case 32: return launch<32>(pp, mp, B, qr, kr, s);
    case 48: return launch<48>(pp, mp, B, qr, kr, s);
    case 64: return launch<64>(pp, mp, B, qr, kr, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* vjepa2_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
