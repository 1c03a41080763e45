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
//     with seg_q < seg_k (int32 ids, compared as integers) get p = 0;
//   * delta = rowsum(do * out) in fp32; dv = p^T do; dp = do v^T;
//     ds = p (dp - delta) scale, rounded to bf16 as the TPU kernel does;
//     dk = ds^T q_u with q_u the rotated q rounded WITHOUT the scale (`:335`);
//     dq = ds k_rot;
//   * the RoPE adjoint (`_rope_rotate_dn_t:109`; not R(-theta), the tables'
//     pairs carry different angles) on dq and dk in fp32 after accumulation;
//     dq, dk, dv written bf16 [B, H, D, N|M] contiguous.
//
// What bounds it on this card: the tensor cores do 10*Dh FLOPs a score (S,
// dP, dV, dK, dQ; 14*Dh with dQ's recomputation of S and dP), against about
// a dozen scalar operations a score (exp2, masks, subtract, multiply,
// conversions and packing), so at Dh <= 64 the scalar work and the latency
// between dependent products set the pace unless they overlap; memory
// traffic is a few per cent of either.
//
// Design (`bhnd_hopper.cuh` for the machinery; the BHND backward
// `flash_bwd_bhnd.cu` is the same plan over token-major operands), three
// launches:
//   * `dn_bwd_prologue_kernel` writes only what has to exist: q_s =
//     bf16(rot(q) * scale*log2(e)), q_u = bf16(rot(q)) and k_rot =
//     bf16(rot(k)) token-major [B, H, N|M, D]; delta and lse*log2(e) in fp32
//     [B, H, Np]. v and do are read in place by TMA as DN boxes of 64 tokens
//     x D features (the token dim contiguous, 128-byte swizzled), unless TMA
//     cannot step them (a row of tokens not a whole number of 16 bytes, e.g.
//     M % 8 != 0 for a contiguous v, or a do whose unit stride is along D as
//     autograd hands it over): the entry point then refuses (kNotTmaReady)
//     and the wrapper calls again with a buffer [B, H, D, rows rounded up to
//     8] for it, into which this prologue copies it;
//   * `flash_bwd_dn_dkdv_kernel`: one block per (b, h, 128 keys), two
//     consumer warpgroups of 64 keys and a producer warp. The producer loads
//     k_rot and v once and streams 64-query tiles of q_s, q_u, do, lse,
//     delta and the query segment ids through a 3-stage ring. Per tile a
//     consumer issues S^T = K_rot Q_s^T (both K-major) and dP^T = V dO^T
//     (both DN tiles MN-major: the transpose bits of the instruction, no
//     copy), masks and exponentiates P^T and forms dS^T in registers, then
//     dV += P^T dO (the DN do tile as a K-major B operand as it lies) and
//     dK += dS^T Q_u (q_u MN-major), P^T and dS^T as register A operands.
//     dK and dV stay in fp32 registers;
//   * `flash_bwd_dn_dq_kernel`: one block per (b, h, 128 queries), 64-key
//     tiles of k_rot, v and the key ids through the ring; S = Q_s K_rot^T and
//     dP = dO V^T again, dQ += dS K_rot. This deterministic split recomputes
//     S and dP and needs no atomics, so two calls give equal bits;
//   * in both, the two consumers take turns on the tensor cores (named
//     barriers, ping-pong), so one's elementwise work overlaps the other's
//     products;
//   * a masked score gets an exponent of -inf, so p = exp2(-inf) = 0 with no
//     branch: `ok ? exp2(x) : 0` compiled to a branch around each exp2, and
//     with it the segment path took 2.7 ms at the AC row [8,16,64,1806]
//     against 1.4 without (an H100, `tools/ab_kernels.py`);
//   * both epilogues stage the fp32 accumulators in shared memory feature by
//     feature, where the RoPE adjoint reads each pair (d, d + D/2), and
//     write dq, dk, dv along the token dim. A thread loads every table entry
//     and staged value it needs before its first store: loads that follow a
//     store to dq/dk wait for it (the compiler cannot rule out an overlap),
//     and the RoPE adjoint then cost about 50 us a kernel at [8,16,64,584]
//     on an H100, as much as the main loop;
//   * the prologue's loops have trip counts the compiler sees (`each_item`),
//     so each phase's global loads are issued together.
// Not done yet, for later work: skipping tiles that a segment mask hides
// entirely (the frame-causal rows), with B1.

#include "bhnd_hopper.cuh"

namespace {

constexpr int kKeyBlock = 128;  // keys a dK/dV block, 64 a consumer warpgroup
constexpr int kQBlock = 128;    // queries a dQ block, 64 a consumer warpgroup
constexpr int kTile = 64;       // queries a dK/dV loop step, keys a dQ loop step
constexpr int kStages = 3;
constexpr int kRows = 64;       // tokens a prologue block
constexpr int kPrologueThreads = 256;
constexpr int kF = kTile + 4;   // the epilogues' fp32 staging row: 64 tokens of one feature
constexpr int kTokBytes = kTile * kRowBytes;  // a token-major tile: 64 tokens x 64 features

struct Str {
  long long b, h, n, d;
};

struct PrologueParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // [B, H, N]
  Str sq, sk, sv, so, sdo;
  const float* cos;  // null: no RoPE; [B|1] tables fp32, strides t_b, t_d, t_n
  const float* sin;
  long long t_b, t_d, t_n;
  bf16* qs;          // [B, H, N, D]  bf16(rot(q) * qscale)
  bf16* qu;          // [B, H, N, D]  bf16(rot(q))
  bf16* kr;          // [B, H, M, D]  bf16(rot(k))
  float* delta;      // [B, H, Np]
  float* lse2;       // [B, H, Np]    lse * log2(e); +inf where p must be 0
  bf16* v_copy;      // null, or [B, H, D, Mr]: v for TMA
  bf16* do_copy;     // null, or [B, H, D, Nr]: do for TMA
  int H, N, M, Np, Mr, Nr;
  int vec;           // bits 2i, 2i + 1: `load_tile`'s 16-byte paths for q, k, v, out, do
  float qscale;
};

struct BwdParams {
  CUtensorMap tm_qs, tm_qu, tm_kr;  // token-major: boxes of 64 features x 64 tokens
  CUtensorMap tm_v, tm_do;          // DN: boxes of 64 tokens x D features
  const float* lse2;
  const float* delta;
  const float* cos;
  const float* sin;
  long long t_b, t_d, t_n;
  const int* seg;  // null: no segment mask; [B|1, N] int32 (N == M)
  long long seg_b;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, N, M, Np, kv_lim;
  float scale;
};

// ---- prologue -------------------------------------------------------------

// f(i) for this thread's items i < kItems of the block, kPrologueThreads
// apart: a trip count the compiler sees, so that every item's global loads
// are issued before the first is used (one round trip a phase, not one an
// item).
template <int kItems, class F>
__device__ __forceinline__ void each_item(const F& f) {
#pragma unroll
  for (int it = 0; it < (kItems + kPrologueThreads - 1) / kPrologueThreads; ++it) {
    const int i = threadIdx.x + it * kPrologueThreads;
    if (kItems % kPrologueThreads == 0 || i < kItems) f(i);
  }
}

// Rows [t0, t0 + kRows) of x (element strides s; tokens at or past lim read
// as 0) into dst[row][0, D). `vec` bit 0: unit stride along d, 16-byte
// aligned rows (16 bytes a thread: 8 features of a token); bit 1: unit
// stride along n, 16-byte aligned feature rows (8 tokens of a feature a
// thread, neighbouring threads on neighbouring features, so the scattered
// 2-byte writes to dst do not conflict). Otherwise neighbouring threads
// read neighbouring addresses along whichever of n and d has unit stride.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* x, const Str& s, int t0, int lim,
                                          int vec) {
  constexpr int kStride = D + kPad, kChunks = D / 8;
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (vec & 1) {
    each_item<kRows * kChunks>([&](int i) {
      const int r = i / kChunks, c = i % kChunks, n = t0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n < lim) u = *reinterpret_cast<const uint4*>(x + n * s.n + c * 8);
      *reinterpret_cast<uint4*>(&dst[r * kStride + c * 8]) = u;
    });
  } else if (vec & 2) {
    each_item<kRows / 8 * D>([&](int i) {
      const int g = i / D, d = i % D, n = t0 + 8 * g;
      alignas(16) bf16 h[8];
      if (n + 8 <= lim) {
        *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(x + d * s.d + n);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = n + j < lim ? x[d * s.d + n + j] : zero;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(8 * g + j) * kStride + d] = h[j];
    });
  } else if (s.n == 1) {
    each_item<D * kRows>([&](int i) {
      const int d = i / kRows, r = i % kRows, n = t0 + r;
      dst[r * kStride + d] = n < lim ? x[d * s.d + n] : zero;
    });
  } else {
    each_item<kRows * D>([&](int i) {
      const int r = i / D, d = i % D, n = t0 + r;
      dst[r * kStride + d] = n < lim ? x[n * s.n + d * s.d] : zero;
    });
  }
}

// dst = bf16(rot(src) * mul) and, when dst1 is given, dst1 = bf16(rot(src))
// over a [row][d] tile, pairs (d, d + D/2), tables at token t0 + r (no
// rotation without tables, or past lim where the rows are zero). dst may be
// src: each pair is read and written by one thread. Neighbouring threads
// take neighbouring tokens when the tables have unit stride along n (a
// thread then keeps one token), else neighbouring features.
template <int D>
__device__ __forceinline__ void rotate_tile(bf16* dst, bf16* dst1, const bf16* src,
                                            const float* cos_t, const float* sin_t,
                                            const PrologueParams& p, int t0, int lim, float mul) {
  constexpr int kHalf = D / 2, kStride = D + kPad;
  const bool along_n = p.t_n == 1;
  each_item<kRows * kHalf>([&](int i) {
    const int r = along_n ? i % kRows : i / kHalf;
    const int d = along_n ? i / kRows : i % kHalf;
    const int n = t0 + r;
    float lo = __bfloat162float(src[r * kStride + d]);
    float hi = __bfloat162float(src[r * kStride + d + kHalf]);
    if (cos_t != nullptr && n < lim) {
      const long long i_lo = n * p.t_n + d * p.t_d;
      const long long i_hi = n * p.t_n + (d + kHalf) * p.t_d;
      rope_pair(lo, hi, cos_t[i_lo], sin_t[i_lo], cos_t[i_hi], sin_t[i_hi]);
    }
    dst[r * kStride + d] = round_scaled(lo, mul);
    dst[r * kStride + d + kHalf] = round_scaled(hi, mul);
    if (dst1 != nullptr) {
      dst1[r * kStride + d] = __float2bfloat16_rn(lo);
      dst1[r * kStride + d + kHalf] = __float2bfloat16_rn(hi);
    }
  });
}

// src[token][d] -> rows [t0, t0 + kRows) below lim of a token-major [*, D]
// array, 16 bytes a thread.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* src, int t0, int lim) {
  constexpr int kChunks = D / 8, kStride = D + kPad;
  each_item<kRows * kChunks>([&](int i) {
    const int r = i / kChunks, c = i % kChunks;
    if (t0 + r < lim) {
      *reinterpret_cast<uint4*>(dst + (long long)(t0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(&src[r * kStride + c * 8]);
    }
  });
}

// src[token][d] -> columns [t0, t0 + kRows) below lim of a DN [D, len] array.
template <int D>
__device__ __forceinline__ void store_dn(bf16* dst, const bf16* src, int t0, int lim, int len) {
  constexpr int kStride = D + kPad;
  each_item<D * kRows>([&](int i) {
    const int d = i / kRows, r = i % kRows;
    if (t0 + r < lim) dst[(long long)d * len + t0 + r] = src[r * kStride + d];
  });
}

// One block per (b, h, 64 tokens): the query side below Np, the key side
// below M.
template <int D>
__global__ void __launch_bounds__(kPrologueThreads) dn_bwd_prologue_kernel(const PrologueParams p) {
  constexpr int kStride = D + kPad;
  __shared__ __align__(16) bf16 s_a[kRows * kStride];
  __shared__ __align__(16) bf16 s_b[kRows * kStride];
  __shared__ __align__(16) bf16 s_c[kRows * kStride];
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRows;
  const long long bh = (long long)b * p.H + h;
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;

  if (t0 < p.Np) {
    load_tile<D>(s_a, p.q + b * p.sq.b + h * p.sq.h, p.sq, t0, p.N, p.vec & 3);
    load_tile<D>(s_b, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo, t0, p.N, (p.vec >> 8) & 3);
    load_tile<D>(s_c, p.o + b * p.so.b + h * p.so.h, p.so, t0, p.N, (p.vec >> 6) & 3);
    __syncthreads();
    {  // delta = rowsum(do * out) in fp32: four threads a token
      const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
      float acc = 0.f;
      for (int d = part; d < D; d += 4) {
        acc += __bfloat162float(s_b[r * kStride + d]) * __bfloat162float(s_c[r * kStride + d]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) p.delta[bh * p.Np + t0 + r] = acc;
    }
    if (threadIdx.x < kRows) {
      const int n = t0 + threadIdx.x;
      float l2 = INFINITY;  // past N, or a row with no key: p = exp2(s - inf) = 0
      if (n < p.N) {
        const float l = p.lse[bh * p.N + n];
        if (l != -INFINITY) l2 = l * kLog2e;
      }
      p.lse2[bh * p.Np + n] = l2;
    }
    __syncthreads();  // s_c (out) is free
    rotate_tile<D>(s_a, s_c, s_a, cos_t, sin_t, p, t0, p.N, p.qscale);  // q_s in place, q_u
    __syncthreads();
    store_rows<D>(p.qs + bh * p.N * D, s_a, t0, p.N);
    store_rows<D>(p.qu + bh * p.N * D, s_c, t0, p.N);
    if (p.do_copy != nullptr) store_dn<D>(p.do_copy + bh * D * p.Nr, s_b, t0, p.N, p.Nr);
    __syncthreads();
  }
  if (t0 < p.M) {
    load_tile<D>(s_a, p.k + b * p.sk.b + h * p.sk.h, p.sk, t0, p.M, (p.vec >> 2) & 3);
    if (p.v_copy != nullptr) {
      load_tile<D>(s_b, p.v + b * p.sv.b + h * p.sv.h, p.sv, t0, p.M, (p.vec >> 4) & 3);
    }
    __syncthreads();
    rotate_tile<D>(s_a, nullptr, s_a, cos_t, sin_t, p, t0, p.M, 1.f);
    __syncthreads();
    store_rows<D>(p.kr + bh * p.M * D, s_a, t0, p.M);
    if (p.v_copy != nullptr) store_dn<D>(p.v_copy + bh * D * p.Mr, s_b, t0, p.M, p.Mr);
  }
}

// ---- main kernels ---------------------------------------------------------

// This warpgroup's 64 tokens of a product (64 x D fp32, accumulator layout)
// -> tokens t0 + r < lim of dst, a DN [D, lim] bf16 array, through fp32
// staging in s_f [D][kF]; the RoPE adjoint R^T first when cos_t is given
// (pairs (d, d + D/2) read back from s_f), then each feature's tokens
// written along the token dim. A thread past lim returns at once: nothing
// after the barrier waits for it.
template <int D>
__device__ __forceinline__ void write_dn(bf16* dst, float* s_f, const float (&acc)[D / 2],
                                         const float* cos_t, const float* sin_t, long long t_d,
                                         long long t_n, int t0, int lim, int bar_id) {
  constexpr int kHalf = D / 2;
  const int t = threadIdx.x % kWgThreads, lane = t & 31, t4 = lane & 3;
  const int lr = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      s_f[(dt * 8 + 2 * t4) * kF + lr + 8 * r] = acc[4 * dt + 2 * r];
      s_f[(dt * 8 + 2 * t4 + 1) * kF + lr + 8 * r] = acc[4 * dt + 2 * r + 1];
    }
  }
  bar_sync(bar_id, kWgThreads);
  // a thread: one token, every other feature; neighbouring threads on
  // neighbouring tokens. Every operand is loaded before the first store: a
  // load after a store to dst would wait for it (the compiler cannot tell
  // that they do not overlap), one L2 round trip per pair
  const int r = t % kTile, d0 = t / kTile, n = t0 + r;
  if (n >= lim) return;
  if (cos_t != nullptr) {
    float g[2][kHalf / 2], c[2][kHalf / 2], sn[2][kHalf / 2];
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) {
      const int d = 2 * i + d0;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int dd = d + hi * kHalf;
        g[hi][i] = s_f[dd * kF + r];
        c[hi][i] = cos_t[dd * t_d + n * t_n];
        sn[hi][i] = sin_t[dd * t_d + n * t_n];
      }
    }
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) {
      const int d = 2 * i + d0;
      dst[(long long)d * lim + n] = __float2bfloat16_rn(g[0][i] * c[0][i] + g[1][i] * sn[1][i]);
      dst[(long long)(d + kHalf) * lim + n] =
          __float2bfloat16_rn(g[1][i] * c[1][i] - g[0][i] * sn[0][i]);
    }
  } else {
    float g[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) g[i] = s_f[(2 * i + d0) * kF + r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dst[(long long)(2 * i + d0) * lim + n] = __float2bfloat16_rn(g[i]);
  }
}

// A DN tile: 64 tokens x D features, D rows of 128 bytes.
template <int D>
__host__ __device__ constexpr int dn_tile_bytes() {
  return D * kRowBytes;
}
template <int D>
__host__ __device__ constexpr int dkdv_stage_bytes() {  // q_s, q_u, do; lse2, delta, ids
  return 2 * kTokBytes + dn_tile_bytes<D>() + 1024;
}
template <int D>
constexpr int dkdv_smem_bytes() {  // k_rot and v of the block, the ring, barriers
  return 2 * kTokBytes + 2 * dn_tile_bytes<D>() + kStages * dkdv_stage_bytes<D>() + 64 + 1024;
}
template <int D>
__host__ __device__ constexpr int dq_stage_bytes() {  // k_rot, v; the key ids
  return kTokBytes + dn_tile_bytes<D>() + 1024;
}
template <int D>
constexpr int dq_smem_bytes() {  // q_s and do of the block, the ring, barriers
  return 2 * kTokBytes + 2 * dn_tile_bytes<D>() + kStages * dq_stage_bytes<D>() + 64 + 1024;
}

// dk and dv for 128 keys of one (b, h), looping over 64-query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dn_dkdv_kernel(const __grid_constant__ BwdParams p) {
  constexpr int kSteps = D / 16, kDn = dn_tile_bytes<D>(), kStage = dkdv_stage_bytes<D>();
  static_assert(2 * 2 * D * kF * 4 <= 2 * kTokBytes + 2 * kDn + kStages * kStage,
                "the epilogue fits");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* s_k = smem;                   // 128 keys token-major
  unsigned char* s_v = s_k + 2 * kTokBytes;    // two DN tiles of 64 keys
  unsigned char* stages = s_v + 2 * kDn;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeyBlock;
  const long long bh = (long long)b * p.H + h;
  const int n_qt = (p.N + kTile - 1) / kTile;
  const bool work = k0 < p.kv_lim;  // else dk = dv = 0
  const bool use_seg = p.seg != nullptr;
  const int* seg = use_seg ? p.seg + b * p.seg_b : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
    if (threadIdx.x < 2 * kWgThreads + 32 && work) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kTokBytes + 2 * kDn);
        tma_load(s_k, &p.tm_kr, 0, k0, h, b, kv_full);
        tma_load(s_k + kTokBytes, &p.tm_kr, 0, k0 + kTile, h, b, kv_full);
        tma_load(s_v, &p.tm_v, k0, 0, h, b, kv_full);
        tma_load(s_v + kDn, &p.tm_v, k0 + kTile, 0, h, b, kv_full);
      }
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kStages, q0 = it * kTile;
        unsigned char* st = stages + s * kStage;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        float* side = reinterpret_cast<float*>(st + 2 * kTokBytes + kDn);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * kTokBytes + kDn + 2 * kTile * 4);
          tma_load(st, &p.tm_qs, 0, q0, h, b, &full[s]);
          tma_load(st + kTokBytes, &p.tm_qu, 0, q0, h, b, &full[s]);
          tma_load(st + 2 * kTokBytes, &p.tm_do, q0, 0, h, b, &full[s]);
          bulk_load(side, p.lse2 + bh * p.Np + q0, kTile * 4, &full[s]);
          bulk_load(side + kTile, p.delta + bh * p.Np + q0, kTile * 4, &full[s]);
        }
        if (use_seg) {
          int* ids = reinterpret_cast<int*>(side + 2 * kTile);
          for (int i = lane; i < kTile; i += 32) ids[i] = q0 + i < p.N ? seg[q0 + i] : 0;
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int t = threadIdx.x % kWgThreads, lane = t & 31, t4 = lane & 3;
  const int rbase = wg * 64;
  float dk[D / 2], dv[D / 2];  // 64 keys x D features each
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // The tensor cores in turns (ping-pong on named barriers 1 and 2): a
  // warpgroup issues its products, hands the turn to the other and does its
  // elementwise work while the other's products run.
  const int n_steps = work ? n_qt : 0, mine = 1 + wg, other = 1 + (wg ^ 1);
  if (n_steps > 0) {
    // this thread's keys: -inf added to their scores where they are past
    // kv_lim (whole rows of S^T), and their segment ids
    float key_bias[2];
    int segk[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + rbase + (t >> 5) * 16 + (lane >> 2) + 8 * r;
      key_bias[r] = key < p.kv_lim ? 0.f : -INFINITY;
      if (use_seg && key < p.M) segk[r] = seg[key];
    }
    mbar_wait(kv_full, 0);
    if (wg == 1) bar_arrive(other, 2 * kWgThreads);  // warpgroup 0 takes the first turn
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kStages;
      const unsigned char* st = stages + s * kStage;
      const float* s_l = reinterpret_cast<const float*>(st + 2 * kTokBytes + kDn);
      const float* s_dl = s_l + kTile;
      const int* s_ids = reinterpret_cast<const int*>(s_dl + kTile);
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint64_t d_k = opaque(desc_k<kKeyBlock>(s_k, rbase));
      const uint64_t d_v = opaque(desc_mn<D>(s_v + wg * kDn));  // 64 keys x D, MN-major
      const uint64_t d_qs = opaque(desc_k<kTile>(st, 0));
      const uint64_t d_do = opaque(desc_mn<D>(st + 2 * kTokBytes));  // 64 queries x D, MN-major
      float sT[32], dpT[32];  // S^T and dP^T, 64 keys x 64 queries
      bar_sync(mine, 2 * kWgThreads);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {  // S^T = K_rot Q_s^T, base-2 units
        wgmma_ss<64>(sT, d_k + step_k<kKeyBlock>(ks), d_qs + step_k<kTile>(ks), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {  // dP^T = V dO^T
        wgmma_ss_mn64(dpT, d_v + step_mn<D>(0, ks), d_do + step_mn<D>(0, ks), ks > 0);
      }
      wgmma_commit();
      bar_arrive(other, 2 * kWgThreads);
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      // P^T and dS^T, packed as A fragments as they are made; a masked pair
      // gets exp2(-inf) = 0, with no branch; the segment variant only with
      // segments (keys past kv_lim are whole rows here)
      uint32_t pa[4][4], da[4][4];
      auto elementwise = [&](bool masked) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + 2 * t4 + (e & 1);
            float x = sT[4 * nt + e] - s_l[col] + key_bias[e >> 1];
            if (masked && s_ids[col] < segk[e >> 1]) x = -INFINITY;
            const float pv = exp2_approx(x);  // 0 where masked
            dpT[4 * nt + e] = pv * (dpT[4 * nt + e] - s_dl[col]) * p.scale;  // dS^T
            sT[4 * nt + e] = pv;
          }
          pack_tile(pa[nt / 2], nt & 1, sT + 4 * nt);
          pack_tile(da[nt / 2], nt & 1, dpT + 4 * nt);
        }
      };
      if (use_seg) {
        elementwise(true);
      } else {
        elementwise(false);
      }
      const uint64_t t_do = opaque(desc_k<D>(st + 2 * kTokBytes, 0));  // D x 64 queries, K-major
      const uint64_t t_qu = opaque(desc_mn<kTile>(st + kTokBytes));
      bar_sync(mine, 2 * kWgThreads);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {  // dV += P^T dO, dK += dS^T Q_u
        wgmma_rs<D, 0>(dv, pa[kk], t_do + step_k<D>(kk), 1);
        wgmma_rs<D, 1>(dk, da[kk], t_qu + step_mn<kTile>(0, kk), 1);
      }
      wgmma_commit();
      if (wg == 0 || it + 1 < n_steps) bar_arrive(other, 2 * kWgThreads);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  bar_sync(5, 2 * kWgThreads);  // both consumers are done with the ring
  float* s_f = reinterpret_cast<float*>(smem) + wg * 2 * D * kF;
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  write_dn<D>(p.dk + bh * D * p.M, s_f, dk, cos_t, sin_t, p.t_d, p.t_n, k0 + rbase, p.M, 3 + wg);
  write_dn<D>(p.dv + bh * D * p.M, s_f + D * kF, dv, nullptr, nullptr, 0, 0, k0 + rbase, p.M,
              3 + wg);
}

// dq for 128 queries of one (b, h), looping over 64-key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dn_dq_kernel(const __grid_constant__ BwdParams p) {
  constexpr int kSteps = D / 16, kDn = dn_tile_bytes<D>(), kStage = dq_stage_bytes<D>();
  static_assert(2 * D * kF * 4 <= 2 * kTokBytes + 2 * kDn + kStages * kStage, "the epilogue fits");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* s_qs = smem;                  // 128 queries token-major
  unsigned char* s_do = s_qs + 2 * kTokBytes;  // two DN tiles of 64 queries
  unsigned char* stages = s_do + 2 * kDn;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQBlock;
  const long long bh = (long long)b * p.H + h;
  const int n_kt = (p.kv_lim + kTile - 1) / kTile;  // tiles past kv_lim are all masked
  const bool use_seg = p.seg != nullptr;
  const int* seg = use_seg ? p.seg + b * p.seg_b : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], use_seg ? 1 + 32 : 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 2 * kWgThreads + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * kTokBytes + 2 * kDn);
        tma_load(s_qs, &p.tm_qs, 0, q0, h, b, q_full);
        tma_load(s_qs + kTokBytes, &p.tm_qs, 0, q0 + kTile, h, b, q_full);
        tma_load(s_do, &p.tm_do, q0, 0, h, b, q_full);
        tma_load(s_do + kDn, &p.tm_do, q0 + kTile, 0, h, b, q_full);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, k0 = kt * kTile;
        unsigned char* st = stages + s * kStage;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], kTokBytes + kDn);
          tma_load(st, &p.tm_kr, 0, k0, h, b, &full[s]);
          tma_load(st + kTokBytes, &p.tm_v, k0, 0, h, b, &full[s]);
        }
        if (use_seg) {
          int* ids = reinterpret_cast<int*>(st + kTokBytes + kDn);
          for (int i = lane; i < kTile; i += 32) ids[i] = k0 + i < p.M ? seg[k0 + i] : 0;
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int t = threadIdx.x % kWgThreads, lane = t & 31, t4 = lane & 3;
  const int rbase = wg * 64;
  int segq[2] = {0, 0};
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qry = q0 + rbase + (t >> 5) * 16 + (lane >> 2) + 8 * r;  // < Np: the scratch is padded
    l2[r] = p.lse2[bh * p.Np + qry];
    dl[r] = p.delta[bh * p.Np + qry];
    if (use_seg && qry < p.N) segq[r] = seg[qry];
  }
  float dq[D / 2];  // 64 queries x D features
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  // ping-pong as in the dK/dV kernel
  const int mine = 1 + wg, other = 1 + (wg ^ 1);
  mbar_wait(q_full, 0);
  if (wg == 1) bar_arrive(other, 2 * kWgThreads);  // warpgroup 0 takes the first turn
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages, k0 = kt * kTile;
    const unsigned char* st = stages + s * kStage;
    const int* s_ids = reinterpret_cast<const int*>(st + kTokBytes + kDn);
    mbar_wait(&full[s], (kt / kStages) & 1);

    const uint64_t d_qs = opaque(desc_k<kQBlock>(s_qs, rbase));
    const uint64_t d_do = opaque(desc_mn<D>(s_do + wg * kDn));  // 64 queries x D, MN-major
    const uint64_t d_k = opaque(desc_k<kTile>(st, 0));
    const uint64_t d_v = opaque(desc_mn<D>(st + kTokBytes));     // 64 keys x D, MN-major
    float sc[32], dp[32];  // S and dP, 64 queries x 64 keys
    bar_sync(mine, 2 * kWgThreads);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {  // S = Q_s K_rot^T, base-2 units
      wgmma_ss<64>(sc, d_qs + step_k<kQBlock>(ks), d_k + step_k<kTile>(ks), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {  // dP = dO V^T
      wgmma_ss_mn64(dp, d_do + step_mn<D>(0, ks), d_v + step_mn<D>(0, ks), ks > 0);
    }
    wgmma_commit();
    bar_arrive(other, 2 * kWgThreads);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // dS, packed as A fragments as it is made; a masked pair gets exp2(-inf)
    // = 0, with no branch; the masked variant only for a tile a mask can
    // touch
    uint32_t da[4][4];
    auto elementwise = [&](bool masked) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = nt * 8 + 2 * t4 + (e & 1), r = e >> 1;
          float x = sc[4 * nt + e] - l2[r];
          if (masked && (k0 + kl >= p.kv_lim || (use_seg && segq[r] < s_ids[kl]))) x = -INFINITY;
          const float pv = exp2_approx(x);  // 0 where masked
          dp[4 * nt + e] = pv * (dp[4 * nt + e] - dl[r]) * p.scale;  // dS
        }
        pack_tile(da[nt / 2], nt & 1, dp + 4 * nt);
      }
    };
    if (use_seg || k0 + kTile > p.kv_lim) {
      elementwise(true);
    } else {
      elementwise(false);
    }
    const uint64_t t_k = opaque(desc_mn<kTile>(st));
    bar_sync(mine, 2 * kWgThreads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // dQ += dS K_rot
      wgmma_rs<D, 1>(dq, da[kk], t_k + step_mn<kTile>(0, kk), 1);
    }
    wgmma_commit();
    if (wg == 0 || kt + 1 < n_kt) bar_arrive(other, 2 * kWgThreads);
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  bar_sync(5, 2 * kWgThreads);  // both consumers are done with the ring
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  write_dn<D>(p.dq + bh * D * p.N, reinterpret_cast<float*>(smem) + wg * D * kF, dq, cos_t,
              sin_t, p.t_d, p.t_n, q0 + rbase, p.N, 3 + wg);
}

template <int D>
cudaError_t launch(const PrologueParams& pro, const BwdParams& p, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem<flash_bwd_dn_dkdv_kernel<D>>(dkdv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  err = allow_smem<flash_bwd_dn_dq_kernel<D>>(dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int longest = p.Np > p.M ? p.Np : p.M;
  dn_bwd_prologue_kernel<D><<<dim3((longest + kRows - 1) / kRows, p.H, B), kPrologueThreads, 0,
                              stream>>>(pro);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dn_dkdv_kernel<D><<<dim3((p.M + kKeyBlock - 1) / kKeyBlock, p.H, B), kThreads,
                                dkdv_smem_bytes<D>(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dn_dq_kernel<D><<<dim3(p.Np / kQBlock, p.H, B), kThreads, dq_smem_bytes<D>(),
                              stream>>>(p);
  return cudaGetLastError();
}

// `load_tile`'s 16-byte paths for an operand: along d (1) or along n (2).
int vec_bits(const void* ptr, const Str& s) {
  if (!aligned16(ptr) || s.h % 8 != 0 || s.b % 8 != 0) return 0;
  if (s.d == 1 && s.n % 8 == 0) return 1;
  return s.n == 1 && s.d % 8 == 0 ? 2 : 0;
}

}  // namespace

// strides: 24 element strides, in order
//   q (b, h, d, n), k (b, h, d, n), v (b, h, d, n), out (b, h, d, n),
//   do (b, h, d, n), RoPE tables (b, d, n), segment ids (b).
// cos/sin null: no RoPE. seg null: no segment mask (else N == M). lse is
// [B, H, N] contiguous; dq [B, H, D, N], dk and dv [B, H, D, M] are written
// contiguous. Scratch, each 16-byte aligned: qs and qu [B, H, N, D] bf16, kr
// [B, H, M, D] bf16, delta and lse2 [B, H, Np] fp32 with Np = N rounded up
// to 128. v_copy null: TMA reads v in place, and kNotTmaReady is returned,
// launching nothing, when it cannot (unit stride along N, other strides
// multiples of 8, a 16-byte aligned base); else [B, H, D, M rounded up to 8]
// bf16, into which the prologue copies v. do_copy likewise for do, with N.
// qscale: scale*log2(e) exactly as B1 received it, so q rounds the same.
// Returns the cudaError_t of the launches (0 on success);
// cudaErrorInvalidValue, launching nothing, for arguments it does not take.
extern "C" int vjepa2_flash_bwd_dn_bf16(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, const void* cos_t, const void* sin_t, const void* seg, void* dq, void* dk,
    void* dv, void* qs, void* qu, void* kr, void* delta, void* lse2, void* v_copy,
    void* do_copy, int B, int H, int D, int N, int M, int kv_lim, const long long* strides,
    float scale, float qscale, void* stream) {
  if (N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M || (seg != nullptr && N != M) ||
      (cos_t != nullptr && N != M) || !aligned16(qs) || !aligned16(qu) || !aligned16(kr) ||
      !aligned16(delta) || !aligned16(lse2))
    return cudaErrorInvalidValue;
  auto str = [&](int i) {  // (b, h, d, n) here, (b, h, n, d) in Str
    return Str{strides[i], strides[i + 1], strides[i + 3], strides[i + 2]};
  };
  PrologueParams pro;
  pro.sq = str(0);
  pro.sk = str(4);
  pro.sv = str(8);
  pro.so = str(12);
  pro.sdo = str(16);
  const int Mr = (M + 7) / 8 * 8, Nr = (N + 7) / 8 * 8;
  // v and do as maps whose inner dim is the tokens and whose rows are the
  // features; a copy buffer has rows of Mr (Nr) tokens
  auto dn = [&](const void* x, const Str& s, void* copy, int len, int padded) {
    return copy != nullptr ? operand(copy, padded, (long long)D * padded,
                                     (long long)H * D * padded, len, D, H, B)
                           : operand(x, s.d, s.h, s.b, len, D, H, B);
  };
  const Operand o_v = dn(v, pro.sv, v_copy, M, Mr), o_do = dn(dout, pro.sdo, do_copy, N, Nr);
  if ((v_copy == nullptr && (pro.sv.n != 1 || !tma_ok(o_v))) ||
      (do_copy == nullptr && (pro.sdo.n != 1 || !tma_ok(o_do))))
    return kNotTmaReady;

  const int Np = (N + kQBlock - 1) / kQBlock * kQBlock;
  pro.q = static_cast<const bf16*>(q);
  pro.k = static_cast<const bf16*>(k);
  pro.v = static_cast<const bf16*>(v);
  pro.o = static_cast<const bf16*>(out);
  pro.dout = static_cast<const bf16*>(dout);
  pro.lse = static_cast<const float*>(lse);
  pro.cos = static_cast<const float*>(cos_t);
  pro.sin = static_cast<const float*>(sin_t);
  pro.t_b = strides[20];
  pro.t_d = strides[21];
  pro.t_n = strides[22];
  pro.qs = static_cast<bf16*>(qs);
  pro.qu = static_cast<bf16*>(qu);
  pro.kr = static_cast<bf16*>(kr);
  pro.delta = static_cast<float*>(delta);
  pro.lse2 = static_cast<float*>(lse2);
  pro.v_copy = static_cast<bf16*>(v_copy);
  pro.do_copy = static_cast<bf16*>(do_copy);
  pro.H = H;
  pro.N = N;
  pro.M = M;
  pro.Np = Np;
  pro.Mr = Mr;
  pro.Nr = Nr;
  pro.qscale = qscale;
  pro.vec = vec_bits(q, pro.sq) | vec_bits(k, pro.sk) << 2 | vec_bits(v, pro.sv) << 4 |
            vec_bits(out, pro.so) << 6 | vec_bits(dout, pro.sdo) << 8;

  BwdParams p;
  auto packed = [&](const void* x, int n) {
    return operand(x, D, (long long)n * D, (long long)H * n * D, D, n, H, B);
  };
  if (!encode(&p.tm_qs, packed(qs, N), D, N, H, B, kTile) ||
      !encode(&p.tm_qu, packed(qu, N), D, N, H, B, kTile) ||
      !encode(&p.tm_kr, packed(kr, M), D, M, H, B, kTile) ||
      !encode(&p.tm_v, o_v, M, D, H, B, D) || !encode(&p.tm_do, o_do, N, D, H, B, D))
    return cudaErrorInvalidValue;
  p.lse2 = pro.lse2;
  p.delta = pro.delta;
  p.cos = pro.cos;
  p.sin = pro.sin;
  p.t_b = pro.t_b;
  p.t_d = pro.t_d;
  p.t_n = pro.t_n;
  p.seg = static_cast<const int*>(seg);
  p.seg_b = strides[23];
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.H = H;
  p.N = N;
  p.M = M;
  p.Np = Np;
  p.kv_lim = kv_lim;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(pro, p, B, s);
    case 32: return launch<32>(pro, p, B, s);
    case 48: return launch<48>(pro, p, B, s);
    case 64: return launch<64>(pro, p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
