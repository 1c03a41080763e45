// B2's (`flash_bwd_dn.cu`, head widths 16-64 over [B, H, D, N]) prologue,
// params and tile movers, on mma.sync and cp.async. B2 is the
// FlashAttention-2 backward in three launches, and the first is this file's
// prologue (the B4/B5 backward, `flash_bwd_bhnd.cu`, has its own on
// `bhnd_hopper.cuh`):
//   * `bwd_prologue` reads q, k, v, out and do at any element strides,
//     rotates and rounds q and k as the forwards do
//     (`dn_common.cuh:rope_pair`, `round_scaled`), computes delta =
//     rowsum(do * out) and lse*log2(e), and writes every operand into
//     scratch in the layout the main kernels' mma.sync fragments want:
//     token-major q_s, do, k_rot, v and feature-major q_u, do, k_rot, zero
//     past N or M (whole 64-token tiles) and past D (up to Dp, a whole mma
//     k-step);
//   * the main kernels' tile movers (cp.async, 16 bytes a thread) and the
//     dV / dK / dQ product over a packed P or dS tile.
// The dK/dV and dQ kernels stay in `flash_bwd_dn.cu`, which keeps its k, v,
// q and do fragments in registers and applies the RoPE adjoint there.

#pragma once

#include "dn_common.cuh"

namespace {

constexpr int kTile = 64;              // queries (dq) or keys (dk/dv) per block, and per loop step
constexpr int kWarps = kTile / 16;     // one warp per 16 rows
constexpr int kThreads = kWarps * 32;  // 128
constexpr int kPrologueThreads = 256;

struct Strides {
  long long b, h, n, d;
};

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;   // [B, H, N]
  const float* cos;   // null: no RoPE; [B|1] tables fp32, strides t_b, t_n, t_d
  const float* sin;
  const int* seg_q;   // null: no segment mask; [B|1, N] int32
  const int* seg_k;   // [B|1, M]
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, so, sdo;
  long long t_b, t_n, t_d, segq_b, segk_b;
  int H, N, M, Np, Mp, kv_lim, causal;  // Np, Mp: N, M rounded up to whole tiles
  int vec;        // bit i: 16-byte loads for q, k, v, out, do (i = 0..4)
  float qscale;   // scale * log2(e), the value the forward was given
  float scale;
  // scratch written by the prologue, zero past N or M and past D
  bf16* qs_tok;  // [B, H, Np, Dp]  bf16(rot(q) * qscale)
  bf16* do_tok;  // [B, H, Np, Dp]
  bf16* qu_dn;   // [B, H, Dp, Np]  bf16(rot(q))
  bf16* do_dn;   // [B, H, Dp, Np]
  float* delta;  // [B, H, Np]
  float* lse2;   // [B, H, Np]      lse * log2(e); +inf where p must be 0
  bf16* kr_tok;  // [B, H, Mp, Dp]  bf16(rot(k))
  bf16* v_tok;   // [B, H, Mp, Dp]
  bf16* kr_dn;   // [B, H, Dp, Mp]
};

// Rows [t0, t0 + kTile) of x (element strides s; tokens at or past lim read
// as 0) into dst[row][0, Dp), features D..Dp zero. Neighbouring threads read
// neighbouring addresses along whichever of n and d has unit stride; `vec`:
// 16 bytes a thread (unit stride along d, 16-byte aligned rows).
template <int D, int Dp>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* x, const Strides& s, int t0,
                                          int lim, bool vec) {
  constexpr int kStride = Dp + kPad;
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = i % kChunks, n = t0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n < lim) u = *reinterpret_cast<const uint4*>(x + n * s.n + c * 8);
      *reinterpret_cast<uint4*>(&dst[r * kStride + c * 8]) = u;
    }
  } else if (s.n == 1) {
    for (int i = threadIdx.x; i < D * kTile; i += blockDim.x) {
      const int d = i / kTile, r = i % kTile, n = t0 + r;
      dst[r * kStride + d] = n < lim ? x[d * s.d + n] : zero;
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
      const int r = i / D, d = i % D, n = t0 + r;
      dst[r * kStride + d] = n < lim ? x[n * s.n + d * s.d] : zero;
    }
  }
  if constexpr (Dp > D) {
    for (int i = threadIdx.x; i < kTile * (Dp - D); i += blockDim.x) {
      dst[(i / (Dp - D)) * kStride + D + i % (Dp - D)] = zero;
    }
  }
}

// dst = bf16(rot(src) * mul) over a [row][d] tile, pairs (d, d + D/2), tables
// at token t0 + r (no rotation when cos_t is null, or past lim where the rows
// are zero). dst may be src. Neighbouring threads take neighbouring tokens
// when the tables have unit stride along n, else neighbouring features.
template <int D, int Dp>
__device__ __forceinline__ void rotate_tile(bf16* dst, const bf16* src, const float* cos_t,
                                            const float* sin_t, const BwdParams& p, int t0,
                                            int lim, float mul) {
  constexpr int kHalf = D / 2, kStride = Dp + kPad;
  const bool along_n = p.t_n == 1;
  for (int i = threadIdx.x; i < kTile * kHalf; i += blockDim.x) {
    const int r = along_n ? i % kTile : i / kHalf;
    const int d = along_n ? i / kTile : i % kHalf;
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
  }
}

// src[token][d] (a whole tile) -> rows [t0, t0 + kTile) of a token-major
// [*, W] array, 16 bytes a thread.
template <int W>
__device__ __forceinline__ void store_tok(bf16* dst, const bf16* src, int t0) {
  constexpr int kChunks = W / 8, kStride = W + kPad;
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    *reinterpret_cast<uint4*>(dst + (long long)(t0 + r) * W + c * 8) =
        *reinterpret_cast<const uint4*>(&src[r * kStride + c * 8]);
  }
}

// src[token][d] (a whole tile) -> columns [t0, t0 + kTile) of a feature-major
// [W, len] array.
template <int W>
__device__ __forceinline__ void store_dn(bf16* dst, const bf16* src, int t0, int len) {
  constexpr int kStride = W + kPad;
  for (int i = threadIdx.x; i < W * kTile; i += blockDim.x) {
    const int d = i / kTile, r = i % kTile;
    dst[(long long)d * len + t0 + r] = src[r * kStride + d];
  }
}

// Prologue: one block of kPrologueThreads per (b, h, 64 tokens); the query
// side for tiles below Np, the key side for tiles below Mp. Each backward
// launches it through a kernel of its own name (`bwd_prologue_kernel`,
// `bhnd_bwd_prologue_kernel`), so a profile tells the two apart.
template <int D, int Dp>
__device__ __forceinline__ void bwd_prologue(const BwdParams& p) {
  constexpr int kStride = Dp + kPad;
  __shared__ __align__(16) bf16 s_a[kTile * kStride];
  __shared__ __align__(16) bf16 s_b[kTile * kStride];
  __shared__ __align__(16) bf16 s_c[kTile * kStride];
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kTile;
  const long long bh = (long long)b * p.H + h;
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;

  if (t0 < p.Np) {
    load_tile<D, Dp>(s_a, p.q + b * p.sq.b + h * p.sq.h, p.sq, t0, p.N, p.vec & 1);
    load_tile<D, Dp>(s_b, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo, t0, p.N, (p.vec >> 4) & 1);
    load_tile<D, Dp>(s_c, p.o + b * p.so.b + h * p.so.h, p.so, t0, p.N, (p.vec >> 3) & 1);
    __syncthreads();
    {  // delta = rowsum(do * out) in fp32: four threads per token
      const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
      float acc = 0.f;
      for (int d = part; d < D; d += 4) {
        acc += __bfloat162float(s_b[r * kStride + d]) * __bfloat162float(s_c[r * kStride + d]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) p.delta[bh * p.Np + t0 + r] = acc;
    }
    if (threadIdx.x < kTile) {
      const int n = t0 + threadIdx.x;
      float l2 = INFINITY;  // past N, or a row with no key: p = exp2(s - inf) = 0
      if (n < p.N) {
        const float l = p.lse[bh * p.N + n];
        if (l != -INFINITY) l2 = l * kLog2e;
      }
      p.lse2[bh * p.Np + n] = l2;
    }
    __syncthreads();  // s_c (out) is free
    rotate_tile<D, Dp>(s_c, s_a, cos_t, sin_t, p, t0, p.N, 1.f);      // q_u
    rotate_tile<D, Dp>(s_a, s_a, cos_t, sin_t, p, t0, p.N, p.qscale);  // q_s, in place
    __syncthreads();  // pad features stay zero: out's were, in s_c
    store_tok<Dp>(p.qs_tok + bh * p.Np * Dp, s_a, t0);
    store_tok<Dp>(p.do_tok + bh * p.Np * Dp, s_b, t0);
    store_dn<Dp>(p.qu_dn + bh * Dp * p.Np, s_c, t0, p.Np);
    store_dn<Dp>(p.do_dn + bh * Dp * p.Np, s_b, t0, p.Np);
    __syncthreads();
  }
  if (t0 < p.Mp) {
    load_tile<D, Dp>(s_a, p.k + b * p.sk.b + h * p.sk.h, p.sk, t0, p.M, (p.vec >> 1) & 1);
    load_tile<D, Dp>(s_b, p.v + b * p.sv.b + h * p.sv.h, p.sv, t0, p.M, (p.vec >> 2) & 1);
    __syncthreads();
    rotate_tile<D, Dp>(s_a, s_a, cos_t, sin_t, p, t0, p.M, 1.f);
    __syncthreads();
    store_tok<Dp>(p.kr_tok + bh * p.Mp * Dp, s_a, t0);
    store_tok<Dp>(p.v_tok + bh * p.Mp * Dp, s_b, t0);
    store_dn<Dp>(p.kr_dn + bh * Dp * p.Mp, s_a, t0, p.Mp);
  }
}

// Whole tile [t0, t0 + kTile) of a token-major [*, W] array into dst[row][d].
template <int W>
__device__ __forceinline__ void copy_tok_async(bf16* dst, const bf16* src, int t0) {
  constexpr int kChunks = W / 8, kStride = W + kPad;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(&dst[r * kStride + c * 8], src + (long long)(t0 + r) * W + c * 8, true);
  }
}

// Columns [t0, t0 + kTile) of a feature-major [W, len] array into dst[d][col].
template <int W>
__device__ __forceinline__ void copy_dn_async(bf16* dst, const bf16* src, int t0, int len) {
  constexpr int kChunks = kTile / 8, kTStride = kTile + kPad;
  for (int i = threadIdx.x; i < W * kChunks; i += kThreads) {
    const int d = i / kChunks, c = i % kChunks;
    cp_async16(&dst[d * kTStride + c * 8], src + (long long)d * len + t0 + c * 8, true);
  }
}

// acc[dt] += P (16 rows x kTile, as packed A fragments) times T, T held as a
// [d][col] tile: 16 rows x W.
template <int W>
__device__ __forceinline__ void packed_times_dn(float (&acc)[W / 8][4],
                                                const uint32_t (&pf)[kTile / 16][4],
                                                const bf16* s) {
  constexpr int kTStride = kTile + kPad;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
    for (int dt = 0; dt < W / 8; ++dt) {
      const bf16* r = &s[(dt * 8 + g) * kTStride + kk * 16 + 2 * t4];
      mma_bf16(acc[dt], pf[kk], ld_smem_u32(r), ld_smem_u32(r + 8));
    }
  }
}

constexpr int round_up(int x) { return (x + kTile - 1) / kTile * kTile; }

// Scratch layout, in the order of the BwdParams fields; every piece a
// multiple of 256 bytes.
long long carve(BwdParams* p, char* base, int B, int H, int Dp, int N, int M) {
  const long long bh = (long long)B * H, Np = round_up(N), Mp = round_up(M);
  long long off = 0;
  auto take = [&](long long bytes) {
    char* ptr = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) / 256 * 256;
    return ptr;
  };
  bf16* qs_tok = reinterpret_cast<bf16*>(take(bh * Np * Dp * 2));
  bf16* do_tok = reinterpret_cast<bf16*>(take(bh * Np * Dp * 2));
  bf16* qu_dn = reinterpret_cast<bf16*>(take(bh * Np * Dp * 2));
  bf16* do_dn = reinterpret_cast<bf16*>(take(bh * Np * Dp * 2));
  float* delta = reinterpret_cast<float*>(take(bh * Np * 4));
  float* lse2 = reinterpret_cast<float*>(take(bh * Np * 4));
  bf16* kr_tok = reinterpret_cast<bf16*>(take(bh * Mp * Dp * 2));
  bf16* v_tok = reinterpret_cast<bf16*>(take(bh * Mp * Dp * 2));
  bf16* kr_dn = reinterpret_cast<bf16*>(take(bh * Mp * Dp * 2));
  if (p != nullptr) {
    p->qs_tok = qs_tok;
    p->do_tok = do_tok;
    p->qu_dn = qu_dn;
    p->do_dn = do_dn;
    p->delta = delta;
    p->lse2 = lse2;
    p->kr_tok = kr_tok;
    p->v_tok = v_tok;
    p->kr_dn = kr_dn;
  }
  return off;
}

bool vec_ok(const void* ptr, const Strides& s) {
  return s.d == 1 && s.n % 8 == 0 && s.h % 8 == 0 && s.b % 8 == 0 && aligned16(ptr);
}

// The fields both entry points set alike: operands, outputs, sizes, scales,
// and the 16-byte-load bits (the strides must be set first).
void set_common(BwdParams& p, const void* q, const void* k, const void* v, const void* out,
                const void* dout, const void* lse, const void* cos_t, const void* sin_t,
                void* dq, void* dk, void* dv, int H, int N, int M, int kv_lim, float scale,
                float qscale) {
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.cos = static_cast<const float*>(cos_t);
  p.sin = static_cast<const float*>(sin_t);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.H = H;
  p.N = N;
  p.M = M;
  p.Np = round_up(N);
  p.Mp = round_up(M);
  p.kv_lim = kv_lim;
  p.scale = scale;
  p.qscale = qscale;
  p.vec = (vec_ok(q, p.sq) ? 1 : 0) | (vec_ok(k, p.sk) ? 2 : 0) | (vec_ok(v, p.sv) ? 4 : 0) |
          (vec_ok(out, p.so) ? 8 : 0) | (vec_ok(dout, p.sdo) ? 16 : 0);
}

}  // namespace
