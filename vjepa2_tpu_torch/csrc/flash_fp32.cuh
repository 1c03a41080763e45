// Flash attention over fp32 [B, H, N, D] ("BHND") operands, for Hopper (sm_90a),
// in full fp32 on the CUDA cores (FFMA; no TF32, no tensor cores).
//
// Replaces the TPU kernels of the BHND family on fp32 operands, which JAX
// runs in the storage dtype (`vjepa2_tpu/ops/flash_attention.py:202`; the
// frozen evals' attentive probes send them fp32 q, k, v):
//   * the forward `vjepa2_tpu/ops/flash_attention.py:166 _fwd_kernel` (B3,
//     `pallas_call` `:307`);
//   * the backwards `:511 _bwd_fused_kernel` (B4) and `:361 _dq_kernel` /
//     `:434 _dkv_kernel` (B5), one function, as `flash_bwd_bhnd.cu` is for
//     bf16.
// The bf16 operands take `flash_fwd_bhnd.cu` and `flash_bwd_bhnd.cu`.
// Contract (the probes' attention: no RoPE, no segments, no kv_valid, no
// causal mask; the wrapper refuses those on fp32):
//   * q [B, H, N, D], k and v [B, H, M, D] fp32, unit stride along d, every
//     other stride a multiple of 4 elements from a 16-byte aligned base (the
//     wrapper copies any other operand first); D in {32, 64, 80, 88, 104};
//   * forward: s = (q . k) * scale * log2(e) in fp32, an online softmax in
//     base 2 (`exp2f`, the accurate one), out = sum_j p_j v_j / sum_j p_j in
//     the layout its strides give (unit stride along d), lse [B, H, N] in
//     natural log; the kernel masks its own ragged edge, so N and M need no
//     padding;
//   * backward, given out, dout and an lse: delta = rowsum(dout * out);
//     p = exp2(s - lse * log2(e)) (0 where lse is -inf); dv = p^T dout;
//     dp = dout v^T; ds = p (dp - delta) scale; dk = ds^T q; dq = ds k;
//     dq, dk, dv written contiguous [B, H, N|M, D].
//
// What bounds it on this card: 4*D FLOPs a score forward and 10*D backward
// (14*D as computed: the dQ pass recomputes S and dP), all FFMA, against
// O(N*D) bytes: the operations, at 67 TFLOP/s of fp32 outside the tensor
// cores.
//
// Layout: this header holds the kernels; `flash_fp32_fwd.cu`,
// `flash_fp32_dq.cu` and `flash_fp32_dkdv.cu` are their build units and C
// entry points, one kernel each, so that nvcc compiles them in parallel
// (57 s as one unit on the H100 host, against at most 14 s for any other
// source).
//
// Design: a simple register-tiled kernel, a later redesign's starting point.
//   * 128 threads a block as a 16 x 8 grid (thread (ty, tx), ty = tid / 8):
//     64 rows stay resident in shared memory (queries in the forward and
//     dQ, keys in dK/dV) and 32-row tiles of the other side stream through
//     a two-stage `cp.async` ring; a thread owns rows ty + 16 i and
//     streamed rows tx + 8 j (i, j < 4) of each 64 x 32 score tile, and
//     columns 32 c + 4 tx .. + 3 of each 64 x D product;
//   * shared rows have a stride of 4 mod 8 floats, so the float4 reads of a
//     warp (4 resident rows, 8 streamed rows, or 8 consecutive chunks of one
//     row) each take one wavefront: per 4 features 8 LDS.128 feed 64 FFMA;
//   * scores stay in registers for the softmax (row maxima over the 8
//     threads of a row by shuffles, row sums per thread until the end), then
//     pass through a 64 x 32 shared buffer as the left operand of P V,
//     dS K, P^T dO and dS^T Q;
//   * the dQ kernel (one block a 64-query tile, looping over key tiles)
//     first writes delta for its rows, which the dK/dV kernel (one block a
//     64-key tile, looping over query tiles), launched after it on the same
//     stream, reads. No atomics: two calls give equal bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // thread (ty, tx) = (tid / 8, tid % 8)
constexpr int kRows = 64;       // resident rows a block
constexpr int kTile = 32;       // rows of a streamed tile
constexpr int kPS = kTile + 4;  // row stride of the [kRows][kTile] score buffer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Shape {
  static_assert(D % 4 == 0, "rows are copied and read as float4");
  static constexpr int kChunks = (D + 31) / 32;  // 32-column chunks, 4 columns a thread
  static constexpr int kStride = 32 * kChunks + 4;  // shared row stride: 4 mod 8 floats
  static constexpr int kVec = D / 4;              // float4 a row
};

struct Operand {  // one [B, H, N, D] operand, unit stride along d
  const float* p;
  long long b, h, n;
  __device__ const float* slice(int bi, int hi) const { return p + bi * b + hi * h; }
};

struct FwdParams {
  Operand q, k, v;
  float* o;
  long long o_b, o_h, o_n;
  float* lse;
  int H, N, M;
  float qscale;  // scale * log2(e)
};

struct BwdParams {
  Operand q, k, v, o, dout;
  const float* lse;
  float* delta;  // [B, H, N]: written by the dQ kernel, read by dK/dV
  float *dq, *dk, *dv;
  int H, N, M;
  float scale, qscale;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows [row0, row0 + kN) of one (b, h) slice into dst ([kN][kStride]); rows
// at or past n_rows are zero-filled. Columns past D are left as they are:
// they only feed accumulator columns that are never stored.
template <int D, int kN>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long sn, int row0,
                                          int n_rows) {
  constexpr int kVec = Shape<D>::kVec;
  for (int i = threadIdx.x; i < kN * kVec; i += kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * Shape<D>::kStride + 4 * c, ok ? src + (row0 + r) * sn + 4 * c : src, ok);
  }
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float lane_of(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float row_max(float x) {  // over the 8 threads of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// acc[i][j] += a[ty + 16 i] . b[tx + 8 j] over the D features: a is
// [kRows][kStride], b [kTile][kStride].
template <int D>
__device__ __forceinline__ void scores(float (&acc)[4][4], const float* a, const float* b, int ty,
                                       int tx) {
  constexpr int kS = Shape<D>::kStride;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 8 * j) * kS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(acc[i][j], x[i], y[j]);
  }
}

// acc[i][c] += sum_r w[ty + 16 i][r] * m[r][32 c + 4 tx .. + 3] over the
// kTile streamed rows: w is the [kRows][kPS] score buffer, m [kTile][kStride].
template <int D>
__device__ __forceinline__ void accumulate(float4 (&acc)[4][Shape<D>::kChunks], const float* w,
                                           const float* m, int ty, int tx) {
  constexpr int kS = Shape<D>::kStride;
#pragma unroll
  for (int r = 0; r < kTile; r += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * kPS + r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < Shape<D>::kChunks; ++c) {
        const float4 y = *reinterpret_cast<const float4*>(m + (r + u) * kS + 32 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) axpy4(acc[i][c], lane_of(x[i], u), y);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float4 (&acc)[4][Shape<D>::kChunks]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Shape<D>::kChunks; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Rows ty + 16 i of acc, columns below D, to dst + row * row_stride.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long row_stride, int row0, int n_rows,
                                           const float4 (&acc)[4][Shape<D>::kChunks], int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < Shape<D>::kChunks; ++c) {
      const int col = 32 * c + 4 * tx;
      if (col < D) *reinterpret_cast<float4*>(dst + row * row_stride + col) = acc[i][c];
    }
  }
}

template <int D>
constexpr int fwd_smem_floats() {
  return (kRows + 4 * kTile) * Shape<D>::kStride + kRows * kPS;
}

template <int D>
constexpr int bwd_smem_floats() {
  return (2 * kRows + 4 * kTile) * Shape<D>::kStride + kRows * kPS + 2 * kRows;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fp32_fwd_kernel(const FwdParams p) {
  using S = Shape<D>;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][kStride]
  float* sk = sq + kRows * S::kStride;           // [2][kTile][kStride]
  float* sv = sk + 2 * kTile * S::kStride;       // [2][kTile][kStride]
  float* sp = sv + 2 * kTile * S::kStride;       // [kRows][kPS]
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kRows;
  const float* k = p.k.slice(b, h);
  const float* v = p.v.slice(b, h);
  load_rows<D, kRows>(sq, p.q.slice(b, h), p.q.n, q0, p.N);
  load_rows<D, kTile>(sk, k, p.k.n, 0, p.M);
  load_rows<D, kTile>(sv, v, p.v.n, 0, p.M);
  cp_async_commit();

  float4 o[4][S::kChunks];
  zero<D>(o);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  const int tiles = (p.M + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_rows<D, kTile>(sk + (buf ^ 1) * kTile * S::kStride, k, p.k.n, (t + 1) * kTile, p.M);
      load_rows<D, kTile>(sv + (buf ^ 1) * kTile * S::kStride, v, p.v.n, (t + 1) * kTile, p.M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[4][4] = {};
    scores<D>(s, sq, sk + buf * kTile * S::kStride, ty, tx);
    const int key0 = t * kTile + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = key0 + 8 * j < p.M ? s[i][j] * p.qscale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2f(s[i][j] - base);
        sp[(ty + 16 * i) * kPS + tx + 8 * j] = e;
        sum += e;
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
        o[i][c].x *= corr;
        o[i][c].y *= corr;
        o[i][c].z *= corr;
        o[i][c].w *= corr;
      }
    }
    __syncthreads();
    accumulate<D>(o, sp, sv + buf * kTile * S::kStride, ty, tx);
    __syncthreads();
  }

  float* out = p.o + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float total = row_sum(l[i]);
    const float denom = total == 0.f ? 1.f : total;
#pragma unroll
    for (int c = 0; c < S::kChunks; ++c) {
      o[i][c].x /= denom;
      o[i][c].y /= denom;
      o[i][c].z /= denom;
      o[i][c].w /= denom;
    }
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < p.N) p.lse[(long long)bh * p.N + row] = m[i] * kLn2 + logf(denom);
  }
  store_rows<D>(out, p.o_n, q0, p.N, o, ty, tx);
}

// One block a 64-query tile: delta for its rows, then dQ over the key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fp32_dq_kernel(const BwdParams p) {
  using S = Shape<D>;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][kStride]
  float* sdo = sq + kRows * S::kStride;          // [kRows][kStride]
  float* sk = sdo + kRows * S::kStride;          // [2][kTile][kStride]
  float* sv = sk + 2 * kTile * S::kStride;       // [2][kTile][kStride]
  float* sds = sv + 2 * kTile * S::kStride;      // [kRows][kPS]
  float* slse = sds + kRows * kPS;               // [kRows]: lse * log2(e), +inf for no row
  float* sdelta = slse + kRows;                  // [kRows]
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kRows;
  const float* k = p.k.slice(b, h);
  const float* v = p.v.slice(b, h);
  load_rows<D, kRows>(sq, p.q.slice(b, h), p.q.n, q0, p.N);
  load_rows<D, kRows>(sdo, p.dout.slice(b, h), p.dout.n, q0, p.N);
  load_rows<D, kTile>(sk, k, p.k.n, 0, p.M);
  load_rows<D, kTile>(sv, v, p.v.n, 0, p.M);
  cp_async_commit();

  // delta = rowsum(dout * out), a warp a row, read straight from memory
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* o = p.o.slice(b, h);
  const float* dout = p.dout.slice(b, h);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.N) {
      for (int d = lane; d < D; d += 32) acc = fmaf(o[row * p.o.n + d], dout[row * p.dout.n + d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sdelta[r] = acc;
      const float lse = row < p.N ? p.lse[(long long)bh * p.N + row] : -INFINITY;
      slse[r] = lse == -INFINITY ? INFINITY : lse * kLog2e;
      if (row < p.N) p.delta[(long long)bh * p.N + row] = acc;
    }
  }
  __syncthreads();
  float lse2[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lse2[i] = slse[ty + 16 * i], delta[i] = sdelta[ty + 16 * i];

  float4 dq[4][S::kChunks];
  zero<D>(dq);
  const int tiles = (p.M + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_rows<D, kTile>(sk + (buf ^ 1) * kTile * S::kStride, k, p.k.n, (t + 1) * kTile, p.M);
      load_rows<D, kTile>(sv + (buf ^ 1) * kTile * S::kStride, v, p.v.n, (t + 1) * kTile, p.M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = sk + buf * kTile * S::kStride;
    float s[4][4] = {}, dp[4][4] = {};
    scores<D>(s, sq, kt, ty, tx);
    scores<D>(dp, sdo, sv + buf * kTile * S::kStride, ty, tx);
    const int key0 = t * kTile + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = exp2f(key0 + 8 * j < p.M ? s[i][j] * p.qscale - lse2[i] : -INFINITY);
        sds[(ty + 16 * i) * kPS + tx + 8 * j] = pr * (dp[i][j] - delta[i]) * p.scale;
      }
    __syncthreads();
    accumulate<D>(dq, sds, kt, ty, tx);
    __syncthreads();
  }
  store_rows<D>(p.dq + (long long)bh * p.N * D, D, q0, p.N, dq, ty, tx);
}

// One block a 64-key tile: dV and dK over the query tiles (delta from the
// dQ kernel).
template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fp32_dkdv_kernel(const BwdParams p) {
  using S = Shape<D>;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // [kRows][kStride]
  float* sv = sk + kRows * S::kStride;           // [kRows][kStride]
  float* sq = sv + kRows * S::kStride;           // [2][kTile][kStride]
  float* sdo = sq + 2 * kTile * S::kStride;      // [2][kTile][kStride]
  float* sw = sdo + 2 * kTile * S::kStride;      // [kRows][kPS]: P^T, then dS^T
  float* slse = sw + kRows * kPS;                // [2][kTile]
  float* sdelta = slse + 2 * kTile;              // [2][kTile]
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.x * kRows;
  const float* q = p.q.slice(b, h);
  const float* dout = p.dout.slice(b, h);
  const float* lse = p.lse + (long long)bh * p.N;
  const float* delta = p.delta + (long long)bh * p.N;
  // lse * log2(e) and delta of query tile t into buffer t & 1 (+inf and 0
  // past the last query, so p and ds are 0 there)
  auto load_stats = [&](int t) {
    const int i = threadIdx.x;
    if (i < kTile) {
      const int row = t * kTile + i;
      const float l = row < p.N ? lse[row] : -INFINITY;
      slse[(t & 1) * kTile + i] = l == -INFINITY ? INFINITY : l * kLog2e;
      sdelta[(t & 1) * kTile + i] = row < p.N ? delta[row] : 0.f;
    }
  };
  load_rows<D, kRows>(sk, p.k.slice(b, h), p.k.n, k0, p.M);
  load_rows<D, kRows>(sv, p.v.slice(b, h), p.v.n, k0, p.M);
  load_rows<D, kTile>(sq, q, p.q.n, 0, p.N);
  load_rows<D, kTile>(sdo, dout, p.dout.n, 0, p.N);
  cp_async_commit();
  load_stats(0);

  float4 dk[4][S::kChunks], dv[4][S::kChunks];
  zero<D>(dk);
  zero<D>(dv);
  const int tiles = (p.N + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_rows<D, kTile>(sq + (buf ^ 1) * kTile * S::kStride, q, p.q.n, (t + 1) * kTile, p.N);
      load_rows<D, kTile>(sdo + (buf ^ 1) * kTile * S::kStride, dout, p.dout.n, (t + 1) * kTile,
                          p.N);
      cp_async_commit();
      load_stats(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = sq + buf * kTile * S::kStride;
    const float* dot = sdo + buf * kTile * S::kStride;
    const float* lse2 = slse + buf * kTile;
    const float* dlt = sdelta + buf * kTile;
    float st[4][4] = {}, dpt[4][4] = {}, ds[4][4];
    scores<D>(st, sk, qt, ty, tx);
    scores<D>(dpt, sv, dot, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 8 * j;
        const float pr = exp2f(st[i][j] * p.qscale - lse2[r]);
        sw[(ty + 16 * i) * kPS + r] = pr;
        ds[i][j] = pr * (dpt[i][j] - dlt[r]) * p.scale;
      }
    __syncthreads();
    accumulate<D>(dv, sw, dot, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sw[(ty + 16 * i) * kPS + tx + 8 * j] = ds[i][j];
    __syncthreads();
    accumulate<D>(dk, sw, qt, ty, tx);
    __syncthreads();
  }
  store_rows<D>(p.dk + (long long)bh * p.M * D, D, k0, p.M, dk, ty, tx);
  store_rows<D>(p.dv + (long long)bh * p.M * D, D, k0, p.M, dv, ty, tx);
}

// Lets `Kernel` take `bytes` of dynamic shared memory, once per device.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <auto Kernel, class Params>
cudaError_t launch(const Params& p, int blocks, int bh, int floats, cudaStream_t stream) {
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem<Kernel>(bytes);
  if (err != cudaSuccess) return err;
  Kernel<<<dim3(blocks, bh), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const FwdParams& p, int B, cudaStream_t s) {
  return launch<flash_fp32_fwd_kernel<D>>(p, (p.N + kRows - 1) / kRows, B * p.H,
                                          fwd_smem_floats<D>(), s);
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t s) {
  return launch<flash_fp32_dq_kernel<D>>(p, (p.N + kRows - 1) / kRows, B * p.H,
                                         bwd_smem_floats<D>(), s);
}

template <int D>
cudaError_t launch_dkdv(const BwdParams& p, int B, cudaStream_t s) {
  return launch<flash_fp32_dkdv_kernel<D>>(p, (p.M + kRows - 1) / kRows, B * p.H,
                                           bwd_smem_floats<D>(), s);
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// An operand from its (b, h, n, d) strides: unit stride along d, the others
// multiples of 4 (a dim of length 1 may have any stride), a 16-byte aligned base.
inline bool make_operand(Operand* o, const void* ptr, const long long* st, int B, int H, int n) {
  *o = Operand{static_cast<const float*>(ptr), st[0], st[1], st[2]};
  return ptr != nullptr && aligned16(ptr) && st[3] == 1 && (B == 1 || st[0] % 4 == 0) &&
         (H == 1 || st[1] % 4 == 0) && (n == 1 || st[2] % 4 == 0);
}

template <class Params, class Fn>
int dispatch(int D, const Params& p, int B, cudaStream_t s, Fn) {
  switch (D) {
    case 32: return Fn::template run<32>(p, B, s);
    case 64: return Fn::template run<64>(p, B, s);
    case 80: return Fn::template run<80>(p, B, s);
    case 88: return Fn::template run<88>(p, B, s);
    case 104: return Fn::template run<104>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

struct RunFwd {
  template <int D>
  static int run(const FwdParams& p, int B, cudaStream_t s) { return launch_fwd<D>(p, B, s); }
};

struct RunDq {
  template <int D>
  static int run(const BwdParams& p, int B, cudaStream_t s) { return launch_dq<D>(p, B, s); }
};

struct RunDkdv {
  template <int D>
  static int run(const BwdParams& p, int B, cudaStream_t s) { return launch_dkdv<D>(p, B, s); }
};

// The backward's parameters from an entry point's arguments (both launches
// take the same); false if an operand breaks the contract.
inline bool bwd_params(BwdParams* p, const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                       void* dv, int B, int H, int N, int M, const long long* strides,
                       float scale, float qscale) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B * H > 65535 || lse == nullptr ||
      delta == nullptr || !aligned16(dq) || !aligned16(dk) || !aligned16(dv) ||
      !make_operand(&p->q, q, strides, B, H, N) || !make_operand(&p->k, k, strides + 4, B, H, M) ||
      !make_operand(&p->v, v, strides + 8, B, H, M) ||
      !make_operand(&p->o, out, strides + 12, B, H, N) ||
      !make_operand(&p->dout, dout, strides + 16, B, H, N))
    return false;
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<float*>(delta);
  p->dq = static_cast<float*>(dq);
  p->dk = static_cast<float*>(dk);
  p->dv = static_cast<float*>(dv);
  p->H = H;
  p->N = N;
  p->M = M;
  p->scale = scale;
  p->qscale = qscale;
  return true;
}

}  // namespace
