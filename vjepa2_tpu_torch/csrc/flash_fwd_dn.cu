// Flash-attention forward over [B, H, D, N] ("DN") operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vjepa2_tpu/ops/flash_attention_dn.py:129 _fwd_kernel_dn`
// (wrapper `_flash_fwd_bhdn:198`). Same contract:
//   * q, k, v bf16 [B, H, D, N] (any element strides; the wrapper passes them),
//     D in {16, 32, 48, 64};
//   * split-half RoPE on q and k in fp32 inside the kernel (pairs d and d + D/2),
//     tables fp32 with strides (batch, d, n), batch stride 0 when shared;
//     q takes scale*log2(e) before it is rounded to bf16, k is rounded after the
//     rotation, as the TPU kernel does (`:156-164`);
//   * online softmax in base 2 with fp32 statistics and fp32 accumulation;
//   * optional segment mask, attend iff seg_q >= seg_k, compared as int32;
//   * keys at or beyond `kv_lim` (the static kv_valid, or M) are masked; the
//     kernel masks its own ragged edge, so N and M need no padding;
//   * out in the layout given by its strides, lse [B, H, N] fp32 natural log;
//     a fully masked row gives denominator 1, output 0 and lse -inf.
//
// What bounds it on this card: per score element the tensor cores do 4*Dh
// FLOPs (QK^T and PV, 256 at Dh 64) while the softmax costs about 10 scalar
// operations (mask, max, subtract, exp2, sum, scale, convert). At H100 rates
// (989 TFLOP/s bf16 dense against ~67 TFLOP/s fp32 scalar) the scalar work
// takes longer than the products, so the kernel is bound by issue and
// latency on the CUDA cores, not by the tensor cores or by memory. RoPE adds
// scalar work of its own: done inside the attention loop it would rotate
// every k tile once per query tile (N/128 times per head), reading fp32
// cos/sin for every key each time.
//
// What this version does about it: B1 is two launches. A prologue
// (`rope_pack_kernel`) rotates q and k once, folds scale*log2(e) into q and
// writes both, rounded to bf16, token-major ([B, H, N, D]) into scratch the
// wrapper allocates; so no query block re-rotates k or reads a RoPE table.
// The main kernel (`flash_fwd_dn_kernel`, its loop `flash_fwd_common.cuh`'s,
// shared with B3) is then a FlashAttention-2 forward:
// the scores never leave registers (mma.sync m16n8k16 accumulators are
// re-packed as the A operand of P.V), the softmax is one exp2 (ex2.approx)
// per score, the row statistics are reduced across the four threads of a
// quad with two shuffles per tile and the normalisation waits for the
// epilogue, 128 queries share each k/v tile, and the next k/v tile is copied
// to shared memory (cp.async, 16 bytes a thread) while this one is computed.
// Where the operands allow it (unit stride along N, N and M multiples of 8,
// 16-byte aligned rows) every other global access is a 16-byte vector too.
// Not done yet, for later work: wgmma, TMA, warp specialisation.
//
// Layout of one main block: 128 queries of one (b, h), 8 warps of 16 query
// rows. q and k tiles sit in shared memory as bf16 [token][d], v as
// [d][key], so that every mma fragment is one 32-bit shared-memory load.

#include "flash_fwd_common.cuh"

namespace {

struct Strides {
  long long b, h, d, n;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* cos;  // null: no RoPE
  const float* sin;
  const int* seg;    // null: no segment mask
  __nv_bfloat16* o;
  float* lse;
  Strides sq, sk, sv, so;
  long long t_b, t_d, t_n;  // RoPE table strides
  long long seg_b;          // segment-id batch stride
  int H, N, M, kv_lim;
  float qscale;  // scale * log2(e)
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
    for (int i = threadIdx.x; i < kHalf * kGroups; i += kThreads) {
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
    for (int i = threadIdx.x; i < kHalf * kRows; i += kThreads) {
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
// token-major [B, H, N|M, D] for the main kernel. One block per (b, h, 64 tokens).
template <int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
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
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      if (t0 + r < n_lim) {
        *reinterpret_cast<uint4*>(dst + (long long)(t0 + r) * D + c * 8) =
            *reinterpret_cast<const uint4*>(&s_t[r * kStride + c * 8]);
      }
    }
    __syncthreads();
  }
}

template <int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_dn_kernel(const Params p, const __nv_bfloat16* qr, const __nv_bfloat16* kr) {
  constexpr int kDTiles = D / 8;            // 8-wide output tiles over the head dim
  constexpr int kStride = D + kPad;         // s_q, s_k rows: [token][d]
  constexpr int kVStride = kBlockK + kPad;  // s_v rows: [d][key]
  constexpr int kOStride = kBlockQ + kPad;  // output stage rows: [d][query], in s_q
  static_assert(D * kOStride <= kBlockQ * kStride, "the output stage fits in the q buffer");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBlockQ][kStride]
  __nv_bfloat16* s_k = s_q + kBlockQ * kStride;                  // [2][kBlockK][kStride]
  __nv_bfloat16* s_v = s_k + 2 * kBlockK * kStride;              // [2][D][kVStride]
  int* s_segk = reinterpret_cast<int*>(s_v + 2 * D * kVStride);  // [2][kBlockK]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the quad
  const int row0 = warp * 16 + g;  // this thread's rows in the tile: row0, row0 + 8

  const __nv_bfloat16* qrp = qr + ((long long)b * p.H + h) * p.N * D;
  const __nv_bfloat16* krp = kr + ((long long)b * p.H + h) * p.M * D;
  const __nv_bfloat16* vp = p.v + b * p.sv.b + h * p.sv.h;
  const bool use_seg = p.seg != nullptr;
  const int* segp = use_seg ? p.seg + b * p.seg_b : nullptr;

  // Stage k tile `kt` into buffer `buf`: k' and (aligned) v by cp.async, the
  // rest by plain loads; visible after the caller's wait and barrier.
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBlockK;
    copy_rows_async<D, kBlockK>(s_k + buf * kBlockK * kStride, krp, k0, p.M);
    __nv_bfloat16* sv = s_v + buf * D * kVStride;
    if constexpr (kVec) {
      for (int i = tid; i < D * (kBlockK / 8); i += kThreads) {
        const int d = i / (kBlockK / 8), grp = i % (kBlockK / 8), n = k0 + grp * 8;
        const bool ok = n < p.M;
        cp_async16(&sv[d * kVStride + grp * 8], vp + (ok ? d * p.sv.d + n : 0), ok);
      }
    } else {
      for (int i = tid; i < D * kBlockK; i += kThreads) {
        const int d = i / kBlockK, r = i % kBlockK, n = k0 + r;
        sv[d * kVStride + r] = n < p.M ? vp[d * p.sv.d + n * p.sv.n] : __float2bfloat16_rn(0.f);
      }
    }
    if (use_seg && tid < kBlockK) {
      s_segk[buf * kBlockK + tid] = k0 + tid < p.M ? segp[k0 + tid] : 0;
    }
  };

  const int n_ktiles = (p.kv_lim + kBlockK - 1) / kBlockK;  // tiles past kv_lim are all masked
  copy_rows_async<D, kBlockQ>(s_q, qrp, q0, p.N);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  int segq[2] = {0, 0};
  if (use_seg) {
    for (int r = 0; r < 2; ++r) {
      const int gn = q0 + row0 + 8 * r;
      segq[r] = gn < p.N ? segp[gn] : 0;
    }
  }
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();

  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, s_q, row0);

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the running denominator

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBlockK, buf = kt & 1;
    if (kt + 1 < n_ktiles) {
      load_kv(kt + 1, buf ^ 1);  // that buffer was released by the last barrier below
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    attend_tile<D>(acc, m_run, l_run, qf, s_k + buf * kBlockK * kStride,
                   s_v + buf * D * kVStride, s_segk + buf * kBlockK, segq, use_seg, false, k0,
                   p.kv_lim, q0 + row0);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  float denom[2];
  row_denominators(denom, l_run);

  // Stage the output as [d][query] in the q buffer (free: the q fragments
  // were loaded before the loop, and the loop's barriers follow).
  __nv_bfloat16* s_o = s_q;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int d0 = dt * 8 + 2 * t4;
    s_o[d0 * kOStride + row0] = __float2bfloat16_rn(acc[dt][0] / denom[0]);
    s_o[(d0 + 1) * kOStride + row0] = __float2bfloat16_rn(acc[dt][1] / denom[0]);
    s_o[d0 * kOStride + row0 + 8] = __float2bfloat16_rn(acc[dt][2] / denom[1]);
    s_o[(d0 + 1) * kOStride + row0 + 8] = __float2bfloat16_rn(acc[dt][3] / denom[1]);
  }
  write_lse(p.lse + ((long long)b * p.H + h) * p.N, denom, m_run, q0 + row0, p.N);
  __syncthreads();
  __nv_bfloat16* op = p.o + b * p.so.b + h * p.so.h;
  if constexpr (kVec) {
    for (int i = tid; i < D * (kBlockQ / 8); i += kThreads) {
      const int d = i / (kBlockQ / 8), grp = i % (kBlockQ / 8), n = q0 + grp * 8;
      if (n < p.N) {
        *reinterpret_cast<uint4*>(op + d * p.so.d + n) =
            *reinterpret_cast<const uint4*>(&s_o[d * kOStride + grp * 8]);
      }
    }
  } else {
    for (int i = tid; i < D * kBlockQ; i += kThreads) {
      const int d = i / kBlockQ, r = i % kBlockQ, n = q0 + r;
      if (n < p.N) op[d * p.so.d + n * p.so.n] = s_o[d * kOStride + r];
    }
  }
}

// The 16-byte path needs unit stride along N, rows that start 16-byte aligned
// (8 bf16 or 4 fp32 elements) and no partial 8-token group at the ends.
bool vector_ok(const Params& p) {
  const Strides* all[] = {&p.sq, &p.sk, &p.sv, &p.so};
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (int i = 0; i < 4; ++i) {
    const Strides& s = *all[i];
    if (s.n != 1 || s.b % 8 || s.h % 8 || s.d % 8 || !aligned16(ptrs[i])) return false;
  }
  if (p.N % 8 || p.M % 8) return false;
  if (p.cos != nullptr &&
      (p.t_n != 1 || p.t_d % 4 || p.t_b % 4 || !aligned16(p.cos) || !aligned16(p.sin)))
    return false;
  return true;
}

template <int D, bool kVec>
cudaError_t launch_both(const Params& p, int B, __nv_bfloat16* qr, __nv_bfloat16* kr,
                        cudaStream_t stream) {
  constexpr int kSmem = main_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_dn_kernel<D, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int longest = p.N > p.M ? p.N : p.M;
  rope_pack_kernel<D, kVec><<<dim3((longest + 63) / 64, p.H, B), kThreads, 0, stream>>>(p, qr, kr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd_dn_kernel<D, kVec><<<grid, kThreads, kSmem, stream>>>(p, qr, kr);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int B, __nv_bfloat16* qr, __nv_bfloat16* kr,
                   cudaStream_t stream) {
  return vector_ok(p) ? launch_both<D, true>(p, B, qr, kr, stream)
                      : launch_both<D, false>(p, B, qr, kr, stream);
}

}  // namespace

// strides: 20 element strides, in order
//   q (b, h, d, n), k (b, h, d, n), v (b, h, d, n), out (b, h, d, n),
//   RoPE tables (b, d, n), segment ids (b).
// cos/sin null: no RoPE. seg null: no segment mask. lse is [B, H, N] contiguous.
// q_scratch [B, H, N, D] and k_scratch [B, H, M, D] bf16 receive the rotated,
// rounded q and k (the prologue's output). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int vjepa2_flash_fwd_dn_bf16(const void* q, const void* k, const void* v,
                                        const void* cos_t, const void* sin_t, const void* seg,
                                        void* out, void* lse, void* q_scratch, void* k_scratch,
                                        int B, int H, int D, int N, int M, int kv_lim,
                                        const long long* strides, float qscale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.cos = static_cast<const float*>(cos_t);
  p.sin = static_cast<const float*>(sin_t);
  p.seg = static_cast<const int*>(seg);
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.sq = {strides[0], strides[1], strides[2], strides[3]};
  p.sk = {strides[4], strides[5], strides[6], strides[7]};
  p.sv = {strides[8], strides[9], strides[10], strides[11]};
  p.so = {strides[12], strides[13], strides[14], strides[15]};
  p.t_b = strides[16];
  p.t_d = strides[17];
  p.t_n = strides[18];
  p.seg_b = strides[19];
  p.H = H;
  p.N = N;
  p.M = M;
  p.kv_lim = kv_lim;
  p.qscale = qscale;
  auto* qr = static_cast<__nv_bfloat16*>(q_scratch);
  auto* kr = static_cast<__nv_bfloat16*>(k_scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M || !aligned16(qr) || !aligned16(kr))
    return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch<16>(p, B, qr, kr, s);
    case 32: return launch<32>(p, B, qr, kr, s);
    case 48: return launch<48>(p, B, qr, kr, s);
    case 64: return launch<64>(p, B, qr, kr, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* vjepa2_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
