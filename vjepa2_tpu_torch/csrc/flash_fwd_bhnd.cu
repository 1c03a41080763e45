// Flash-attention forward over [B, H, N, D] ("BHND") operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vjepa2_tpu/ops/flash_attention.py:166 _fwd_kernel`
// (wrapper `_flash_fwd_bhnd:257`, `pallas_call` `:307`). Same contract:
//   * q, k, v bf16 [B, H, N|M, D], any element strides (q, k and v are
//     usually views of one qkv projection output [B, N, 3, H, D]);
//     D in {80, 88, 104}, the head widths above the DN route's 64;
//   * split-half RoPE on q and k in fp32 (pairs d and d + D/2), tables fp32
//     [B|1, N, D] with strides (batch, n, d), batch stride 0 when shared;
//     q takes scale*log2(e) before it is rounded to bf16, k is rounded after
//     the rotation (`:209-217`); the rotation and rounding are B1's own
//     device functions (`dn_common.cuh`), so the backward recomputes the
//     scores bit for bit;
//   * online softmax in base 2 with fp32 statistics and fp32 accumulation;
//   * optional segment mask, attend iff seg_q >= seg_k, with separate query
//     and key ids (a ring hop's keys come from another shard), compared as
//     int32; optional token-causal mask (key <= query); keys at or beyond
//     `kv_lim` (the static kv_valid, or M) are masked, and the kernel masks
//     its own ragged edge, so N and M need no padding;
//   * out bf16 in the layout its strides give (unit stride along d), lse
//     [B, H, N] fp32 natural log; a row with no key to attend gives output 0
//     and lse -inf (the TPU kernel's finite -1e30 mask averages v there).
//
// What bounds it on this card: per score element the tensor cores do 4*Dh
// FLOPs (320 at Dh 80) against about 10 scalar operations of softmax, so, as
// in B1, issue and latency on the CUDA cores bound it more than the tensor
// cores or memory do (FLOPs / 989 TFLOP/s is the roofline bound, and memory
// traffic is ~1/100 of it).
//
// What this version does about it: B1's design with the head dim padded to a
// whole mma k-step. Two launches. A prologue (`bhnd_rope_pack_kernel`)
// rotates q and k once, folds scale*log2(e) into q, rounds both to bf16 and
// writes them token-major [B, H, N|M, Dp] into scratch, with v feature-major
// [B, H, Dp, Mp] (Mp: M rounded up to whole 64-key tiles), Dp = D rounded up
// to 16 with zero features (80 -> 80, 88 -> 96, 104 -> 112): so no query
// block re-rotates k or reads a table, and every mma fragment is one 32-bit
// shared-memory load. The main kernel (`flash_fwd_bhnd_kernel`) is B1's
// FlashAttention-2 forward (`flash_fwd_common.cuh:attend_tile`): 128 queries
// a block in 8 warps, scores kept in registers (mma.sync m16n8k16
// accumulators re-packed as the A operand of P.V), one exp2 per score, the
// next k/v tile copied by cp.async while this one is computed, tiles wholly
// past kv_lim (or above the causal diagonal) skipped. Not done yet, for later
// work: wgmma, TMA, warp specialisation.

#include "flash_fwd_common.cuh"

namespace {

constexpr int kRows = 64;  // tokens per prologue block

struct Strides {
  long long b, h, n, d;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* cos;   // null: no RoPE
  const float* sin;
  const int* seg_q;   // null: no segment mask; [B|1, N] int32
  const int* seg_k;   // [B|1, M]
  bf16* o;
  float* lse;         // [B, H, N]
  Strides sq, sk, sv, so;
  long long t_b, t_n, t_d;    // RoPE table strides
  long long segq_b, segk_b;   // segment-id batch strides
  int H, N, M, Mp, kv_lim, causal;
  int vec;       // bit i: 16-byte path for q, k, v, out (i = 0..3)
  float qscale;  // scale * log2(e)
  bf16* qr;      // scratch [B, H, N, Dp]   bf16(rot(q) * qscale)
  bf16* kr;      // scratch [B, H, M, Dp]   bf16(rot(k))
  bf16* vt;      // scratch [B, H, Dp, Mp]  v, feature-major, zero past M
};

// Rows [t0, t0 + kRows) of x (element strides s; tokens at or past lim read
// as 0) into dst[row][0, Dp), features D..Dp zero. The 16-byte path needs
// unit stride along d and 16-byte aligned rows.
template <int D, int Dp>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* x, const Strides& s, int t0,
                                          int lim, bool vec) {
  constexpr int kStride = Dp + kPad;
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int i = threadIdx.x; i < kRows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = i % kChunks, n = t0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n < lim) u = *reinterpret_cast<const uint4*>(x + n * s.n + c * 8);
      *reinterpret_cast<uint4*>(&dst[r * kStride + c * 8]) = u;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
      const int r = i / D, d = i % D, n = t0 + r;
      dst[r * kStride + d] = n < lim ? x[n * s.n + d * s.d] : zero;
    }
  }
  if constexpr (Dp > D) {
    for (int i = threadIdx.x; i < kRows * (Dp - D); i += blockDim.x) {
      dst[(i / (Dp - D)) * kStride + D + i % (Dp - D)] = zero;
    }
  }
}

// dst = bf16(rot(src) * mul) over rows [t0, t0 + kRows) of a [row][d] tile,
// pairs (d, d + D/2), tables at token n (no rotation when cos_t is null, or
// past lim where the rows are zero). dst may be src.
template <int D, int Dp>
__device__ __forceinline__ void rotate_rows(bf16* dst, const bf16* src, const float* cos_t,
                                            const float* sin_t, long long t_n, long long t_d,
                                            int t0, int lim, float mul) {
  constexpr int kHalf = D / 2, kStride = Dp + kPad;
  for (int i = threadIdx.x; i < kRows * kHalf; i += blockDim.x) {
    const int r = i / kHalf, d = i % kHalf, n = t0 + r;
    float lo = __bfloat162float(src[r * kStride + d]);
    float hi = __bfloat162float(src[r * kStride + d + kHalf]);
    if (cos_t != nullptr && n < lim) {
      const long long i_lo = n * t_n + d * t_d;
      const long long i_hi = n * t_n + (d + kHalf) * t_d;
      rope_pair(lo, hi, cos_t[i_lo], sin_t[i_lo], cos_t[i_hi], sin_t[i_hi]);
    }
    dst[r * kStride + d] = round_scaled(lo, mul);
    dst[r * kStride + d + kHalf] = round_scaled(hi, mul);
  }
}

// Prologue: one block per (b, h, 64 tokens). q' and k' token-major, v
// feature-major, as the main kernel's fragments load them.
template <int D, int Dp>
__global__ void __launch_bounds__(kThreads) bhnd_rope_pack_kernel(const Params p) {
  constexpr int kStride = Dp + kPad, kChunks = Dp / 8;
  __shared__ __align__(16) bf16 s_t[kRows * kStride];
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRows;
  const long long bh = (long long)b * p.H + h;
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  for (int which = 0; which < 2; ++which) {
    const bool is_q = which == 0;
    const int lim = is_q ? p.N : p.M;
    if (t0 >= lim) continue;  // uniform across the block
    const Strides& s = is_q ? p.sq : p.sk;
    const bf16* src = (is_q ? p.q : p.k) + b * s.b + h * s.h;
    load_rows<D, Dp>(s_t, src, s, t0, lim, (p.vec >> which) & 1);
    __syncthreads();
    rotate_rows<D, Dp>(s_t, s_t, cos_t, sin_t, p.t_n, p.t_d, t0, lim, is_q ? p.qscale : 1.f);
    __syncthreads();
    bf16* dst = (is_q ? p.qr : p.kr) + bh * lim * Dp;
    for (int i = threadIdx.x; i < kRows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = i % kChunks;
      if (t0 + r < lim) {
        *reinterpret_cast<uint4*>(dst + (long long)(t0 + r) * Dp + c * 8) =
            *reinterpret_cast<const uint4*>(&s_t[r * kStride + c * 8]);
      }
    }
    __syncthreads();
  }
  if (t0 < p.M) {  // v -> [Dp][Mp]; rows past M are zero, so is the pad of the last tile
    load_rows<D, Dp>(s_t, p.v + b * p.sv.b + h * p.sv.h, p.sv, t0, p.M, (p.vec >> 2) & 1);
    __syncthreads();
    bf16* dst = p.vt + bh * Dp * p.Mp;
    for (int i = threadIdx.x; i < Dp * kRows; i += blockDim.x) {
      const int d = i / kRows, r = i % kRows;
      dst[(long long)d * p.Mp + t0 + r] = s_t[r * kStride + d];
    }
  }
}

template <int D, int Dp>
__global__ void __launch_bounds__(kThreads) flash_fwd_bhnd_kernel(const Params p) {
  constexpr int kDTiles = Dp / 8;            // 8-wide output tiles over the head dim
  constexpr int kStride = Dp + kPad;         // s_q, s_k rows: [token][d]
  constexpr int kVStride = kBlockK + kPad;   // s_v rows: [d][key]

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);                    // [kBlockQ][kStride]
  bf16* s_k = s_q + kBlockQ * kStride;                          // [2][kBlockK][kStride]
  bf16* s_v = s_k + 2 * kBlockK * kStride;                      // [2][Dp][kVStride]
  int* s_segk = reinterpret_cast<int*>(s_v + 2 * Dp * kVStride);  // [2][kBlockK]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the quad
  const int row0 = warp * 16 + g;  // this thread's rows in the tile: row0, row0 + 8
  const long long bh = (long long)b * p.H + h;

  const bf16* qrp = p.qr + bh * p.N * Dp;
  const bf16* krp = p.kr + bh * p.M * Dp;
  const bf16* vtp = p.vt + bh * Dp * p.Mp;
  const bool use_seg = p.seg_q != nullptr;
  const int* segq_p = use_seg ? p.seg_q + b * p.segq_b : nullptr;
  const int* segk_p = use_seg ? p.seg_k + b * p.segk_b : nullptr;

  // Stage k tile `kt` into buffer `buf`; visible after the caller's wait and barrier.
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBlockK;
    copy_rows_async<Dp, kBlockK>(s_k + buf * kBlockK * kStride, krp, k0, p.M);
    bf16* sv = s_v + buf * Dp * kVStride;
    for (int i = tid; i < Dp * (kBlockK / 8); i += kThreads) {
      const int d = i / (kBlockK / 8), c = i % (kBlockK / 8);
      cp_async16(&sv[d * kVStride + c * 8], vtp + (long long)d * p.Mp + k0 + c * 8, true);
    }
    if (use_seg && tid < kBlockK) {
      s_segk[buf * kBlockK + tid] = k0 + tid < p.M ? segk_p[k0 + tid] : 0;
    }
  };

  int n_ktiles = (p.kv_lim + kBlockK - 1) / kBlockK;  // tiles past kv_lim are all masked
  if (p.causal) {  // keys above the block's last query are all masked
    const int q_last = min(q0 + kBlockQ, p.N) - 1;
    n_ktiles = min(n_ktiles, q_last / kBlockK + 1);
  }
  copy_rows_async<Dp, kBlockQ>(s_q, qrp, q0, p.N);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  int segq[2] = {0, 0};
  if (use_seg) {
    for (int r = 0; r < 2; ++r) {
      const int gn = q0 + row0 + 8 * r;
      segq[r] = gn < p.N ? segq_p[gn] : 0;
    }
  }
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();

  uint32_t qf[Dp / 16][4];
  load_q_frags<Dp>(qf, s_q, row0);

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
    attend_tile<Dp>(acc, m_run, l_run, qf, s_k + buf * kBlockK * kStride,
                    s_v + buf * Dp * kVStride, s_segk + buf * kBlockK, segq, use_seg, p.causal,
                    k0, p.kv_lim, q0 + row0);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  float denom[2];
  row_denominators(denom, l_run);

  // Stage the output as [query][d] in the q buffer (free: the q fragments
  // were loaded before the loop, and the loop's barriers follow).
  bf16* s_o = s_q;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int d0 = dt * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(&s_o[row0 * kStride + d0]) =
        pack_bf16(acc[dt][0] / denom[0], acc[dt][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(&s_o[(row0 + 8) * kStride + d0]) =
        pack_bf16(acc[dt][2] / denom[1], acc[dt][3] / denom[1]);
  }
  write_lse(p.lse + bh * p.N, denom, m_run, q0 + row0, p.N);
  __syncthreads();
  bf16* op = p.o + b * p.so.b + h * p.so.h;
  if ((p.vec >> 3) & 1) {
    constexpr int kChunks = D / 8;
    for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks, n = q0 + r;
      if (n < p.N) {
        *reinterpret_cast<uint4*>(op + n * p.so.n + c * 8) =
            *reinterpret_cast<const uint4*>(&s_o[r * kStride + c * 8]);
      }
    }
  } else {
    for (int i = tid; i < kBlockQ * D; i += kThreads) {
      const int r = i / D, d = i % D, n = q0 + r;
      if (n < p.N) op[n * p.so.n + d * p.so.d] = s_o[r * kStride + d];
    }
  }
}

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Scratch layout (q', k', v^T), each piece a multiple of 256 bytes.
long long carve(Params* p, char* base, int B, int H, int Dp, int N, int M) {
  const long long bh = (long long)B * H, Mp = round_up(M, kBlockK);
  long long off = 0;
  auto take = [&](long long bytes) {
    char* ptr = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) / 256 * 256;
    return ptr;
  };
  bf16* qr = reinterpret_cast<bf16*>(take(bh * N * Dp * 2));
  bf16* kr = reinterpret_cast<bf16*>(take(bh * M * Dp * 2));
  bf16* vt = reinterpret_cast<bf16*>(take(bh * Mp * Dp * 2));
  if (p != nullptr) {
    p->qr = qr;
    p->kr = kr;
    p->vt = vt;
  }
  return off;
}

int padded_width(int D) {
  switch (D) {
    case 80: return 80;
    case 88: return 96;
    case 104: return 112;
    default: return 0;
  }
}

bool vec_ok(const void* ptr, const Strides& s) {
  return s.d == 1 && s.n % 8 == 0 && s.h % 8 == 0 && s.b % 8 == 0 && aligned16(ptr);
}

template <int D, int Dp>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int kSmem = main_smem_bytes<Dp>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bhnd_kernel<D, Dp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int longest = p.N > p.M ? p.N : p.M;
  bhnd_rope_pack_kernel<D, Dp><<<dim3((longest + kRows - 1) / kRows, p.H, B), kThreads, 0,
                                  stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd_bhnd_kernel<D, Dp><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch `vjepa2_flash_fwd_bhnd_bf16` needs for these sizes (0 for
// an unsupported head width).
extern "C" long long vjepa2_flash_fwd_bhnd_scratch_bytes(int B, int H, int D, int N, int M) {
  const int Dp = padded_width(D);
  return Dp == 0 ? 0 : carve(nullptr, nullptr, B, H, Dp, N, M);
}

// strides: 21 element strides, in order
//   q (b, h, n, d), k (b, h, n, d), v (b, h, n, d), out (b, h, n, d),
//   RoPE tables (b, n, d), query segment ids (b), key segment ids (b).
// cos/sin null: no RoPE (else N == M). seg_q null: no segment mask (else
// seg_k is given too). out needs unit stride along d; lse is [B, H, N]
// contiguous. scratch: vjepa2_flash_fwd_bhnd_scratch_bytes(B, H, D, N, M)
// bytes, 256-byte aligned. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int vjepa2_flash_fwd_bhnd_bf16(const void* q, const void* k, const void* v,
                                          const void* cos_t, const void* sin_t,
                                          const void* seg_q, const void* seg_k, void* out,
                                          void* lse, void* scratch, int B, int H, int D, int N,
                                          int M, int kv_lim, int causal,
                                          const long long* strides, float qscale, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.cos = static_cast<const float*>(cos_t);
  p.sin = static_cast<const float*>(sin_t);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.o = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.sq = {strides[0], strides[1], strides[2], strides[3]};
  p.sk = {strides[4], strides[5], strides[6], strides[7]};
  p.sv = {strides[8], strides[9], strides[10], strides[11]};
  p.so = {strides[12], strides[13], strides[14], strides[15]};
  p.t_b = strides[16];
  p.t_n = strides[17];
  p.t_d = strides[18];
  p.segq_b = strides[19];
  p.segk_b = strides[20];
  p.H = H;
  p.N = N;
  p.M = M;
  p.Mp = round_up(M, kBlockK);
  p.kv_lim = kv_lim;
  p.causal = causal;
  p.qscale = qscale;
  p.vec = (vec_ok(q, p.sq) ? 1 : 0) | (vec_ok(k, p.sk) ? 2 : 0) | (vec_ok(v, p.sv) ? 4 : 0) |
          (vec_ok(out, p.so) ? 8 : 0);
  const int Dp = padded_width(D);
  if (Dp == 0 || N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M || p.so.d != 1 ||
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
