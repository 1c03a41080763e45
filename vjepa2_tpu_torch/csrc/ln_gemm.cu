// The fused LayerNorm + qkv prologue (kernel B7), for Hopper (sm_90a), on
// mma.sync.
//
// Replaces the TPU kernel `vjepa2_tpu/ops/ln_qkv.py:50 _ln_qkv_kernel`
// (`pallas_call` `:108`): LN(x) -> y bf16 @ W_qkv (fp32 accumulation) + b
// (fp32, before the one rounding) -> split-half RoPE on q and k in fp32 ->
// q, k, v [B, H, N, D] bf16, plus mean and rstd [B, N].
// x [R = B*N, C] bf16 contiguous; W [3 H D, C] bf16 (the port's
// `qkv.weight` layout, K-contiguous: the mma B operand as it lies, no
// transpose); gamma, beta, bias fp32. C in {384, 1024, 1280, 1408}; D in
// {32, 64, 80, 88}.
//
// What bounds it on this card: the tensor cores. At [8, 2048, 1024] it does
// 103 GFLOP (0.104 ms at 989 TFLOP/s) against ~44 MB moved (0.013 ms).
//
// What this version does about it (right and simple first):
//   * launch 1, `ln_fwd_kernel` with no output (`ln_common.cuh`, B6's
//     forward): mean and rstd [R], which are outputs anyway;
//   * launch 2, `ln_gemm_kernel`: a 128 x BN tile per block (BN 128; 160 or
//     176 at D 80 / 88, two whole heads), K in steps of 32, 8 warps as 4 x 2
//     each computing 32 x BN/2 with mma.sync m16n8k16. x comes in through
//     registers, one k-step ahead, and is normalised on the way into shared
//     memory (fp32 statistics and affine, rounded once to bf16, as the plain
//     version rounds y); W comes in by cp.async into a double buffer. Rows
//     past R read as zero and are not written; a row of zeros (a stack-pad
//     row) normalises to beta.
//   * the epilogue stages the fp32 tile (+ bias) in shared memory: a column
//     tile holds whole heads of one of q, k, v, so each split-half pair
//     (d, d + D/2) lies in it; q and k rotate with the [B|1, N, D] tables
//     (`rope_pair`, the flash kernels' rotation; batch b reads table
//     b % tb), and q, k, v are written [B, H, N, D].
// Not done yet, for later work: the wgmma/TMA mainloop of B8
// (`ln_gemm_hopper.cu`), whose epilogue is a template parameter for this one.

#include "ln_common.cuh"

namespace {

constexpr int kBM = 128;                 // rows per block
constexpr int kBK = 32;                  // K per step
constexpr int kGemmThreads = 256;        // 8 warps: 4 along M x 2 along N
constexpr int kKStride = kBK + kPad;     // smem row stride of the A and W tiles (bf16)

struct GemmParams {
  const bf16* x;
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  const bf16* w;
  const float* bias;
  int R, C, Nout;
  bf16* q;
  bf16* k;
  bf16* v;
  const float* cos;  // null: no RoPE; [tb, N, D] contiguous
  const float* sin;
  int N, H, tb;
};

// Column tile: whole heads (D <= 64: 128 columns; D 80, 88: two heads).
__host__ __device__ constexpr int tile_cols(int D) { return D <= 64 ? 128 : 2 * D; }

template <int BN>
__host__ __device__ constexpr int pipe_bytes() {
  return 2 * (kBM + BN) * kKStride * 2;
}

template <int BN>
__host__ __device__ constexpr int work_bytes() {
  // the epilogue stages the fp32 tile [kBM][BN + 4] over the pipeline buffers
  return kBM * (BN + 4) * 4 > pipe_bytes<BN>() ? kBM * (BN + 4) * 4 : pipe_bytes<BN>();
}

// q, k, v with RoPE, head width D.
template <int D>
__global__ void __launch_bounds__(kGemmThreads) ln_gemm_kernel(const GemmParams p) {
  constexpr int BN = tile_cols(D);
  constexpr int kWN = BN / 2;     // columns per warp
  constexpr int kNT = kWN / 8;    // n8 tiles per warp
  constexpr int kMT = 2;          // m16 tiles per warp (32 rows)
  static_assert(kWN % 8 == 0, "whole n8 tiles per warp");

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_gamma = reinterpret_cast<float*>(smem);
  float* s_beta = s_gamma + p.C;
  unsigned char* work = smem + 2 * p.C * 4;  // C % 8 == 0: 16-byte aligned
  bf16* s_a = reinterpret_cast<bf16*>(work);  // [2][kBM][kKStride]
  bf16* s_w = s_a + 2 * kBM * kKStride;       // [2][BN][kKStride]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * BN;

  for (int i = tid; i < p.C; i += kGemmThreads) {
    s_gamma[i] = p.gamma[i];
    s_beta[i] = p.beta[i];
  }

  // this thread's two 16-byte chunks of each A tile: rows (tid >> 2) + 64 j,
  // columns (tid & 3) * 8 .. + 8
  const int a_col = (tid & 3) * 8;
  int a_row[2];
  bool a_ok[2];
  float a_mean[2], a_rstd[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a_row[j] = (tid >> 2) + 64 * j;
    a_ok[j] = row0 + a_row[j] < p.R;
    a_mean[j] = a_ok[j] ? p.mean[row0 + a_row[j]] : 0.f;
    a_rstd[j] = a_ok[j] ? p.rstd[row0 + a_row[j]] : 0.f;
  }
  uint4 xa[2];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      xa[j] = a_ok[j] ? *reinterpret_cast<const uint4*>(p.x + (long long)(row0 + a_row[j]) * p.C +
                                                        kt * kBK + a_col)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_a = [&](int kt, int buf) {
    const int k0 = kt * kBK + a_col;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float f[8];
      unpack8(xa[j], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[e] = a_ok[j] ? ln_affine(f[e], a_mean[j], a_rstd[j], s_gamma[k0 + e], s_beta[k0 + e])
                       : 0.f;
      }
      *reinterpret_cast<uint4*>(&s_a[(buf * kBM + a_row[j]) * kKStride + a_col]) = pack8(f);
    }
  };
  auto load_w = [&](int kt, int buf) {
    for (int i = tid; i < BN * (kBK / 8); i += kGemmThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      cp_async16(&s_w[(buf * BN + r) * kKStride + c],
                 p.w + (long long)(col0 + r) * p.C + kt * kBK + c, true);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  const int n_k = p.C / kBK;
  load_w(0, 0);
  cp_async_commit();
  load_x(0);
  __syncthreads();  // gamma and beta staged
  store_a(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    const bool next = kt + 1 < n_k;
    if (next) {
      load_w(kt + 1, buf ^ 1);  // that buffer was released by the last barrier below
      cp_async_commit();
      load_x(kt + 1);           // in flight while this step computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // W tile kt landed, A tile kt stored, for every thread
    const bf16* a = s_a + buf * kBM * kKStride;
    const bf16* b = s_w + buf * BN * kKStride;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const bf16* r = &a[(wm * 32 + mt * 16 + g) * kKStride + ks * 16 + 2 * t4];
        af[mt][0] = ld_smem_u32(r);
        af[mt][1] = ld_smem_u32(r + 8 * kKStride);
        af[mt][2] = ld_smem_u32(r + 8);
        af[mt][3] = ld_smem_u32(r + 8 * kKStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const bf16* c = &b[(wn * kWN + nt * 8 + g) * kKStride + ks * 16 + 2 * t4];
        const uint32_t b0 = ld_smem_u32(c), b1 = ld_smem_u32(c + 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    if (next) store_a(kt + 1, buf ^ 1);  // buf ^ 1 was last read before the barrier above
    __syncthreads();  // this step's buffers are free; A tile kt + 1 is complete
  }

  // stage acc + bias as fp32 [kBM][BN + 4], then rotate pairs and scatter
  constexpr int kSt = BN + 4, kHalf = D / 2, kPairs = BN / 2;
  float* st = reinterpret_cast<float*>(work);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int lc = wn * kWN + nt * 8 + 2 * t4;
    const float b0 = p.bias[col0 + lc], b1 = p.bias[col0 + lc + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int lr = wm * 32 + mt * 16 + g;
      st[lr * kSt + lc] = acc[mt][nt][0] + b0;
      st[lr * kSt + lc + 1] = acc[mt][nt][1] + b1;
      st[(lr + 8) * kSt + lc] = acc[mt][nt][2] + b0;
      st[(lr + 8) * kSt + lc + 1] = acc[mt][nt][3] + b1;
    }
  }
  __syncthreads();
  const int hd = p.H * D, part = col0 / hd, head0 = (col0 % hd) / D;
  bf16* out = part == 0 ? p.q : (part == 1 ? p.k : p.v);
  const bool rotate = part < 2 && p.cos != nullptr;
  for (int i = tid; i < kBM * kPairs; i += kGemmThreads) {
    const int lr = i / kPairs, j = i % kPairs, hl = j / kHalf, d = j % kHalf;
    const int row = row0 + lr;
    if (row >= p.R) continue;
    const int bi = row / p.N, n = row % p.N;
    float lo = st[lr * kSt + hl * D + d], hi = st[lr * kSt + hl * D + d + kHalf];
    if (rotate) {
      const long long t = ((long long)(bi % p.tb) * p.N + n) * D;
      rope_pair(lo, hi, p.cos[t + d], p.sin[t + d], p.cos[t + d + kHalf], p.sin[t + d + kHalf]);
    }
    bf16* dst = out + (((long long)bi * p.H + head0 + hl) * p.N + n) * D;
    dst[d] = __float2bfloat16_rn(lo);
    dst[d + kHalf] = __float2bfloat16_rn(hi);
  }
}

template <int D>
cudaError_t launch_gemm(const GemmParams& p, cudaStream_t stream) {
  constexpr int BN = tile_cols(D);
  const int smem = 2 * p.C * 4 + work_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Nout / BN, (p.R + kBM - 1) / kBM);
  ln_gemm_kernel<D><<<grid, kGemmThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool gemm_inputs_ok(const void* x, const void* gamma, const void* beta, const void* w, int R,
                    int C) {
  return R > 0 && ln_width_ok(C) && aligned16(x) && aligned16(gamma) && aligned16(beta) &&
         aligned16(w);
}

GemmParams common_params(const void* x, const void* gamma, const void* beta, const void* w,
                         const void* bias, void* mean, void* rstd, int R, int C, int Nout) {
  GemmParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.R = R;
  p.C = C;
  p.Nout = Nout;
  return p;
}

}  // namespace

// B7. x [B, N, C] bf16; gamma, beta [C] fp32; w [3 H D, C] bf16 (q/k rows
// already in the split-half order when RoPE is on); bias [3 H D] fp32;
// cos, sin [tb, N, D] fp32 (null: no RoPE; tb 1 or B) -> q, k, v
// [B, H, N, D] bf16, mean and rstd [B, N] fp32. Every array contiguous;
// x, gamma, beta and w 16-byte aligned. H must be a multiple of the heads a
// column tile holds (4 at D 32, else 2). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int vjepa2_ln_qkv_bf16(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* bias, const void* cos_t,
                                  const void* sin_t, void* q, void* k, void* v, void* mean,
                                  void* rstd, int B, int N, int C, int H, int D, int tb,
                                  float eps, void* stream) {
  const int R = B * N;
  if (!gemm_inputs_ok(x, gamma, beta, w, R, C) || (D != 32 && D != 64 && D != 80 && D != 88) ||
      H % (tile_cols(D) / D) != 0 || (cos_t != nullptr && tb != 1 && tb != B))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_fwd(static_cast<const bf16*>(x), static_cast<const float*>(gamma),
                                  static_cast<const float*>(beta), nullptr,
                                  static_cast<float*>(mean), static_cast<float*>(rstd), R, C, eps,
                                  s);
  if (err != cudaSuccess) return err;
  GemmParams p = common_params(x, gamma, beta, w, bias, mean, rstd, R, C, 3 * H * D);
  p.q = static_cast<bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  p.cos = static_cast<const float*>(cos_t);
  p.sin = static_cast<const float*>(sin_t);
  p.N = N;
  p.H = H;
  p.tb = tb;
  switch (D) {
    case 32: return launch_gemm<32>(p, s);
    case 64: return launch_gemm<64>(p, s);
    case 80: return launch_gemm<80>(p, s);
    case 88: return launch_gemm<88>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
