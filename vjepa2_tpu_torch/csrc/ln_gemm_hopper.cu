// The fused LayerNorm + fc1 + GELU prologue (kernel B8), for Hopper (sm_90a).
//
// Replaces the TPU kernel `vjepa2_tpu/ops/ln_mlp.py:78 _ln_mlp_kernel`
// (`pallas_call` `:106`): LN(x) -> y bf16 @ W_fc1^T (fp32 accumulation) + b
// (fp32) -> exact GELU -> h [R, hidden] bf16, plus mean and rstd [R]. GELU
// is 0.5 z (1 + erf(z / sqrt 2)) with CUDA's `erff`: the TPU kernel's
// Abramowitz-Stegun polynomial (`_erf_poly:57`) stands in for an `erf`
// Mosaic cannot lower, and both JAX reference paths use erf.
// x [R, C] bf16; W [hidden, C] bf16 (the port's `fc1.weight`, K-contiguous:
// the K-major B operand as it lies); gamma, beta, bias fp32. C in {384,
// 1024, 1280, 1408}, hidden in {1536, 4096, 5120, 6144}.
//
// What bounds it on this card: the tensor cores (at [16384, 1024] -> 4096,
// 137 GFLOP: 0.139 ms at 989 TFLOP/s, against 0.04 ms to write the 134 MB
// of h), and after them the epilogue: both consumer warpgroups share a
// tile, so their GELU (erff, about 30 operations an output) and stores run
// while the tensor cores wait. Warpgroups that own alternate 64-row tiles
// and take turns (ping-pong, as the flash forwards do) overlap that
// epilogue but read W once per 64 rows instead of 128; on an H100 that
// variant ran 2-16% slower at every shape of 584 tokens and more, and took
// the same device time at 176 tokens (`tools/ab_kernels.py`,
// `tools/profile_kernels.py`).
//
// Design (`bhnd_hopper.cuh` for the machinery):
//   * launch 1, `ln_fwd_kernel` with no output (`ln_common.cuh`, B6's
//     forward): mean and rstd [R], which are outputs anyway;
//   * launch 2, `ln_gemm_wgmma_kernel`: persistent, one block an SM walking
//     128 x 256 output tiles (row tiles outer, column tiles inner); a
//     producer warp feeds a 4-stage ring by TMA with boxes of x [128 rows x
//     64 K] and W [256 rows x 64 K], 128-byte swizzled, zero-filled past R;
//   * two consumer warpgroups of 64 rows (232 registers after setmaxnreg)
//     share each stage. Each reads its x rows from the swizzled tile,
//     normalises them in fp32 with the row's mean and rstd and gamma and
//     beta from shared memory, y = bf16(((x - mean) * rstd) * gamma + beta)
//     rounded as the plain version rounds y, and feeds them to wgmma
//     m64n256k16 as a register A operand: a chunk's four products are
//     issued at once while the next chunk is normalised into the second of
//     two A buffers, so the normalisation overlaps the tensor cores;
//   * the epilogue is a template parameter of the mainloop; B8's adds the
//     bias (each 64-column pass's loaded a pass ahead, so nothing spills),
//     applies GELU, rounds once to bf16 and writes through a per-warp
//     swizzled stage in shared memory, 16 bytes a store. Rows past R are
//     neither read as data (their statistics are not loaded) nor written; a
//     stack-pad row of zeros normalises to beta.
// gamma is not folded into W and mean * colsum(W) is not subtracted after
// the product: either would round differently and cancel when |mean| >> std.

#include "bhnd_hopper.cuh"
#include "ln_common.cuh"

namespace {

constexpr int kBM = 128;                    // rows a tile, 64 a consumer warpgroup
constexpr int kBN = 256;                    // output columns a tile
constexpr int kBK = 64;                     // K a ring stage: one 128-byte swizzled chunk
constexpr int kStages = 4;
constexpr int kXTile = kBM * kRowBytes;     // 16 KB
constexpr int kWTile = kBN * kRowBytes;     // 32 KB
constexpr int kStageBytes = kXTile + kWTile;
constexpr int kWarpStage = 16 * kRowBytes;  // the epilogue's 16 rows x 64 columns of a warp
constexpr int kMaxC = 1408;

// What the mainloop reads, whatever its epilogue.
struct GemmArgs {
  CUtensorMap tm_x, tm_w;  // x [R, C], W [n_out, C]: boxes of 64 K x kBM / kBN rows
  const float* mean;       // [R]
  const float* rstd;
  const float* gamma;      // [C]
  const float* beta;
  int R, C, n_out, col_tiles, n_tiles;
};

template <class Epi>
struct LnGemmParams {
  GemmArgs g;
  typename Epi::Args e;
};

__host__ __device__ constexpr int smem_bytes(int C) {  // ring, epilogue stages, gamma/beta, barriers
  return kStages * kStageBytes + kConsumerWarps * kWarpStage + C * 8 + 2 * kStages * 8 + 1024;
}

__device__ __forceinline__ float gelu_exact(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// B8's epilogue: h = bf16(gelu(acc + bias)) for the warp's 16 rows from
// row0 and the tile's columns from n0; each 64-column slice goes through
// the warp's stage (16-byte group c of row r at c ^ (r % 8), so neither the
// 4-byte writes nor the 16-byte reads conflict) and out 16 bytes a store.
struct GeluEpilogue {
  struct Args {
    const float* bias;  // [n_out]
    bf16* h;            // [R, n_out]
  };
  static __device__ __forceinline__ void store(const float (&acc)[kBN / 2], const Args& e,
                                               const GemmArgs& g, int row0, int n0,
                                               unsigned char* stage, int lane) {
    const int t4 = lane & 3, gq = lane >> 2;
    // this thread's bias of a 64-column pass, loaded a pass ahead
    float2 bias[2][8];
    auto load_bias = [&](float2 (&b)[8], int pass) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        b[c8] = __ldg(reinterpret_cast<const float2*>(e.bias + n0 + pass * 64 + c8 * 8 + 2 * t4));
      }
    };
    load_bias(bias[0], 0);
#pragma unroll
    for (int pass = 0; pass < kBN / 64; ++pass) {
      if (pass + 1 < kBN / 64) load_bias(bias[(pass + 1) & 1], pass + 1);
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int nt = pass * 8 + c8;
        const float2 bb = bias[pass & 1][c8];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = gq + 8 * r;
          *reinterpret_cast<uint32_t*>(stage + row * kRowBytes + ((c8 ^ (row & 7)) << 4) +
                                       4 * t4) =
              pack_bf16(gelu_exact(acc[4 * nt + 2 * r] + bb.x),
                        gelu_exact(acc[4 * nt + 2 * r + 1] + bb.y));
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = lane + 32 * q, row = i >> 3, c8 = i & 7;
        const uint4 v =
            *reinterpret_cast<const uint4*>(stage + row * kRowBytes + ((c8 ^ (row & 7)) << 4));
        if (row0 + row < g.R) {
          *reinterpret_cast<uint4*>(e.h + (long long)(row0 + row) * g.n_out + n0 + pass * 64 +
                                    c8 * 8) = v;
        }
      }
      __syncwarp();
    }
  }
};

template <class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_wgmma_kernel(const __grid_constant__ LnGemmParams<Epi> p) {
  const GemmArgs& g = p.g;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);                  // [kStages][x tile, W tile]
  unsigned char* stages = ring + kStages * kStageBytes;       // [8 warps][kWarpStage]
  float4* s_gb = reinterpret_cast<float4*>(stages + kConsumerWarps * kWarpStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_gb + g.C / 2);
  uint64_t* empty = full + kStages;
  const int n_k = g.C / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {  // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * kWgThreads) {
      int it = 0;
      for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
        const int m0 = (tile / g.col_tiles) * kBM, n0 = (tile % g.col_tiles) * kBN;
        for (int j = 0; j < n_k; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(ring + s * kStageBytes, &g.tm_x, j * kBK, m0, &full[s]);
          tma_load_2d(ring + s * kStageBytes + kXTile, &g.tm_w, j * kBK, n0, &full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  // gamma and beta of columns 2i, 2i + 1 as one float4 {g, g', b, b'}
  for (int i = threadIdx.x; i < g.C / 2; i += 2 * kWgThreads) {
    s_gb[i] = make_float4(g.gamma[2 * i], g.gamma[2 * i + 1], g.beta[2 * i], g.beta[2 * i + 1]);
  }
  bar_sync(1, 2 * kWgThreads);

  const int t = threadIdx.x % kWgThreads, warp = t >> 5, lane = t & 31;
  const int t4 = lane & 3;
  const int wrow = wg * 64 + warp * 16;  // this warp's rows in a tile
  const int xr = wrow + (lane >> 2);     // this thread's: xr, xr + 8
  unsigned char* stage = stages + (wg * 4 + warp) * kWarpStage;

  float acc[kBN / 2];
  uint32_t a[2][kBK / 16][4];  // A fragments of two chunks: the one in flight and the next
  float mean[2], rstd[2];

  // The x tile at `x_tile`, whose first column is x's column kc: y = LN(x)
  // rounded to bf16, as the A fragments of rows xr and xr + 8 for each of
  // the chunk's k-steps of 16 columns.
  auto make_a = [&](uint32_t(&af)[kBK / 16][4], const unsigned char* x_tile, int kc) {
    const bf16* x = reinterpret_cast<const bf16*>(x_tile);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = ks * 16 + hi * 8 + 2 * t4;
        const float4 gb = s_gb[(kc + c) >> 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(x + swz(kBM, xr + 8 * r, c));
          af[ks][hi * 2 + r] = pack_bf16(
              ln_affine(__uint_as_float(u << 16), mean[r], rstd[r], gb.x, gb.z),
              ln_affine(__uint_as_float(u & 0xffff0000u), mean[r], rstd[r], gb.y, gb.w));
        }
      }
    }
  };
  // the statistics of this thread's rows of a tile (rows past R: not read)
  auto load_stats = [&](int tile, float (&m)[2], float (&rs)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (tile / g.col_tiles) * kBM + xr + 8 * r;
      m[r] = row < g.R ? g.mean[row] : 0.f;
      rs[r] = row < g.R ? g.rstd[row] : 0.f;
    }
  };

  int it = 0;  // ring stages consumed so far
  if (blockIdx.x < g.n_tiles) load_stats(blockIdx.x, mean, rstd);
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
    const int m0 = (tile / g.col_tiles) * kBM, n0 = (tile % g.col_tiles) * kBN;
    // chunk j's four products on `cur`; while they run, chunk j - 1's stage
    // is released and chunk j + 1 is normalised into `nxt`
    auto chunk = [&](int j, const uint32_t(&cur)[kBK / 16][4], uint32_t(&nxt)[kBK / 16][4]) {
      const uint64_t d_w = desc_k<kBN>(ring + ((it + j) % kStages) * kStageBytes + kXTile, 0);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        wgmma_rs<kBN, 0>(acc, cur[ks], d_w + step_k<kBN>(ks), j > 0 || ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // chunk j - 1 is done: its stage and `nxt` are free
      if (j > 0 && lane == 0) mbar_arrive(&empty[(it + j - 1) % kStages]);
      if (j + 1 < n_k) {
        const int st = (it + j + 1) % kStages;
        mbar_wait(&full[st], ((it + j + 1) / kStages) & 1);
        make_a(nxt, ring + st * kStageBytes, (j + 1) * kBK);
      }
    };
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    make_a(a[0], ring + (it % kStages) * kStageBytes, 0);
    fence_regs(acc);
    for (int j = 0; j < n_k; j += 2) {  // n_k is even: C is a multiple of 128
      chunk(j, a[0], a[1]);
      chunk(j + 1, a[1], a[0]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it + n_k - 1) % kStages]);
    it += n_k;
    if (tile + gridDim.x < g.n_tiles) load_stats(tile + gridDim.x, mean, rstd);
    Epi::store(acc, p.e, g, m0 + wrow, n0, stage, lane);
  }
}

template <class Epi>
cudaError_t launch_ln_gemm(const LnGemmParams<Epi>& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<ln_gemm_wgmma_kernel<Epi>>(smem_bytes(kMaxC));
  if (err != cudaSuccess) return err;
  // persistent: one block an SM, none without a tile
  const int grid = p.g.n_tiles < sm_count() ? p.g.n_tiles : sm_count();
  ln_gemm_wgmma_kernel<Epi><<<grid, kThreads, smem_bytes(p.g.C), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// B8. x [R, C] bf16 (rows of C elements); gamma, beta [C] fp32; w [hidden,
// C] bf16; bias [hidden] fp32 -> h [R, hidden] bf16, mean and rstd [R]
// fp32. x, w contiguous; h 16-byte aligned (16-byte stores), bias 8-byte
// aligned. Returns the cudaError_t of the launches (0 on success);
// cudaErrorInvalidValue, launching nothing, for arguments it does not take;
// kNotTmaReady, launching nothing, when x or w is not 16-byte aligned.
extern "C" int vjepa2_ln_mlp_bf16(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* bias, void* h, void* mean,
                                  void* rstd, int R, int C, int hidden, float eps, void* stream) {
  if (R <= 0 || !ln_width_ok(C) ||
      (hidden != 1536 && hidden != 4096 && hidden != 5120 && hidden != 6144) || !aligned16(h) ||
      reinterpret_cast<uintptr_t>(bias) % 8 != 0)
    return cudaErrorInvalidValue;
  LnGemmParams<GeluEpilogue> p;
  GemmArgs& g = p.g;
  g.R = R;
  g.C = C;
  g.n_out = hidden;
  g.col_tiles = hidden / kBN;
  g.n_tiles = (R + kBM - 1) / kBM * g.col_tiles;
  if (!encode_2d(&g.tm_x, x, R, C, C, kBM) || !encode_2d(&g.tm_w, w, hidden, C, C, kBN))
    return kNotTmaReady;
  g.mean = static_cast<const float*>(mean);
  g.rstd = static_cast<const float*>(rstd);
  g.gamma = static_cast<const float*>(gamma);
  g.beta = static_cast<const float*>(beta);
  p.e.bias = static_cast<const float*>(bias);
  p.e.h = static_cast<bf16*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_fwd(static_cast<const bf16*>(x), g.gamma, g.beta, nullptr,
                                  static_cast<float*>(mean), static_cast<float*>(rstd), R, C, eps,
                                  s);
  if (err != cudaSuccess) return err;
  return launch_ln_gemm(p, s);
}
