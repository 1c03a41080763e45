// The fused LayerNorm prologues of the blocks, for Hopper (sm_90a): LN +
// fc1 + GELU (kernel B8) and LN + qkv + RoPE (kernel B7), one persistent
// wgmma/TMA mainloop with the epilogue as a template parameter.
//
// B8 replaces the TPU kernel `vjepa2_tpu/ops/ln_mlp.py:78 _ln_mlp_kernel`
// (`pallas_call` `:106`): LN(x) -> y bf16 @ W_fc1^T (fp32 accumulation) + b
// (fp32) -> exact GELU -> h [R, hidden] bf16, plus mean and rstd [R]. GELU
// is 0.5 z (1 + erf(z / sqrt 2)) with CUDA's `erff`: the TPU kernel's
// Abramowitz-Stegun polynomial (`_erf_poly:57`) stands in for an `erf`
// Mosaic cannot lower, and both JAX reference paths use erf.
// x [R, C] bf16; W [hidden, C] bf16 (the port's `fc1.weight`, K-contiguous:
// the K-major B operand as it lies); gamma, beta, bias fp32. C in {384,
// 1024, 1280, 1408}, hidden in {1536, 4096, 5120, 6144}.
//
// B7 replaces `vjepa2_tpu/ops/ln_qkv.py:50 _ln_qkv_kernel` (`pallas_call`
// `:108`): LN(x) -> y bf16 @ W_qkv^T (fp32 accumulation) + b (fp32, before
// the one rounding) -> split-half RoPE on q and k in fp32 -> q, k, v
// [B, H, N, D] bf16, plus mean and rstd [B, N]. W [3 H D, C] bf16 (the
// port's `qkv.weight`); D in {32, 64, 80, 88}.
//
// What bounds them on this card: the tensor cores (B8 at [16384, 1024] ->
// 4096, 137 GFLOP: 0.139 ms at 989 TFLOP/s, against 0.04 ms to write the
// 134 MB of h; B7 at [16384, 1024] -> 3072, 103 GFLOP: 0.104 ms), and after
// them the epilogue: both consumer warpgroups share a tile, so their GELU
// (erff, about 30 operations an output) or RoPE and stores run while the
// tensor cores wait. Warpgroups that own alternate 64-row tiles and take
// turns (ping-pong, as the flash forwards do) overlap that epilogue but
// read W once per 64 rows instead of 128; on an H100 that variant of B8 ran
// 2-16% slower at every shape of 584 tokens and more, and took the same
// device time at 176 tokens (`tools/ab_kernels.py`,
// `tools/profile_kernels.py`).
//
// Design (`bhnd_hopper.cuh` for the machinery):
//   * launch 1, `ln_stats_kernel` (`ln_common.cuh`, B6's forward writing
//     no output): mean and rstd [R], which are outputs anyway;
//   * launch 2, `ln_gemm_wgmma_kernel`: persistent, one block an SM walking
//     128 x BN output tiles (row tiles outer, column tiles inner; BN 256 for
//     B8, heads x D for B7); a producer warp feeds a 4-stage ring by TMA
//     with boxes of x [128 rows x 64 K] and W [BN rows x 64 K], 128-byte
//     swizzled, zero-filled past R;
//   * two consumer warpgroups of 64 rows (232 registers after setmaxnreg)
//     share each stage. Each reads its x rows from the swizzled tile,
//     normalises them in fp32 with the row's mean and rstd and gamma and
//     beta from shared memory, y = bf16(((x - mean) * rstd) * gamma + beta)
//     rounded as the plain version rounds y, and feeds them to wgmma
//     m64nBNk16 as a register A operand: a chunk's four products are
//     issued at once while the next chunk is normalised into the second of
//     two A buffers, so the normalisation overlaps the tensor cores;
//   * the epilogue is a template parameter of the mainloop, which takes its
//     tile width from it. B8's adds the bias (each 64-column pass's loaded a
//     pass ahead, so nothing spills), applies GELU, rounds once to bf16 and
//     writes through a per-warp swizzled stage in shared memory, 16 bytes a
//     store. B7's (`QkvEpilogue`) takes whole heads of one of q, k, v a
//     tile, as the caller's tile plan chose them (`ops/ln_qkv.py`), so each
//     RoPE pair lies in the tile, and rotates in registers (below). Rows
//     past R are neither read as data (their statistics are not loaded) nor
//     written; a stack-pad row of zeros normalises to beta.
// gamma is not folded into W and mean * colsum(W) is not subtracted after
// the product: either would round differently and cancel when |mean| >> std.

#include "bhnd_hopper.cuh"
#include "ln_common.cuh"

namespace {

constexpr int kBM = 128;                    // rows a tile, 64 a consumer warpgroup
constexpr int kBK = 64;                     // K a ring stage: one 128-byte swizzled chunk
constexpr int kStages = 4;
constexpr int kXTile = kBM * kRowBytes;     // 16 KB
constexpr int kMaxC = 1408;

// What the mainloop reads, whatever its epilogue.
struct GemmArgs {
  CUtensorMap tm_x, tm_w;  // x [R, C], W [n_out, C]: boxes of 64 K x kBM / Epi::kBN rows
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

// A ring stage: the x tile and the W tile of an epilogue's width.
template <class Epi>
__host__ __device__ constexpr int stage_bytes() {
  return kXTile + Epi::kBN * kRowBytes;
}

template <class Epi>  // ring, epilogue stages, gamma/beta, barriers
__host__ __device__ constexpr int smem_bytes(int C) {
  return kStages * stage_bytes<Epi>() + kConsumerWarps * Epi::kWarpStage + C * 8 +
         2 * kStages * 8 + 1024;
}

__device__ __forceinline__ float gelu_exact(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// B8's epilogue: h = bf16(gelu(acc + bias)) for the warp's 16 rows from
// row0 and the tile's columns from n0; each 64-column slice goes through
// the warp's stage (16-byte group c of row r at c ^ (r % 8), so neither the
// 4-byte writes nor the 16-byte reads conflict) and out 16 bytes a store.
struct GeluEpilogue {
  static constexpr int kBN = 256;                    // output columns a tile
  static constexpr int kWarpStage = 16 * kRowBytes;  // a warp's 16 rows x 64 columns, bf16
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

// B7's epilogue: kHeads whole heads of width D of one of q, k, v a tile.
// Per head: acc + bias in fp32 (the one rounding comes last), then, for q
// and k with tables, the split-half rotation. A thread rotates its own
// columns: column d of a head takes its partner d +- D/2 and the tables at
// d, x * cos -+ partner * sin with rope_pair's roundings. At D % 16 == 0 the
// partner lies in the same thread (D/16 accumulator groups further); at D
// 88 (D/2 = 44, half a group) it lies in lane ^ 2, five or six groups away,
// and comes by a shuffle. Row r of the tile is token (r / N, r % N), so a
// tile may span two examples; the tables are [tb, N, D] and example b reads
// table b % tb. The epilogue takes a warp's 16 rows in two passes of 8,
// each with its rows' table entries loaded up front (loads after the
// stage's stores would wait for them, one L2 round trip a group). Each
// head's 8 rows x D are rounded to bf16 into the warp's stage (rows padded
// so that neither the 4-byte writes nor the 16-byte reads conflict) and
// written to [B, H, N, D], 16 bytes a store. Rows past R are neither
// rotated nor written.
template <int D, int kHeads>
struct QkvEpilogue {
  static constexpr int kBN = D * kHeads;
  static constexpr int kG = D / 8;  // 8-column accumulator groups a head
  // a staged row: D bf16 and padding, 4 words mod 8
  static constexpr int kRowB = 4 * (D / 2 + ((D / 2) % 8 == 4 ? 0 : 4));
  static constexpr int kWarpStage = 8 * kRowB;  // 8 rows a pass
  static_assert(kBN <= 256 && kBN % 16 == 0, "a wgmma width");
  struct Args {
    const float* bias;  // [3 H D]
    bf16* q;            // [B, H, N, D] each
    bf16* k;
    bf16* v;
    const float* cos;   // null: no RoPE; [tb, N, D]
    const float* sin;
    int N, H, tb;
  };
  static __device__ __forceinline__ void store(float (&acc)[kBN / 2], const Args& e,
                                               const GemmArgs& g, int row0, int n0,
                                               unsigned char* stage, int lane) {
    const int t4 = lane & 3, gq = lane >> 2, half = t4 >> 1;
    const int hd = e.H * D, part = n0 / hd, head0 = (n0 % hd) / D;
    bf16* out = part == 0 ? e.q : (part == 1 ? e.k : e.v);
    const bool rotate = part < 2 && e.cos != nullptr;  // uniform across the block
    // one pass a row of this thread's two (gq, then gq + 8: rows 0-7 and
    // 8-15 of the warp), so that only that row's table entries are live;
    // they are loaded together before any is needed, and every head of the
    // tile reads the same ones
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 tc[kG], ts[kG];
      if (rotate) {
        const int row = min(row0 + gq + 8 * r, g.R - 1);
        const long long tab = ((long long)((row / e.N) % e.tb) * e.N + row % e.N) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          tc[j] = __ldg(reinterpret_cast<const float2*>(e.cos + tab + j * 8));
          ts[j] = __ldg(reinterpret_cast<const float2*>(e.sin + tab + j * 8));
        }
      }
#pragma unroll
      for (int hl = 0; hl < kHeads; ++hl) {
        float* a = acc + hl * kG * 4 + 2 * r;  // this head's groups, row r: a[4 j], a[4 j + 1]
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(e.bias + n0 + hl * D + j * 8 + 2 * t4));
          a[4 * j] += bb.x;
          a[4 * j + 1] += bb.y;
        }
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          float x0 = a[4 * j], x1 = a[4 * j + 1];
          if (rotate) {
            float y0, y1;
            bool lo;
            if constexpr (D % 16 == 0) {
              lo = j < kG / 2;
              const int jp = lo ? j + kG / 2 : j - kG / 2;
              y0 = a[4 * jp];
              y1 = a[4 * jp + 1];
            } else {
              // column 8 j + 2 t4 + e is in the low half iff 8 j + 4 half < D/2
              lo = 8 * j + 4 * half < D / 2;
              // what the partner lane (the other half) needs from this one:
              // a lane of the high half sends for a partner in the low half
              constexpr int kLoLimit = D / 16;  // groups wholly in the low half
              const int g_lo = j <= kLoLimit ? j + kLoLimit : j - kLoLimit - 1;
              const int g_hi = j < kLoLimit ? j + kLoLimit + 1 : j - kLoLimit;
              const float s0 = half ? a[4 * g_lo] : a[4 * g_hi];
              const float s1 = half ? a[4 * g_lo + 1] : a[4 * g_hi + 1];
              y0 = __shfl_xor_sync(0xffffffffu, s0, 2);
              y1 = __shfl_xor_sync(0xffffffffu, s1, 2);
            }
            const float2 c = tc[j], sn = ts[j];
            // rope_pair's roundings: lo c_lo - hi s_lo, hi c_hi + lo s_hi
            x0 = lo ? __fsub_rn(__fmul_rn(x0, c.x), __fmul_rn(y0, sn.x))
                    : __fadd_rn(__fmul_rn(x0, c.x), __fmul_rn(y0, sn.x));
            x1 = lo ? __fsub_rn(__fmul_rn(x1, c.y), __fmul_rn(y1, sn.y))
                    : __fadd_rn(__fmul_rn(x1, c.y), __fmul_rn(y1, sn.y));
          }
          *reinterpret_cast<uint32_t*>(stage + gq * kRowB + (j * 8 + 2 * t4) * 2) =
              pack_bf16(x0, x1);
        }
        __syncwarp();
        for (int i = lane; i < 8 * kG; i += 32) {
          const int rr = i / kG, c8 = i % kG, row = row0 + 8 * r + rr;
          if (row < g.R) {
            const int b = row / e.N, n = row % e.N;
            *reinterpret_cast<uint4*>(out + (((long long)b * e.H + head0 + hl) * e.N + n) * D +
                                      c8 * 8) =
                *reinterpret_cast<const uint4*>(stage + rr * kRowB + c8 * 16);
          }
        }
        __syncwarp();
      }
    }
  }
};

template <class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_wgmma_kernel(const __grid_constant__ LnGemmParams<Epi> p) {
  constexpr int kBN = Epi::kBN, kStageBytes = stage_bytes<Epi>();
  const GemmArgs& g = p.g;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);                  // [kStages][x tile, W tile]
  unsigned char* stages = ring + kStages * kStageBytes;       // [8 warps][Epi::kWarpStage]
  float4* s_gb = reinterpret_cast<float4*>(stages + kConsumerWarps * Epi::kWarpStage);
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
  unsigned char* stage = stages + (wg * 4 + warp) * Epi::kWarpStage;

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
  cudaError_t err = allow_smem<ln_gemm_wgmma_kernel<Epi>>(smem_bytes<Epi>(kMaxC));
  if (err != cudaSuccess) return err;
  // persistent: one block an SM, none without a tile
  const int grid = p.g.n_tiles < sm_count() ? p.g.n_tiles : sm_count();
  ln_gemm_wgmma_kernel<Epi><<<grid, kThreads, smem_bytes<Epi>(p.g.C), stream>>>(p);
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
  g.col_tiles = hidden / GeluEpilogue::kBN;
  g.n_tiles = (R + kBM - 1) / kBM * g.col_tiles;
  if (!encode_2d(&g.tm_x, x, R, C, C, kBM) ||
      !encode_2d(&g.tm_w, w, hidden, C, C, GeluEpilogue::kBN))
    return kNotTmaReady;
  g.mean = static_cast<const float*>(mean);
  g.rstd = static_cast<const float*>(rstd);
  g.gamma = static_cast<const float*>(gamma);
  g.beta = static_cast<const float*>(beta);
  p.e.bias = static_cast<const float*>(bias);
  p.e.h = static_cast<bf16*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_stats(static_cast<const bf16*>(x), static_cast<float*>(mean),
                                    static_cast<float*>(rstd), R, C, eps, s);
  if (err != cudaSuccess) return err;
  return launch_ln_gemm(p, s);
}

// B7. x [B, N, C] bf16; gamma, beta [C] fp32; w [3 H D, C] bf16 (q/k rows
// already in the split-half order when RoPE is on); bias [3 H D] fp32;
// cos, sin [tb, N, D] fp32 (null: no RoPE; tb 1 or B) -> q, k, v
// [B, H, N, D] bf16, mean and rstd [B, N] fp32. x and w contiguous; q, k, v
// contiguous and 16-byte aligned; bias, cos and sin 8-byte aligned. A
// column tile of the GEMM holds `heads` whole heads of one of q, k, v: the
// caller's tile plan (`ops/ln_qkv.py:qkv_heads_per_tile`), one of D 32 with
// 6 or 4, D 64 with 4 or 2, D 80 or 88 with 2, dividing H. Returns the
// cudaError_t of the launches (0 on success); cudaErrorInvalidValue,
// launching nothing, for arguments it does not take; kNotTmaReady,
// launching nothing, when x or w is not 16-byte aligned.
extern "C" int vjepa2_ln_qkv_bf16(const void* x, const void* gamma, const void* beta,
                                  const void* w, const void* bias, const void* cos_t,
                                  const void* sin_t, void* q, void* k, void* v, void* mean,
                                  void* rstd, int B, int N, int C, int H, int D, int heads,
                                  int tb, float eps, void* stream) {
  const int R = B * N;
  if (B <= 0 || N <= 0 || !ln_width_ok(C) || heads <= 0 || H % heads != 0 ||
      (cos_t != nullptr && tb != 1 && tb != B) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || reinterpret_cast<uintptr_t>(bias) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(cos_t) % 8 != 0 || reinterpret_cast<uintptr_t>(sin_t) % 8 != 0)
    return cudaErrorInvalidValue;
  GemmArgs g;
  g.R = R;
  g.C = C;
  g.n_out = 3 * H * D;
  g.col_tiles = g.n_out / (D * heads);
  g.n_tiles = (R + kBM - 1) / kBM * g.col_tiles;
  if (!encode_2d(&g.tm_x, x, R, C, C, kBM) || !encode_2d(&g.tm_w, w, g.n_out, C, C, D * heads))
    return kNotTmaReady;
  g.mean = static_cast<const float*>(mean);
  g.rstd = static_cast<const float*>(rstd);
  g.gamma = static_cast<const float*>(gamma);
  g.beta = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto epi) {
    using Epi = decltype(epi);
    LnGemmParams<Epi> p;
    p.g = g;
    p.e.bias = static_cast<const float*>(bias);
    p.e.q = static_cast<bf16*>(q);
    p.e.k = static_cast<bf16*>(k);
    p.e.v = static_cast<bf16*>(v);
    p.e.cos = static_cast<const float*>(cos_t);
    p.e.sin = static_cast<const float*>(sin_t);
    p.e.N = N;
    p.e.H = H;
    p.e.tb = cos_t != nullptr ? tb : 1;
    cudaError_t err = launch_ln_stats(static_cast<const bf16*>(x), static_cast<float*>(mean),
                                      static_cast<float*>(rstd), R, C, eps, s);
    return err != cudaSuccess ? err : launch_ln_gemm(p, s);
  };
  switch (D * 16 + heads) {  // the instantiated tiles
    case 32 * 16 + 6: return run(QkvEpilogue<32, 6>{});
    case 32 * 16 + 4: return run(QkvEpilogue<32, 4>{});
    case 64 * 16 + 4: return run(QkvEpilogue<64, 4>{});
    case 64 * 16 + 2: return run(QkvEpilogue<64, 2>{});
    case 80 * 16 + 2: return run(QkvEpilogue<80, 2>{});
    case 88 * 16 + 2: return run(QkvEpilogue<88, 2>{});
    default: return cudaErrorInvalidValue;
  }
}
