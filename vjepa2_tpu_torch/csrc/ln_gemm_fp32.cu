// The fused LayerNorm prologues on fp32 operands, for Hopper (sm_90a): LN +
// fc1 + GELU (kernel B8) and LN + qkv + RoPE (kernel B7), every product
// three TF32 products on wgmma ("3xTF32", `flash_fp32.cuh`), which keeps
// fp32's accuracy on the tensor cores.
//
// Replace the TPU kernels `vjepa2_tpu/ops/ln_mlp.py:78 _ln_mlp_kernel`
// (`pallas_call` `:106`) and `vjepa2_tpu/ops/ln_qkv.py:50 _ln_qkv_kernel`
// (`:108`) on fp32 operands: JAX's kernels are generic in the storage
// dtype, and its fp32 models (its default precision) send them fp32 rows
// and weights. bf16 operands take `ln_gemm_hopper.cu`. Same contract as
// there, at fp32:
//   * B8: x [R, C] fp32 -> LN (fp32 two-pass statistics, `ln_common.cuh`)
//     -> y fp32 (not rounded: the plain version's y.to(x.dtype) is the
//     identity) -> z = y W^T + b -> exact GELU (`erff`) -> h [R, hidden]
//     fp32, plus mean and rstd [R]. W [hidden, C] fp32 (`fc1.weight`).
//     C in {384, 1024, 1280, 1408}, hidden in {1536, 4096, 5120, 6144};
//   * B7: x [B, N, C] fp32 -> LN -> y W^T + b (the bias in fp32) ->
//     split-half RoPE on q and k (`rope_pair`'s roundings) -> q, k, v
//     [B, H, N, D] fp32, plus mean and rstd [B, N]. W [3 H D, C] fp32
//     (`qkv.weight`, the q/k rows in the split-half order under RoPE);
//     D in {32, 64, 80, 88}.
//
// The arithmetic: y = ((x - mean) * rstd) * gamma + beta with rounded steps,
// as B6 and the plain version compute it; y = y_hi + y_lo and W = W_hi +
// W_lo, each part rounded to tf32 with `cvt.rna` (ties away from zero); the
// product is y_lo W_hi + y_hi W_lo + y_hi W_hi, summed in fp32 on the tensor
// cores, the small terms first (y_lo W_lo, below 2^-22, is dropped). One
// accumulator runs over all of K (at most 1408 / 8 = 176 k-steps of three
// products): the flash kernels keep a running sum in registers because
// their chains reach 36,864 keys, where the tensor cores' truncating adds
// drift to ~1e-4. Here the drift grows with C, 2.5e-6 relative L2 against
// the plain version at C 384, 7e-6 at 1024 and 1e-5 at 1408 on an H100,
// within the fp32 kernels' 2e-5; a running sum would take 64 more
// registers a thread, where the consumers already use the 168 a block of
// 384 threads allows (no spill).
//
// What bounds them on this card: the tensor cores. B8 at [16384, 1024] ->
// 4096 is 137 GFLOP of fp32-accurate products: 0.83 ms at 495/3 TFLOP/s,
// against 0.11 ms to read x and W and write h; B7 at [16384, 1024] -> 3072
// is 103 GFLOP: 0.62 ms.
//
// Design (`bhnd_hopper.cuh` for the machinery, the mainloop of
// `ln_gemm_hopper.cu` at fp32):
//   * launch 1, `ln_stats_kernel` (`ln_common.cuh`) on fp32 rows: mean and
//     rstd [R], which are outputs anyway;
//   * launch 2, `ln_split_w_kernel`: W's tf32 parts, hi rows then lo rows,
//     into a scratch [2 n_out, C] fp32 the caller allocates, once a call.
//     wgmma's tf32 B operand comes from shared memory as it lies, so W is
//     split before the mainloop loads it; splitting it in shared memory
//     after each load would redo the split once per 128-row tile (128 times
//     at 16,384 rows) and need the consumers to write the ring. The split
//     moves 3 bytes per byte of W (12.6 MB at ViT-L's qkv, 16.8 MB at its
//     fc1: ~15-20 us), against a product of 0.6-0.8 ms;
//   * launch 3, `ln_gemm_tf32_kernel`: persistent, one block an SM walking
//     128 x BN output tiles (row tiles outer, column tiles inner; BN 128
//     for B8, heads x D for B7, at most 128); a producer warp feeds a ring
//     of up to 4 stages by TMA with boxes of x [128 rows x 32 K] and of W's
//     hi and lo rows [BN x 32 K], 128-byte swizzled (32 fp32 a row), x
//     zero-filled past R. A stage is 48 KB at BN 128 (the bf16 kernel's BN
//     256 with both parts of W would be 80 KB a stage: two stages only);
//   * two consumer warpgroups of 64 rows share each stage. Each normalises
//     its x rows in fp32 from the swizzled tile with the row's mean and
//     rstd and gamma and beta from shared memory, splits y into its tf32
//     register A fragments (hi and lo), and issues the three products of
//     two k-steps of 8 (wgmma m64nBNk8, tf32) at once, while the next two
//     k-steps are normalised into a second pair of fragments: the
//     normalisation overlaps the tensor cores, and a consumer thread holds
//     BN / 2 accumulators and 32 fragment registers (168 registers in all
//     on an H100, no spill);
//   * the epilogues read the accumulators where they lie and store fp32
//     pairs straight out (a warp's store fills whole 32-byte sectors): B8
//     adds the bias and applies GELU; B7 takes whole heads of one of q, k,
//     v a tile (`ops/ln_qkv.py:qkv_heads_per_tile` at fp32), adds the bias
//     and rotates q and k in registers (a RoPE pair's partner lies in the
//     same thread, or at D 88 in lane ^ 2). Rows past R are neither read as
//     data (their statistics are not loaded) nor written; a stack-pad row of
//     zeros normalises to beta.

#include "flash_fp32.cuh"  // tf32 split, wgmma_tf32_rs, mma3_rs
#include "ln_common.cuh"

namespace {

constexpr int kFBM = 128;                  // rows a tile, 64 a consumer warpgroup
constexpr int kFBK = 32;                   // K a ring stage: one 128-byte swizzled row of fp32
constexpr int kFKSteps = 2;                // k-steps of 8 a group of products
constexpr int kFXTile = kFBM * kRowBytes;  // 16 KB
constexpr int kFMaxC = 1408;
constexpr int kFMaxStages = 4;
// the ring's room: a block's shared memory less the 1024-byte alignment,
// gamma and beta at the widest C, and the barriers
constexpr int kFRingRoom = 232448 - 1024 - kFMaxC * 8 - 2 * kFMaxStages * 8;

// What the mainloop reads, whatever its epilogue.
struct F32GemmArgs {
  CUtensorMap tm_x;  // x [R, C]: boxes of 32 K x kFBM rows
  CUtensorMap tm_w;  // W's tf32 parts [2 n_out, C] (hi rows, then lo rows): 32 K x Epi::kBN
  const float* mean;  // [R]
  const float* rstd;
  const float* gamma;  // [C]
  const float* beta;
  int R, C, n_out, col_tiles, n_tiles;
};

template <class Epi>
struct F32Params {
  F32GemmArgs g;
  typename Epi::Args e;
};

// A ring stage: the x tile, then W's hi and lo tiles of an epilogue's width.
template <class Epi>
__host__ __device__ constexpr int f_stage_bytes() {
  return kFXTile + 2 * Epi::kBN * kRowBytes;
}
template <class Epi>
__host__ __device__ constexpr int f_stages() {
  return kFRingRoom / f_stage_bytes<Epi>() < kFMaxStages ? kFRingRoom / f_stage_bytes<Epi>()
                                                         : kFMaxStages;
}
template <class Epi>  // ring, gamma and beta, barriers, alignment
__host__ __device__ constexpr int f_smem_bytes(int C) {
  return f_stages<Epi>() * f_stage_bytes<Epi>() + C * 8 + 2 * f_stages<Epi>() * 8 + 1024;
}

__device__ __forceinline__ float gelu_exact(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// W [n_out, C] fp32 -> its tf32 parts: hi = rna(w) at out[i], lo = rna(w -
// hi) at out[n4 + i] (fp32 bit patterns), four elements a thread and step.
__global__ void __launch_bounds__(256)
    ln_split_w_kernel(const float4* __restrict__ w, uint4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    const float4 v = w[i];
    uint4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    out[i] = hi;
    out[n4 + i] = lo;
  }
}

// B8's epilogue: h = gelu(acc + bias) for the warp's 16 rows from row0 and
// the tile's columns from n0, stored as fp32 pairs.
struct GeluEpilogueF32 {
  static constexpr int kBN = 128;  // output columns a tile
  struct Args {
    const float* bias;  // [n_out]
    float* h;           // [R, n_out]
  };
  static __device__ __forceinline__ void store(const float (&acc)[kBN / 2], const Args& e,
                                               const F32GemmArgs& g, int row0, int n0, int lane) {
    const int t4 = lane & 3, gq = lane >> 2;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const int col = n0 + nt * 8 + 2 * t4;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(e.bias + col));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + gq + 8 * r;
        if (row < g.R) {
          *reinterpret_cast<float2*>(e.h + (long long)row * g.n_out + col) =
              make_float2(gelu_exact(acc[4 * nt + 2 * r] + bb.x),
                          gelu_exact(acc[4 * nt + 2 * r + 1] + bb.y));
        }
      }
    }
  }
};

// B7's epilogue: kHeads whole heads of width D of one of q, k, v a tile.
// Per head: acc + bias in fp32, then, for q and k with tables, the
// split-half rotation, as `ln_gemm_hopper.cu`'s `QkvEpilogue` takes it: a
// thread rotates its own columns; column d's partner d +- D/2 lies in the
// same thread at D % 16 == 0 (D/16 accumulator groups further) and in lane
// ^ 2 at D 88, five or six groups away (a shuffle, which every lane runs).
// Row r of the tile is token (r / N, r % N), so a tile may span two
// examples; the tables are [tb, N, D] and example b reads table b % tb.
// Each row's table entries are loaded before any is needed. Rows past R are
// neither rotated nor written.
template <int D, int kHeads>
struct QkvEpilogueF32 {
  static constexpr int kBN = D * kHeads;
  static constexpr int kG = D / 8;  // 8-column accumulator groups a head
  static_assert(kBN <= 128 && kBN % 8 == 0, "a tile of the fp32 mainloop");
  struct Args {
    const float* bias;  // [3 H D]
    float* q;           // [B, H, N, D] each
    float* k;
    float* v;
    const float* cos;  // null: no RoPE; [tb, N, D]
    const float* sin;
    int N, H, tb;
  };
  static __device__ __forceinline__ void store(const float (&acc)[kBN / 2], const Args& e,
                                               const F32GemmArgs& g, int row0, int n0, int lane) {
    const int t4 = lane & 3, gq = lane >> 2, half = t4 >> 1;
    const int hd = e.H * D, part = n0 / hd, head0 = (n0 % hd) / D;
    float* out = part == 0 ? e.q : (part == 1 ? e.k : e.v);
    const bool rotate = part < 2 && e.cos != nullptr;  // uniform across the block
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + gq + 8 * r;
      float2 tc[kG], ts[kG];
      if (rotate) {
        const int tr = min(row, g.R - 1);
        const long long tab = ((long long)((tr / e.N) % e.tb) * e.N + tr % e.N) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          tc[j] = __ldg(reinterpret_cast<const float2*>(e.cos + tab + j * 8));
          ts[j] = __ldg(reinterpret_cast<const float2*>(e.sin + tab + j * 8));
        }
      }
      const int b = row / e.N, n = row % e.N;
#pragma unroll
      for (int hl = 0; hl < kHeads; ++hl) {
        float a[kG][2];  // this head's groups at row r, bias added
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(e.bias + n0 + hl * D + j * 8 + 2 * t4));
          a[j][0] = acc[(hl * kG + j) * 4 + 2 * r] + bb.x;
          a[j][1] = acc[(hl * kG + j) * 4 + 2 * r + 1] + bb.y;
        }
        float* dst = out + (((long long)b * e.H + head0 + hl) * e.N + n) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          float x0 = a[j][0], x1 = a[j][1];
          if (rotate) {
            float y0, y1;
            bool lo;
            if constexpr (D % 16 == 0) {
              lo = j < kG / 2;
              const int jp = lo ? j + kG / 2 : j - kG / 2;
              y0 = a[jp][0];
              y1 = a[jp][1];
            } else {
              // column 8 j + 2 t4 + e is in the low half iff 8 j + 4 half < D/2
              lo = 8 * j + 4 * half < D / 2;
              // what the partner lane (the other half) needs from this one
              constexpr int kLoLimit = D / 16;  // groups wholly in the low half
              const int g_lo = j <= kLoLimit ? j + kLoLimit : j - kLoLimit - 1;
              const int g_hi = j < kLoLimit ? j + kLoLimit + 1 : j - kLoLimit;
              const float s0 = half ? a[g_lo][0] : a[g_hi][0];
              const float s1 = half ? a[g_lo][1] : a[g_hi][1];
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
          if (row < g.R) *reinterpret_cast<float2*>(dst + j * 8) = make_float2(x0, x1);
        }
      }
    }
  }
};

template <class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_tf32_kernel(const __grid_constant__ F32Params<Epi> p) {
  constexpr int kBN = Epi::kBN, kStages = f_stages<Epi>(), kStageBytes = f_stage_bytes<Epi>();
  constexpr int kWTile = kBN * kRowBytes;
  const F32GemmArgs& g = p.g;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [kStages][x tile, W hi tile, W lo tile]
  float* s_gamma = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* s_beta = s_gamma + g.C;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_beta + g.C);
  uint64_t* empty = full + kStages;
  const int n_k = g.C / kFBK;  // ring stages a tile

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
        const int m0 = (tile / g.col_tiles) * kFBM, n0 = (tile % g.col_tiles) * kBN;
        for (int j = 0; j < n_k; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &g.tm_x, j * kFBK, m0, &full[s]);
          tma_load_2d(st + kFXTile, &g.tm_w, j * kFBK, n0, &full[s]);
          tma_load_2d(st + kFXTile + kWTile, &g.tm_w, j * kFBK, g.n_out + n0, &full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  for (int i = threadIdx.x; i < g.C; i += 2 * kWgThreads) {
    s_gamma[i] = g.gamma[i];
    s_beta[i] = g.beta[i];
  }
  bar_sync(1, 2 * kWgThreads);

  const int t = threadIdx.x % kWgThreads, warp = t >> 5, lane = t & 31;
  const int t4 = lane & 3;
  const int wrow = wg * 64 + warp * 16;  // this warp's rows in a tile
  const int xr = wrow + (lane >> 2);     // this thread's: xr, xr + 8

  float acc[kBN / 2];
  // tf32 A fragments (hi, lo) of two groups of kFKSteps k-steps: the group in
  // flight and the next
  uint32_t ah[2][kFKSteps][4], al[2][kFKSteps][4];
  float mean[2], rstd[2];

  // Group q of a tile's K (k-steps 2q, 2q + 1: stage q / 2 of the tile, its
  // half q % 2) from the stage's swizzled x tile: y = LN(x) in fp32 split
  // into the A fragments of rows xr and xr + 8, columns t4 and t4 + 4 of each
  // k-step (fragment i: row + 8 (i & 1), column + 4 (i >> 1)).
  auto make_a = [&](uint32_t(&h)[kFKSteps][4], uint32_t(&l)[kFKSteps][4], int q, int st) {
    const float* x = reinterpret_cast<const float*>(ring + st * kStageBytes);
    const int kc = (q >> 1) * kFBK;  // the stage's first column of x
#pragma unroll
    for (int ks = 0; ks < kFKSteps; ++ks) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = ((q & 1) * kFKSteps + ks) * 8 + t4 + 4 * hf;  // column in the stage
        const float gm = s_gamma[kc + c], bt = s_beta[kc + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = xr + 8 * r;
          const float v = x[row * 32 + ((((c >> 2) ^ (row & 7)) << 2) | (c & 3))];
          split_tf32(ln_affine(v, mean[r], rstd[r], gm, bt), h[ks][2 * hf + r], l[ks][2 * hf + r]);
        }
      }
    }
  };
  // the statistics of this thread's rows of a tile (rows past R: not read)
  auto load_stats = [&](int tile, float (&m)[2], float (&rs)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (tile / g.col_tiles) * kFBM + xr + 8 * r;
      m[r] = row < g.R ? g.mean[row] : 0.f;
      rs[r] = row < g.R ? g.rstd[row] : 0.f;
    }
  };

  int it = 0;  // ring stages consumed so far
  const int n_q = 2 * n_k;  // groups of products a tile
  if (blockIdx.x < g.n_tiles) load_stats(blockIdx.x, mean, rstd);
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
    const int m0 = (tile / g.col_tiles) * kFBM, n0 = (tile % g.col_tiles) * kBN;
    // group q's products on `ch`/`cl`; while they run, the stage group q - 1
    // ended is released and group q + 1 is normalised into `nh`/`nl`
    auto group = [&](int q, const uint32_t(&ch)[kFKSteps][4], const uint32_t(&cl)[kFKSteps][4],
                     uint32_t(&nh)[kFKSteps][4], uint32_t(&nl)[kFKSteps][4]) {
      const int st = (it + (q >> 1)) % kStages;
      const unsigned char* w = ring + st * kStageBytes + kFXTile;
      const uint64_t hi = desc_k<kBN>(w, 0) + step_k<kBN>((q & 1) * kFKSteps);
      const uint64_t lo = desc_k<kBN>(w + kWTile, 0) + step_k<kBN>((q & 1) * kFKSteps);
      wgmma_fence();
      mma3_rs<kBN, kFKSteps, kBN>(acc, ch, cl, hi, lo, q > 0);
      wgmma_commit();
      wgmma_wait<1>();  // group q - 1 is done: `nh`/`nl` and, at a stage's end, its stage are free
      if (q > 0 && (q & 1) == 0 && lane == 0) mbar_arrive(&empty[(it + (q >> 1) - 1) % kStages]);
      if (q + 1 < n_q) {
        const int s1 = it + ((q + 1) >> 1);
        if (((q + 1) & 1) == 0) mbar_wait(&full[s1 % kStages], (s1 / kStages) & 1);
        make_a(nh, nl, q + 1, s1 % kStages);
      }
    };
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    make_a(ah[0], al[0], 0, it % kStages);
    fence_regs(acc);
    for (int q = 0; q < n_q; q += 2) {  // n_q is even
      group(q, ah[0], al[0], ah[1], al[1]);
      group(q + 1, ah[1], al[1], ah[0], al[0]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it + n_k - 1) % kStages]);
    it += n_k;
    if (tile + gridDim.x < g.n_tiles) load_stats(tile + gridDim.x, mean, rstd);
    Epi::store(acc, p.e, g, m0 + wrow, n0, lane);
  }
}

// The map of a row-major fp32 matrix [rows, cols] (row stride `ld`
// elements) with boxes of 32 columns (128 bytes) x `box_rows` rows,
// 128-byte swizzle, zeros outside it. False if TMA cannot read it.
inline bool encode_2d_f32(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                          long long ld, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || !aligned16(ptr) || ld % 4 != 0 || rows <= 0 || cols <= 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kFBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The mainloop's maps: x [R, C], and W's parts [2 n_out, C] in `w_split`
// (launch 2 writes them). False (nothing launched) if x or W is not 16-byte
// aligned, which the split's 16-byte reads and TMA need.
inline bool encode_f32(F32GemmArgs& g, const void* x, const void* w, const void* w_split,
                       int box_rows) {
  return aligned16(w) && aligned16(w_split) && encode_2d_f32(&g.tm_x, x, g.R, g.C, g.C, kFBM) &&
         encode_2d_f32(&g.tm_w, w_split, 2LL * g.n_out, g.C, g.C, box_rows);
}

// Launches 1-3: the statistics, W's split, then the mainloop on a
// persistent grid (one block an SM, none without a tile).
template <class Epi>
cudaError_t launch_ln_gemm_f32(const F32Params<Epi>& p, const void* x, const void* w,
                               void* w_split, float* mean, float* rstd, float eps,
                               cudaStream_t stream) {
  cudaError_t err = launch_ln_stats(static_cast<const float*>(x), mean, rstd, p.g.R, p.g.C, eps,
                                    stream);
  if (err != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(p.g.n_out) * p.g.C / 4;
  const long long split_blocks = (n4 + 255) / 256;
  const int split_grid = split_blocks < 8LL * sm_count() ? static_cast<int>(split_blocks)
                                                         : 8 * sm_count();
  ln_split_w_kernel<<<split_grid, 256, 0, stream>>>(static_cast<const float4*>(w),
                                                    static_cast<uint4*>(w_split), n4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem<ln_gemm_tf32_kernel<Epi>>(f_smem_bytes<Epi>(kFMaxC))) != cudaSuccess)
    return err;
  const int grid = p.g.n_tiles < sm_count() ? p.g.n_tiles : sm_count();
  ln_gemm_tf32_kernel<Epi><<<grid, kThreads, f_smem_bytes<Epi>(p.g.C), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// B8 at fp32. x [R, C] fp32; gamma, beta [C] fp32; w [hidden, C] fp32; bias
// [hidden] fp32; w_split [2, hidden, C] fp32 scratch -> h [R, hidden] fp32,
// mean and rstd [R] fp32. x, w contiguous; h and bias 8-byte aligned.
// Returns the cudaError_t of the launches (0 on success);
// cudaErrorInvalidValue, launching nothing, for arguments it does not take;
// kNotTmaReady, launching nothing, when x or w is not 16-byte aligned.
extern "C" int vjepa2_ln_mlp_f32(const void* x, const void* gamma, const void* beta,
                                 const void* w, const void* bias, void* w_split, void* h,
                                 void* mean, void* rstd, int R, int C, int hidden, float eps,
                                 void* stream) {
  if (R <= 0 || !ln_width_ok(C) ||
      (hidden != 1536 && hidden != 4096 && hidden != 5120 && hidden != 6144) ||
      reinterpret_cast<uintptr_t>(h) % 8 != 0 || reinterpret_cast<uintptr_t>(bias) % 8 != 0)
    return cudaErrorInvalidValue;
  F32Params<GeluEpilogueF32> p;
  F32GemmArgs& g = p.g;
  g.R = R;
  g.C = C;
  g.n_out = hidden;
  g.col_tiles = hidden / GeluEpilogueF32::kBN;
  g.n_tiles = (R + kFBM - 1) / kFBM * g.col_tiles;
  if (!encode_f32(g, x, w, w_split, GeluEpilogueF32::kBN)) return kNotTmaReady;
  g.mean = static_cast<const float*>(mean);
  g.rstd = static_cast<const float*>(rstd);
  g.gamma = static_cast<const float*>(gamma);
  g.beta = static_cast<const float*>(beta);
  p.e.bias = static_cast<const float*>(bias);
  p.e.h = static_cast<float*>(h);
  return launch_ln_gemm_f32(p, x, w, w_split, static_cast<float*>(mean),
                            static_cast<float*>(rstd), eps, static_cast<cudaStream_t>(stream));
}

// B7 at fp32. x [B, N, C] fp32; gamma, beta [C] fp32; w [3 H D, C] fp32 (q/k
// rows already in the split-half order when RoPE is on); bias [3 H D] fp32;
// cos, sin [tb, N, D] fp32 (null: no RoPE; tb 1 or B); w_split [2, 3 H D, C]
// fp32 scratch -> q, k, v [B, H, N, D] fp32, mean and rstd [B, N] fp32. x
// and w contiguous; q, k, v contiguous; bias, cos, sin, q, k and v 8-byte
// aligned. A column tile holds `heads` whole heads of one of q, k, v: the
// caller's fp32 tile plan (`ops/ln_qkv.py:qkv_heads_per_tile`), one of D 32
// with 4 or 2, D 64 with 2, D 80 or 88 with 1, dividing H. Returns the
// cudaError_t of the launches (0 on success); cudaErrorInvalidValue,
// launching nothing, for arguments it does not take; kNotTmaReady,
// launching nothing, when x or w is not 16-byte aligned.
extern "C" int vjepa2_ln_qkv_f32(const void* x, const void* gamma, const void* beta,
                                 const void* w, const void* bias, const void* cos_t,
                                 const void* sin_t, void* w_split, void* q, void* k, void* v,
                                 void* mean, void* rstd, int B, int N, int C, int H, int D,
                                 int heads, int tb, float eps, void* stream) {
  auto al8 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 8 == 0; };
  if (B <= 0 || N <= 0 || !ln_width_ok(C) || heads <= 0 || H % heads != 0 ||
      (cos_t != nullptr && tb != 1 && tb != B) || !al8(q) || !al8(k) || !al8(v) || !al8(bias) ||
      !al8(cos_t) || !al8(sin_t))
    return cudaErrorInvalidValue;
  F32GemmArgs g;
  g.R = B * N;
  g.C = C;
  g.n_out = 3 * H * D;
  g.col_tiles = g.n_out / (D * heads);
  g.n_tiles = (g.R + kFBM - 1) / kFBM * g.col_tiles;
  if (!encode_f32(g, x, w, w_split, D * heads)) return kNotTmaReady;
  g.mean = static_cast<const float*>(mean);
  g.rstd = static_cast<const float*>(rstd);
  g.gamma = static_cast<const float*>(gamma);
  g.beta = static_cast<const float*>(beta);
  auto run = [&](auto epi) {
    using Epi = decltype(epi);
    F32Params<Epi> p;
    p.g = g;
    p.e.bias = static_cast<const float*>(bias);
    p.e.q = static_cast<float*>(q);
    p.e.k = static_cast<float*>(k);
    p.e.v = static_cast<float*>(v);
    p.e.cos = static_cast<const float*>(cos_t);
    p.e.sin = static_cast<const float*>(sin_t);
    p.e.N = N;
    p.e.H = H;
    p.e.tb = cos_t != nullptr ? tb : 1;
    return launch_ln_gemm_f32(p, x, w, w_split, static_cast<float*>(mean),
                              static_cast<float*>(rstd), eps, static_cast<cudaStream_t>(stream));
  };
  switch (D * 16 + heads) {  // the instantiated tiles
    case 32 * 16 + 4: return run(QkvEpilogueF32<32, 4>{});
    case 32 * 16 + 2: return run(QkvEpilogueF32<32, 2>{});
    case 64 * 16 + 2: return run(QkvEpilogueF32<64, 2>{});
    case 80 * 16 + 1: return run(QkvEpilogueF32<80, 1>{});
    case 88 * 16 + 1: return run(QkvEpilogueF32<88, 1>{});
    default: return cudaErrorInvalidValue;
  }
}
