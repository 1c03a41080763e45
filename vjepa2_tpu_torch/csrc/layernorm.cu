// LayerNorm forward and backward over bf16 rows, for Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernels `vjepa2_tpu/ops/layernorm.py:103 _ln_fwd_kernel`
// (`pallas_call` `:137`) and `:115 _ln_bwd_kernel` (`:164`). Same contract:
//   * forward: x [R, C] bf16 -> y [R, C] bf16 with fp32 two-pass statistics
//     and affine (`ln_common.cuh`), saving mean and rstd [R] fp32; with no y,
//     the statistics launch of `ln_common.cuh`;
//   * backward: from x, dy (bf16, the dtype of x), gamma and the saved mean
//     and rstd: xhat = (x - mean) * rstd, wdy = dy * gamma,
//     c1 = mean(wdy), c2 = mean(wdy * xhat), dx = (wdy - c1 - xhat * c2) * rstd
//     in x's dtype (`ln_backward_f32:88`); dgamma = sum(dy * xhat) and
//     dbeta = sum(dy) over the rows, fp32 [C].
// C in {384, 1024, 1280, 1408}; rows 16-byte aligned.
//
// What bounds it on this card: memory. Per element the forward does ~8 and
// the backward ~15 fp32 operations against 4 and 6 bytes moved, far below
// the ~295 operations per byte at which the tensor cores' peak would bind
// (and there are no products to give them).
//
// What the design does about it, keeping every SM streaming:
//   * a persistent grid: `ops/layernorm.py:ln_row_plan` splits the R rows
//     into contiguous ranges of `rows_per_block`, two blocks an SM (fewer
//     only when R is smaller), and passes that to the entry points;
//   * a block is kLnFwdWarps (kLnBwdWarps) consumer warps and one producer
//     warp, which starts as soon as the ring's barriers exist. One lane of
//     it copies a stage of rows, contiguous in memory, with one bulk copy a
//     tensor (`cp.async.bulk`, completed on the stage's mbarrier) into a
//     ring of 2 to 8 stages (96 KB at most), so the next stages are in
//     flight while the consumers work on one; the forward frees a stage as
//     soon as its rows are in registers, the backward after its second pass;
//   * the lane groups of `ln_common.cuh`; in the forward a group holds two
//     rows of a stage at once up to C 1024, so that their shuffles
//     interleave;
//   * gamma and beta are read once per block: into registers with 16-byte
//     loads where a lane holds at most kLnRegChunks chunks, into shared
//     memory (read 16 bytes at a time) where it holds more. The backward
//     stages its block's mean and rstd in shared memory the same way, every
//     load in flight at once: loaded row by row, each waited a round trip to
//     device memory, which cost the backward 1-16% on an H100;
//   * the backward's lane groups keep their dgamma and dbeta sums in
//     registers across all the block's rows; at the end the block's groups
//     are summed once through shared memory, in group order, into one
//     partial row per block. A second kernel, launched with programmatic
//     dependent launch so that its launch overlaps the first, sums the
//     partial rows column by column in block order, sixteen rows a warp
//     with all loads in flight. No atomics: the bits
//     are the same from call to call on one card. The grid follows the SM
//     count, so on a card with another SM count only the rounding of
//     dgamma/dbeta differs.

#include "bhnd_hopper.cuh"  // mbarriers, bulk copies, allow_smem
#include "ln_common.cuh"

namespace {

constexpr int kLnFwdWarps = 4;    // consumer warps of a forward block
constexpr int kLnBwdWarps = 4;    // and of a backward block
constexpr int kLnFwdRows = 2;     // rows a lane group holds at once, forward, up to C 1024
constexpr int kLnBwdRows = 1;     // and backward
constexpr int kLnBarBytes = 128;  // the ring's mbarriers (8 stages at most), ahead of it
constexpr int kLnMaxBlockRows = 1024;  // rows a block at most (`LN_MAX_BLOCK_ROWS`)
constexpr int kSumRows = 16;      // partial rows a warp of the sum adds with all loads in flight
constexpr int kSumMaxWarps = 32;  // warps of a block of the sum at most

template <int C>
using FwdLayout = RowLayout<C, ln_lanes<C>(), kLnFwdWarps, C <= 1024 ? kLnFwdRows : 1, 1>;
template <int C>
using BwdLayout = RowLayout<C, ln_lanes<C>(), kLnBwdWarps, kLnBwdRows, 2>;

// Shared memory of a row kernel: the mbarriers, the ring, then kParams fp32
// vectors of C where the layout keeps them there.
template <class L, int C, int kParams>
constexpr int ln_smem_bytes() {
  return kLnBarBytes + L::kRing + (L::kParamsInSmem ? kParams * C * 4 : 0);
}

// A vector of C fp32 values as lane-in-group gl uses it: its chunks in
// registers, or, where the layout keeps it in shared memory, a copy there.
template <class L, int C>
struct RowParams {
  float r[L::kParamsInSmem ? 1 : L::kPerLane][8];
  const float* s;
  // every consumer thread calls it; in shared memory the consumers copy the
  // vector and wait for one another (named barrier 1), so the producer, which
  // does not take part, starts its copies at once
  __device__ __forceinline__ void load(const float* v, float* smem, int gl) {
    if constexpr (L::kParamsInSmem) {
      for (int c = threadIdx.x; c < C / 4; c += L::kWarps * 32)
        reinterpret_cast<float4*>(smem)[c] = reinterpret_cast<const float4*>(v)[c];
      s = smem;
      bar_sync(1, L::kWarps * 32);
    } else {
#pragma unroll
      for (int i = 0; i < L::kPerLane; ++i) {
        if (L::has(gl, i)) load8(v + L::chunk(gl, i) * 8, r[i]);
      }
    }
  }
  __device__ __forceinline__ void get(int gl, int i, float (&f)[8]) const {
    if constexpr (L::kParamsInSmem) {
      load8(s + L::chunk(gl, i) * 8, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = r[i][e];
    }
  }
};

// The producer: for each stage of the block's `rows` rows from `row0`, wait
// until the consumers freed its slot, then copy the stage's rows of each of
// the kSrcs tensors into it with one bulk copy each. One lane runs it.
template <class L, int C, int kSrcs>
__device__ __forceinline__ void ring_produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                             const bf16* const (&src)[kSrcs], long long row0,
                                             int rows) {
  constexpr int kStageRows = L::kStageRows, kStages = L::kStages;
  constexpr int kStageBytes = L::kStageBytes;
  const int n_stages = (rows + kStageRows - 1) / kStageRows;
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % kStages;
    if (s >= kStages) mbar_wait(&empty[slot], (s / kStages - 1) & 1);
    const int n = min(kStageRows, rows - s * kStageRows);
    const uint32_t bytes = static_cast<uint32_t>(n) * C * 2;
    mbar_expect_tx(&full[slot], bytes * kSrcs);
#pragma unroll
    for (int k = 0; k < kSrcs; ++k) {
      bulk_load(ring + slot * kStageBytes + k * (kStageRows * C * 2),
                src[k] + (row0 + static_cast<long long>(s) * kStageRows) * C, bytes, &full[slot]);
    }
  }
}

// The ring's barriers, made visible to the block (every thread calls it).
template <class L>
__device__ __forceinline__ void ln_init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// B6 forward over x [R, C]: y [R, C] bf16, mean and rstd [R] fp32. Block b
// owns rows [b * rows_per_block, ...).
template <int C>
__global__ void __launch_bounds__(FwdLayout<C>::kThreads, 2)
    ln_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out, int R,
                  int rows_per_block, float eps) {
  using L = FwdLayout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + L::kStages;
  unsigned char* ring = smem + kLnBarBytes;
  float* s_params = reinterpret_cast<float*>(ring + L::kRing);
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), R - row0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp * L::kRowsPerWarp + lane / L::kLanes_, gl = lane % L::kLanes_;
  ln_init_ring<L>(full, empty);
  if (warp == L::kWarps) {
    if (lane == 0) {
      const bf16* const src[1] = {x};
      ring_produce<L, C, 1>(ring, full, empty, src, row0, rows);
    }
    return;
  }
  RowParams<L, C> gam, bet;  // while the first stages are in flight
  gam.load(gamma, s_params, gl);
  bet.load(beta, s_params + C, gl);
  const int n_stages = (rows + L::kStageRows - 1) / L::kStageRows;
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % L::kStages;
    mbar_wait(&full[slot], (s / L::kStages) & 1);
    const bf16* stage = reinterpret_cast<const bf16*>(ring + slot * L::kStageBytes);
    uint4 u[L::kRows][L::kPerLane];
#pragma unroll
    for (int k = 0; k < L::kRows; ++k) {
      const int j = L::row_of(grp, k);
      load_row<L>(u[k], stage + j * C, s * L::kStageRows + j < rows, gl);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the rows are in registers: free the slot
    float mean[L::kRows], rstd[L::kRows];
    row_stats<L, C>(u, gl, eps, mean, rstd);
#pragma unroll
    for (int k = 0; k < L::kRows; ++k) {
      const int j = L::row_of(grp, k);
      if (s * L::kStageRows + j >= rows) continue;
      const long long row = row0 + s * L::kStageRows + j;
      if (gl == 0) {
        mean_out[row] = mean[k];
        rstd_out[row] = rstd[k];
      }
#pragma unroll
      for (int i = 0; i < L::kPerLane; ++i) {
        if (L::has(gl, i)) {
          float f[8], gv[8], bv[8];
          unpack8(u[k][i], f);
          gam.get(gl, i, gv);
          bet.get(gl, i, bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = ln_affine(f[e], mean[k], rstd[k], gv[e], bv[e]);
          *reinterpret_cast<uint4*>(y + row * C + L::chunk(gl, i) * 8) = pack8(f);
        }
      }
    }
  }
}

template <int C>
cudaError_t launch_ln_fwd_c(const bf16* x, const float* gamma, const float* beta, bf16* y,
                            float* mean, float* rstd, int R, int rows_per_block, float eps,
                            cudaStream_t stream) {
  constexpr int smem = ln_smem_bytes<FwdLayout<C>, C, 2>();
  const cudaError_t err = allow_smem<ln_fwd_kernel<C>>(smem);
  if (err != cudaSuccess) return err;
  ln_fwd_kernel<C><<<(R + rows_per_block - 1) / rows_per_block, FwdLayout<C>::kThreads, smem,
                     stream>>>(
      x, gamma, beta, y, mean, rstd, R, rows_per_block, eps);
  return cudaGetLastError();
}

// Launch `ln_fwd_kernel` over ceil(R / rows_per_block) blocks for a width the
// kernels take (else cudaErrorInvalidValue).
inline cudaError_t launch_ln_fwd(const bf16* x, const float* gamma, const float* beta, bf16* y,
                                 float* mean, float* rstd, int R, int C, int rows_per_block,
                                 float eps, cudaStream_t stream) {
  if (R <= 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return launch(x, gamma, beta, y, mean, rstd, R, rows_per_block, eps, stream);
  };
  switch (C) {
    case 384: return run(launch_ln_fwd_c<384>);
    case 1024: return run(launch_ln_fwd_c<1024>);
    case 1280: return run(launch_ln_fwd_c<1280>);
    case 1408: return run(launch_ln_fwd_c<1408>);
    default: return cudaErrorInvalidValue;
  }
}

// B6 backward: block b owns rows [b * rows_per_block, ...) and writes its
// partial row of dgamma and dbeta to dg_part[b], db_part[b].
template <int C>
__global__ void __launch_bounds__(BwdLayout<C>::kThreads, 2)
    ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ mean,
                  const float* __restrict__ rstd, bf16* __restrict__ dx,
                  float* __restrict__ dg_part, float* __restrict__ db_part, int R,
                  int rows_per_block) {
  using L = BwdLayout<C>;
  constexpr int kRows = L::kRows;
  static_assert(2 * L::kGroups * C * 4 <= L::kRing, "the block's sums reuse the ring");
  // the sum kernel may take its SMs' spare room now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + L::kStages;
  unsigned char* ring = smem + kLnBarBytes;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), R - row0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp * L::kRowsPerWarp + lane / L::kLanes_, gl = lane % L::kLanes_;
  ln_init_ring<L>(full, empty);
  if (warp == L::kWarps) {
    if (lane == 0) {
      const bf16* const src[2] = {x, dy};
      ring_produce<L, C, 2>(ring, full, empty, src, row0, rows);
    }
    return;
  }
  // while the first stages are in flight: gamma, and the block's mean and
  // rstd, all loads in flight at once (a row's own loads would wait a round
  // trip to device memory each)
  float* s_mean = reinterpret_cast<float*>(ring + L::kRing);
  float* s_rstd = s_mean + kLnMaxBlockRows;
  for (int i = threadIdx.x; i < rows; i += L::kWarps * 32) {
    s_mean[i] = mean[row0 + i];
    s_rstd[i] = rstd[row0 + i];
  }
  RowParams<L, C> gam;
  gam.load(gamma, s_rstd + kLnMaxBlockRows, gl);
  bar_sync(1, L::kWarps * 32);

  float dg[L::kPerLane][8], db[L::kPerLane][8];
#pragma unroll
  for (int i = 0; i < L::kPerLane; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[i][e] = db[i][e] = 0.f;
  }
  const int n_stages = (rows + L::kStageRows - 1) / L::kStageRows;
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % L::kStages;
    bool valid[kRows];
    float m[kRows], r[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = s * L::kStageRows + L::row_of(grp, k);
      valid[k] = j < rows;
      // a row the stage does not hold is zeros with mean and rstd 0: it adds nothing
      m[k] = valid[k] ? s_mean[j] : 0.f;
      r[k] = valid[k] ? s_rstd[j] : 0.f;
    }
    mbar_wait(&full[slot], (s / L::kStages) & 1);
    const bf16* xs = reinterpret_cast<const bf16*>(ring + slot * L::kStageBytes);
    const bf16* ds = xs + L::kStageRows * C;
    float c1[kRows], c2[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = L::row_of(grp, k) * C;
      float s1[8] = {}, s2[8] = {};  // eight sums each, so that no add waits for the one before
#pragma unroll
      for (int i = 0; i < L::kPerLane; ++i) {
        if (valid[k] && L::has(gl, i)) {
          const int c = L::chunk(gl, i) * 8;
          float xf[8], df[8], gv[8];
          unpack8(*reinterpret_cast<const uint4*>(xs + j + c), xf);
          unpack8(*reinterpret_cast<const uint4*>(ds + j + c), df);
          gam.get(gl, i, gv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xhat = (xf[e] - m[k]) * r[k];
            const float wdy = df[e] * gv[e];
            s1[e] += wdy;
            s2[e] += wdy * xhat;
          }
        }
      }
      c1[k] = sum8(s1);
      c2[k] = sum8(s2);
    }
    group_sums<L::kLanes_>(c1);
    group_sums<L::kLanes_>(c2);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      c1[k] /= C;
      c2[k] /= C;
      const int j = L::row_of(grp, k) * C;
      const long long row = row0 + s * L::kStageRows + L::row_of(grp, k);
#pragma unroll
      for (int i = 0; i < L::kPerLane; ++i) {
        if (valid[k] && L::has(gl, i)) {
          const int c = L::chunk(gl, i) * 8;
          float xf[8], df[8], gv[8], out[8];
          unpack8(*reinterpret_cast<const uint4*>(xs + j + c), xf);
          unpack8(*reinterpret_cast<const uint4*>(ds + j + c), df);
          gam.get(gl, i, gv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xhat = (xf[e] - m[k]) * r[k];
            const float wdy = df[e] * gv[e];
            out[e] = (wdy - c1[k] - xhat * c2[k]) * r[k];
            dg[i][e] += df[e] * xhat;
            db[i][e] += df[e];
          }
          *reinterpret_cast<uint4*>(dx + row * C + c) = pack8(out);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // the block's partial row: the groups' sums added in group order, through
  // the ring (every stage has been read)
  bar_sync(1, L::kWarps * 32);
  float* red = reinterpret_cast<float*>(ring);  // [2][kGroups][C]
#pragma unroll
  for (int i = 0; i < L::kPerLane; ++i) {
    if (L::has(gl, i)) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[grp * C + L::chunk(gl, i) * 8 + e] = dg[i][e];
        red[(L::kGroups + grp) * C + L::chunk(gl, i) * 8 + e] = db[i][e];
      }
    }
  }
  bar_sync(1, L::kWarps * 32);
  for (int col = threadIdx.x; col < 2 * C; col += L::kWarps * 32) {
    const int which = col / C, c = col % C;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < L::kGroups; ++k) sum += red[(which * L::kGroups + k) * C + c];
    (which ? db_part : dg_part)[static_cast<long long>(blockIdx.x) * C + c] = sum;
  }
}

// dgamma, dbeta [2][C] from the partial rows part [2][parts][C]: a block
// sums 32 columns of one of the two; its warps, as many as make kSumRows
// rows each (at most kSumMaxWarps), warp w the parts [w * per, (w + 1) *
// per) in order, then the warps in order: the order depends on `parts`
// alone. Launched as a programmatic dependent of `ln_bwd_kernel`: it waits
// for that grid's end and memory.
template <int C>
__global__ void __launch_bounds__(kSumMaxWarps * 32)
    ln_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int parts) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float red[kSumMaxWarps][32];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int which = blockIdx.x / (C / 32), col = blockIdx.x % (C / 32) * 32 + lane;
  const float* p = part + static_cast<long long>(which) * parts * C + col;
  const int per = (parts + warps - 1) / warps;
  const int lo = min(parts, warp * per), hi = min(parts, lo + per);
  float sum = 0.f;
  for (int k = lo; k < hi; k += kSumRows) {  // all loads in flight, added in order
    float v[kSumRows];
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      v[u] = k + u < hi ? p[static_cast<long long>(k + u) * C] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) sum += v[u];
  }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += red[w][lane];
    out[which * C + col] = total;
  }
}

template <int C>
cudaError_t launch_ln_bwd(const bf16* x, const bf16* dy, const float* gamma, const float* mean,
                          const float* rstd, bf16* dx, float* dparams, float* part, int R,
                          int rows_per_block, cudaStream_t stream) {
  constexpr int smem = ln_smem_bytes<BwdLayout<C>, C, 1>() + 2 * kLnMaxBlockRows * 4;
  cudaError_t err = allow_smem<ln_bwd_kernel<C>>(smem);
  if (err != cudaSuccess) return err;
  const int grid = (R + rows_per_block - 1) / rows_per_block;
  ln_bwd_kernel<C><<<grid, BwdLayout<C>::kThreads, smem, stream>>>(
      x, dy, gamma, mean, rstd, dx, part, part + static_cast<long long>(grid) * C, R,
      rows_per_block);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * C / 32);
  cfg.blockDim = dim3(32 * min(kSumMaxWarps, (grid + kSumRows - 1) / kSumRows));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ln_bwd_sum_kernel<C>, static_cast<const float*>(part), dparams,
                            grid);
}

}  // namespace

// The lane group of B6's kernels at width C: lanes a row and 16-byte chunks
// a lane (the forward's, the statistics launch's and the backward's alike).
// 0 on success, cudaErrorInvalidValue for a width they do not take.
extern "C" int vjepa2_layernorm_layout(int C, int* lanes, int* per_lane) {
  switch (C) {
    case 384: *lanes = ln_lanes<384>(); break;
    case 1024: *lanes = ln_lanes<1024>(); break;
    case 1280: *lanes = ln_lanes<1280>(); break;
    case 1408: *lanes = ln_lanes<1408>(); break;
    default: return cudaErrorInvalidValue;
  }
  *per_lane = (C / 8 + *lanes - 1) / *lanes;
  return 0;
}

// x [R, C] bf16 -> y [R, C] bf16, mean and rstd [R] fp32; gamma, beta [C]
// fp32. Block b takes rows [b * rows_per_block, (b + 1) * rows_per_block)
// (`ops/layernorm.py:ln_row_plan`). A null y launches the statistics kernel
// instead, which writes only mean and rstd and takes no plan. Every array
// contiguous; x, y, gamma and beta 16-byte aligned. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int vjepa2_layernorm_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                         void* y, void* mean, void* rstd, int R, int C,
                                         int rows_per_block, float eps, void* stream) {
  if (R <= 0 || !ln_width_ok(C) || !aligned16(x) || !aligned16(gamma) || !aligned16(beta) ||
      (y != nullptr && !aligned16(y)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y == nullptr) {
    return launch_ln_stats(static_cast<const bf16*>(x), static_cast<float*>(mean),
                           static_cast<float*>(rstd), R, C, eps, s);
  }
  return launch_ln_fwd(static_cast<const bf16*>(x), static_cast<const float*>(gamma),
                       static_cast<const float*>(beta), static_cast<bf16*>(y),
                       static_cast<float*>(mean), static_cast<float*>(rstd), R, C, rows_per_block,
                       eps, s);
}

// x, dy [R, C] bf16, gamma [C], mean and rstd [R] fp32 -> dx [R, C] bf16 and
// dparams [2, C] fp32 (dgamma, dbeta), through the scratch part [2, grid, C]
// fp32 of partial rows, grid = ceil(R / rows_per_block). Every array
// contiguous; x, dy, dx and gamma 16-byte aligned. Two launches, the second
// a programmatic dependent of the first. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int vjepa2_layernorm_bwd_bf16(const void* x, const void* dy, const void* gamma,
                                         const void* mean, const void* rstd, void* dx,
                                         void* dparams, void* part, int R, int C,
                                         int rows_per_block, void* stream) {
  if (R <= 0 || rows_per_block <= 0 || rows_per_block > kLnMaxBlockRows || !ln_width_ok(C) ||
      !aligned16(x) || !aligned16(dy) || !aligned16(dx) || !aligned16(gamma))
    return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dyp = static_cast<const bf16*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  bf16* dxp = static_cast<bf16*>(dx);
  float* dpp = static_cast<float*>(dparams);
  float* pp = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 384: return launch_ln_bwd<384>(xp, dyp, g, m, r, dxp, dpp, pp, R, rows_per_block, s);
    case 1024: return launch_ln_bwd<1024>(xp, dyp, g, m, r, dxp, dpp, pp, R, rows_per_block, s);
    case 1280: return launch_ln_bwd<1280>(xp, dyp, g, m, r, dxp, dpp, pp, R, rows_per_block, s);
    default: return launch_ln_bwd<1408>(xp, dyp, g, m, r, dxp, dpp, pp, R, rows_per_block, s);
  }
}
