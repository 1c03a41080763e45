// The fp32 flash kernels' pre-pass (`flash_fp32.cuh`): each operand that a
// product reads from shared memory, split once a call into its tf32 parts
// x = hi + lo, in the layouts the products need, and the backward's row
// statistics. Replaces no TPU kernel: the TPU's fp32 matrix unit needs no
// split; it exists for the 3xTF32 products of B3 and B4/B5 on fp32 operands.
// It also takes the TPU kernels' RoPE prologue (`flash_attention.py:208-211`,
// `_rope_rotate :112`): q and k are rotated here, once a call, in fp32.
//
//   * `flash_fp32_split_kernel`: an operand [B, H, n, D] (strides; float4 reads
//     where it is unit-stride along d; where it is unit-stride along the
//     tokens, the DN layout [B, H, D, n] of B1/B2, a warp reads 32 tokens of
//     one feature with scalar loads, at any alignment, `stage_tokens`)
//     -> token-major hi/lo [2][B][H][n][D] and/or feature-major hi/lo
//     [2][B][H][D][np] (np = n rounded up to 8, pad tokens zero), the latter
//     with its tokens permuted in each group of 8 (`permuted`). A block stages
//     64 tokens in shared memory, so both writes are coalesced; with tables
//     it rotates the staged tokens there first (`rope_pair`: each product and
//     sum rounded once, the plain version's `rope_rotate`), then splits the
//     rotated values. With kv_valid the wrapper passes the valid keys as n,
//     so only those are split. Both layouts give the same copies, bit for bit;
//   * `flash_fp32_stats_kernel`: delta = rowsum(dout * out) in fp32 and
//     lse * log2(e) (+inf where lse is -inf, and past N), [B, H, Np], a warp a
//     row, where out and dout are unit-stride along d; otherwise
//     `flash_fp32_stats_staged_kernel`, which stages 32 rows of each through
//     shared memory first and then sums in the same order (equal bits);
//   * `flash_fp32_plan_kernel`: the masked kernels' tile plan (segment ids or
//     the causal mask; `ops/flash_attention.py mask_tile_plan` is its plain
//     version): for each block of rows (queries, or keys for dK/dV) the
//     tiles of columns that hold an attended pair, in order, each marked
//     partial (`kPartialTile`) where one of its pairs is masked. A block of
//     128 threads a row block: the rows' smallest and largest id (positions
//     under causal, the same predicate j <= i), then, 128 tiles at a time,
//     each thread its tile's, and an ordered compaction by a block scan.
// What bounds it: bytes, O(N*D): at [1,16,36864,88] the backward's pre-pass
// reads 0.8 GB and writes 2.9 GB, next to the main kernels' O(N^2 D) work.

#include <climits>

#include "flash_fp32.cuh"

namespace {

constexpr int kSplitRows = 64;  // tokens a block

struct SplitParams {
  const float* x;    // [B, H, n, D] at element strides (b, h, n, d): unit along d, or along n
  long long sb, sh, sn, sd;
  const float* cos;  // split-half tables [B|1, >= n, D] at (t_b, t_n, t_d), unit along d or
  const float* sin;  // along n; null: no rotation
  long long t_b, t_n, t_d;
  float* nat;        // [2][B][H][n][D], or null
  float* tr;         // [2][B][H][D][np], or null
  int B, H, n, np;
};

// hi/lo of 4 consecutive features of a token-major row, one 16-byte store each.
__device__ __forceinline__ void store_split4(float* dst, long long part, float4 v) {
  uint4 hi, lo;
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(dst) = hi;
  *reinterpret_cast<uint4*>(dst + part) = lo;
}

// Tokens t0 .. t0 + kRows - 1 of x (token n, feature d at n * sn + d * sd)
// into tile[r][d], zeros at and past n_valid, with scalar loads in the order
// its layout coalesces: along d where sd is 1, else along the tokens (the DN
// layout: consecutive threads take consecutive tokens of one feature; the
// tile's odd row stride keeps their stores on distinct banks).
template <int D, int kRows>
__device__ __forceinline__ void stage_tokens(float (&tile)[kRows][D + 1], const float* x,
                                             long long sn, long long sd, int t0, int n_valid) {
  if (sd == 1) {
    for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D, n = t0 + r;
      tile[r][d] = n < n_valid ? x[n * sn + d] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
      const int d = i / kRows, r = i - d * kRows, n = t0 + r;
      tile[r][d] = n < n_valid ? x[n * sn + d * sd] : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_fp32_split_kernel(const SplitParams p) {
  constexpr int kVec = D / 4, kHalf = D / 2;
  __shared__ float tile[kSplitRows][D + 1];  // D + 1: a warp's column reads hit 32 banks
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kSplitRows;
  const long long bh = (long long)b * p.H + h;
  const float* x = p.x + b * p.sb + h * p.sh;
  const long long nat_part = (long long)p.B * p.H * p.n * D;
  const bool rope = p.cos != nullptr, dn = p.sd != 1;
  if (dn) {
    stage_tokens<D, kSplitRows>(tile, x, p.sn, p.sd, t0, p.n);
  } else {
    for (int i = threadIdx.x; i < kSplitRows * kVec; i += blockDim.x) {
      const int r = i / kVec, c = (i - r * kVec) * 4, n = t0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < p.n) v = *reinterpret_cast<const float4*>(x + n * p.sn + c);
      tile[r][c] = v.x;
      tile[r][c + 1] = v.y;
      tile[r][c + 2] = v.z;
      tile[r][c + 3] = v.w;
      if (!rope && p.nat != nullptr && n < p.n) store_split4(p.nat + (bh * p.n + n) * D + c, nat_part, v);
    }
  }
  if (rope) {  // rotate the staged tokens in place, a pair (d, d + D/2) a thread
    __syncthreads();
    const float* cos_t = p.cos + b * p.t_b;
    const float* sin_t = p.sin + b * p.t_b;
    for (int i = threadIdx.x; i < kSplitRows * kHalf; i += blockDim.x) {
      // consecutive threads along the tables' unit stride: d, or the tokens
      const int r = p.t_d == 1 ? i / kHalf : i % kSplitRows;
      const int d = p.t_d == 1 ? i - r * kHalf : i / kSplitRows, n = t0 + r;
      if (n >= p.n) continue;
      const long long at = n * p.t_n + d * p.t_d, hi_at = at + kHalf * p.t_d;
      float lo = tile[r][d], hi = tile[r][d + kHalf];
      rope_pair(lo, hi, cos_t[at], sin_t[at], cos_t[hi_at], sin_t[hi_at]);
      tile[r][d] = lo;
      tile[r][d + kHalf] = hi;
    }
  }
  if ((rope || dn) && p.nat != nullptr) {  // the token-major copy from the staged tokens
    __syncthreads();
    for (int i = threadIdx.x; i < kSplitRows * kVec; i += blockDim.x) {
      const int r = i / kVec, c = (i - r * kVec) * 4, n = t0 + r;
      if (n < p.n) {
        store_split4(p.nat + (bh * p.n + n) * D + c, nat_part,
                     make_float4(tile[r][c], tile[r][c + 1], tile[r][c + 2], tile[r][c + 3]));
      }
    }
  }
  if (p.tr == nullptr) return;
  __syncthreads();
  const long long tr_part = (long long)p.B * p.H * D * p.np;
  for (int i = threadIdx.x; i < D * kSplitRows; i += blockDim.x) {
    const int d = i / kSplitRows, c = i - d * kSplitRows, col = t0 + c;
    if (col >= p.np) continue;
    uint32_t hi, lo;
    split_tf32(tile[(c & ~7) | permuted(c & 7)][d], hi, lo);
    float* dst = p.tr + (bh * D + d) * p.np + col;
    dst[0] = __uint_as_float(hi);
    dst[tr_part] = __uint_as_float(lo);
  }
}

struct StatsParams {
  const float* o;     // out [B, H, N, D] at element strides (b, h, n, d)
  const float* dout;  // the same
  long long ob, oh, on, od, gb, gh, gn, gd;
  const float* lse;   // [B, H, N]
  float* delta;       // [B, H, Np]
  float* lse2;        // [B, H, Np]
  int H, N, Np, D;
};

// A row's delta as a warp sums it: lane l takes features l and l + 32 (an
// fma chain from 0), then the butterfly; feat(d) is (out, dout) at feature d.
template <class Feat>
__device__ __forceinline__ float row_delta(const Feat& feat, int D) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float2 x = feat(d);
    acc = fmaf(x.x, x.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

__device__ __forceinline__ float lse_log2(const StatsParams& p, long long bh, int n) {
  const float l = p.lse[bh * p.N + n];
  return l == -INFINITY ? INFINITY : l * kLog2e;
}

__global__ void __launch_bounds__(256) flash_fp32_stats_kernel(const StatsParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * 8 + warp, h = blockIdx.y, b = blockIdx.z;
  if (n >= p.Np) return;
  const long long bh = (long long)b * p.H + h;
  float acc = 0.f, l2 = INFINITY;  // past N: p = exp2(s - inf) = 0
  if (n < p.N) {
    const float* o = p.o + b * p.ob + h * p.oh + n * p.on;
    const float* g = p.dout + b * p.gb + h * p.gh + n * p.gn;
    acc = row_delta([&](int d) { return make_float2(o[d], g[d]); }, p.D);
    l2 = lse_log2(p, bh, n);
  }
  if (lane == 0) {
    p.delta[bh * p.Np + n] = acc;
    p.lse2[bh * p.Np + n] = l2;
  }
}

// The same statistics where out or dout is not unit-stride along d (the DN
// layout; or a cotangent that is, beside an out that is not): 32 rows a
// block, both staged through shared memory by reads that coalesce in their
// own layouts (`stage_tokens`), then a warp a row as above, so the two
// kernels give equal bits. 32 rows a block: both tiles stay within the 48 KB
// of static shared memory at D 104.
constexpr int kStatsRows = 32;

template <int D>
__global__ void __launch_bounds__(256) flash_fp32_stats_staged_kernel(const StatsParams p) {
  __shared__ float so[kStatsRows][D + 1], sg[kStatsRows][D + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, t0 = blockIdx.x * kStatsRows;
  const long long bh = (long long)b * p.H + h;
  stage_tokens<D, kStatsRows>(so, p.o + b * p.ob + h * p.oh, p.on, p.od, t0, p.N);
  stage_tokens<D, kStatsRows>(sg, p.dout + b * p.gb + h * p.gh, p.gn, p.gd, t0, p.N);
  __syncthreads();
  for (int r = warp; r < kStatsRows; r += 8) {
    const int n = t0 + r;
    const float acc = row_delta([&](int d) { return make_float2(so[r][d], sg[r][d]); }, D);
    if (lane == 0) {
      p.delta[bh * p.Np + n] = acc;
      p.lse2[bh * p.Np + n] = n < p.N ? lse_log2(p, bh, n) : INFINITY;
    }
  }
}

// float4 reads of an operand with element strides st (b, h, n, d).
bool vec4_operand(const void* x, const long long* st, int B, int H, int n) {
  return x != nullptr && aligned16(x) && st[3] == 1 && (B == 1 || st[0] % 4 == 0) &&
         (H == 1 || st[1] % 4 == 0) && (n == 1 || st[2] % 4 == 0);
}

// Scalar reads along the tokens (the DN layout), at any other strides.
bool dn_operand(const void* x, const long long* st) {
  return x != nullptr && st[2] == 1 && st[3] > 0;
}

struct RunSplit {
  template <int D>
  static int run(const SplitParams& p, cudaStream_t s) {
    flash_fp32_split_kernel<D><<<dim3((p.np + kSplitRows - 1) / kSplitRows, p.H, p.B), 256, 0, s>>>(p);
    return cudaGetLastError();
  }
};

struct RunStatsStaged {
  template <int D>
  static int run(const StatsParams& p, int B, cudaStream_t s) {
    flash_fp32_stats_staged_kernel<D><<<dim3(p.Np / kStatsRows, p.H, B), 256, 0, s>>>(p);
    return cudaGetLastError();
  }
};

// The RoPE tables of a call: (cos, sin) or neither, and their strides.
struct Tables {
  const float* cos;
  const float* sin;
  long long t_b, t_n, t_d;
};
const Tables kNoTables{nullptr, nullptr, 0, 0, 1};

// Splits x (strides st: b, h, n, d) into nat and/or tr (either may be null),
// rotated by the tables `t` where it has them.
int split(const void* x, const long long* st, const Tables& t, void* nat, void* tr, int B, int H,
          int D, int n, cudaStream_t s) {
  const bool dn = st[3] != 1;
  if (!(dn ? dn_operand(x, st) : vec4_operand(x, st, B, H, n)) ||
      (nat != nullptr && !aligned16(nat)) || (tr != nullptr && !aligned16(tr)))
    return cudaErrorInvalidValue;
  const SplitParams p{static_cast<const float*>(x), st[0], st[1], st[2], st[3], t.cos, t.sin,
                      t.t_b, t.t_n, t.t_d, static_cast<float*>(nat), static_cast<float*>(tr), B,
                      H, n, padded8(n)};
  return dispatch_width<RunSplit>(D, p, s);
}

struct PlanParams {
  const int* seg_q;  // [B, n] at batch stride segq_b, or null (causal: positions)
  const int* seg_k;  // [B, >= m] at segk_b
  long long segq_b, segk_b;
  int* plan;         // [B|1][row blocks][plan_w]: the count, the entries, -1 past them
  long long plan_b;
  int plan_w, n, m, block, tile, keys_major;
};

constexpr int kPlanThreads = 128;

// Smallest and largest id of ids[lo, hi) (positions where ids is null).
__device__ __forceinline__ void id_range(const int* ids, int lo, int hi, int& mn, int& mx) {
  if (ids == nullptr) {
    mn = lo, mx = hi - 1;
    return;
  }
  mn = INT_MAX, mx = INT_MIN;
  for (int i = lo; i < hi; ++i) mn = min(mn, ids[i]), mx = max(mx, ids[i]);
}

// x summed over the block's threads, before this one (exclusive) and in all.
__device__ __forceinline__ int block_scan(int x, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kPlanThreads / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  __syncthreads();  // s_warp is reused by the next call
  return before + incl - x;
}

__global__ void __launch_bounds__(kPlanThreads)
    flash_fp32_plan_kernel(const __grid_constant__ PlanParams p) {
  __shared__ int s_red[2][kPlanThreads / 32], s_warp[kPlanThreads / 32];
  const int b = blockIdx.y, r = blockIdx.x;
  const int* sq = p.seg_q != nullptr ? p.seg_q + b * p.segq_b : nullptr;
  const int* sk = p.seg_k != nullptr ? p.seg_k + b * p.segk_b : nullptr;
  // rows: queries (keys_major: keys below m); columns: keys below m (queries)
  const int* rid = p.keys_major ? sk : sq;
  const int* cid = p.keys_major ? sq : sk;
  const int rows = p.keys_major ? p.m : p.n, cols = p.keys_major ? p.n : p.m;
  const int r0 = r * p.block, r1 = min(r0 + p.block, rows);
  int mn = INT_MAX, mx = INT_MIN;  // the row block's ids
  for (int i = r0 + threadIdx.x; i < r1; i += kPlanThreads) {
    const int v = rid != nullptr ? rid[i] : i;
    mn = min(mn, v), mx = max(mx, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((threadIdx.x & 31) == 0) s_red[0][threadIdx.x >> 5] = mn, s_red[1][threadIdx.x >> 5] = mx;
  __syncthreads();
  for (int w = 0; w < kPlanThreads / 32; ++w) mn = min(mn, s_red[0][w]), mx = max(mx, s_red[1][w]);
  int* out = p.plan + b * p.plan_b + (long long)r * p.plan_w;
  const int n_tiles = (cols + p.tile - 1) / p.tile;
  int count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kPlanThreads) {
    const int t = t0 + threadIdx.x;
    bool live = false;
    int entry = 0;
    if (t < n_tiles) {
      int cmn, cmx;
      id_range(cid, t * p.tile, min((t + 1) * p.tile, cols), cmn, cmx);
      const int q_mn = p.keys_major ? cmn : mn, q_mx = p.keys_major ? cmx : mx;
      const int k_mn = p.keys_major ? mn : cmn, k_mx = p.keys_major ? mx : cmx;
      live = q_mx >= k_mn;
      const bool full = q_mn >= k_mx && (p.keys_major || (t + 1) * p.tile <= p.m);
      entry = t | (full ? 0 : kPartialTile);
    }
    int total;
    const int at = block_scan(live, s_warp, total);
    if (live) out[1 + count + at] = entry;
    count += total;
  }
  for (int i = count + threadIdx.x; i < n_tiles; i += kPlanThreads) out[1 + i] = -1;
  if (threadIdx.x == 0) out[0] = count;
}

// The tables of an entry point's arguments for n tokens; false if only one
// is given or their strides are neither [.., n, D] (unit along d, rows at
// least D apart) nor [.., D, n] (unit along the tokens, features at least n
// apart).
bool tables(const void* cos, const void* sin, const long long* st, int D, int n, Tables* t) {
  const long long t_b = st[0], t_n = st[1], t_d = st[2];
  if ((cos == nullptr) != (sin == nullptr) ||
      (cos != nullptr && (t_b < 0 || !((t_d == 1 && t_n >= D) || (t_n == 1 && t_d >= n)))))
    return false;
  *t = Tables{static_cast<const float*>(cos), static_cast<const float*>(sin), t_b, t_n, t_d};
  return true;
}

}  // namespace

// The forward's pre-pass: q and k token-major, v feature-major, each hi/lo
// ([2][B][H][N][D], [2][B][H][M][D], [2][B][H][D][padded8(M)]); q and k
// rotated first where cos and sin are given (split-half, [B|1, N, D] or
// [B|1, D, N]). M: the keys to split (kv_valid where the call has it).
// strides: (b, h, n, d) of q, k, v, each unit-stride along d or along the
// tokens, then the tables' (t_b, t_n, t_d). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int vjepa2_flash_fp32_prepass_fwd(const void* q, const void* k, const void* v,
                                             const void* cos, const void* sin, void* q_nat,
                                             void* k_nat, void* v_tr, int B, int H, int D, int N,
                                             int M, const long long* strides, void* stream) {
  Tables t;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B > 65535 || H > 65535 ||
      !tables(cos, sin, strides + 12, D, N, &t) || (t.cos != nullptr && M > N))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = split(q, strides, t, q_nat, nullptr, B, H, D, N, s);
  if (err == 0) err = split(k, strides + 4, t, k_nat, nullptr, B, H, D, M, s);
  if (err == 0) err = split(v, strides + 8, kNoTables, nullptr, v_tr, B, H, D, M, s);
  return err;
}

// The backward's pre-pass: q, k, v and dout token-major, q, k and dout
// feature-major, each hi/lo, q and k rotated first where cos and sin are
// given; delta and lse * log2(e) [B, H, Np] (Np: N rounded up to 64). M: the
// keys to split (kv_valid where the call has it). strides: (b, h, n, d) of q,
// k, v, out and dout, each unit-stride along d or along the tokens, then the
// tables' (t_b, t_n, t_d); lse [B, H, N] contiguous. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int vjepa2_flash_fp32_prepass_bwd(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             const void* cos, const void* sin, void* q_nat,
                                             void* q_tr, void* k_nat, void* k_tr, void* v_nat,
                                             void* do_nat, void* do_tr, void* delta, void* lse2,
                                             int B, int H, int D, int N, int M, int Np,
                                             const long long* strides, void* stream) {
  Tables t;
  const long long *so = strides + 12, *sg = strides + 16;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B > 65535 || H > 65535 || Np < N || Np % 64 != 0 ||
      lse == nullptr || delta == nullptr || lse2 == nullptr || out == nullptr ||
      dout == nullptr || (so[3] != 1 && so[2] != 1) || (sg[3] != 1 && sg[2] != 1) ||
      !tables(cos, sin, strides + 20, D, N, &t) || (t.cos != nullptr && M > N))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = split(q, strides, t, q_nat, q_tr, B, H, D, N, s);
  if (err == 0) err = split(k, strides + 4, t, k_nat, k_tr, B, H, D, M, s);
  if (err == 0) err = split(v, strides + 8, kNoTables, v_nat, nullptr, B, H, D, M, s);
  if (err == 0) err = split(dout, sg, kNoTables, do_nat, do_tr, B, H, D, N, s);
  if (err != 0) return err;
  const StatsParams p{static_cast<const float*>(out), static_cast<const float*>(dout), so[0],
                      so[1], so[2], so[3], sg[0], sg[1], sg[2], sg[3],
                      static_cast<const float*>(lse), static_cast<float*>(delta),
                      static_cast<float*>(lse2), H, N, Np, D};
  if (so[3] != 1 || sg[3] != 1) return dispatch_width<RunStatsStaged>(D, p, B, s);
  flash_fp32_stats_kernel<<<dim3(Np / 8, H, B), 256, 0, s>>>(p);
  return cudaGetLastError();
}

// The masked kernels' tile plan (`mask_tile_plan`'s layout): plan [Bp][row
// blocks][plan_w] int32 for rows of `block` queries (keys_major: keys below
// m) and tiles of `tile` keys below m (queries), plan_w >= 1 + the tiles.
// seg_q [Bp, n] and seg_k [Bp, >= m] int32 (query i attends key j iff
// seg_q[i] >= seg_k[j]), or both null for the causal mask (j <= i). strides:
// seg_q's and seg_k's batch strides, the plan's. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int vjepa2_flash_fp32_plan(const void* seg_q, const void* seg_k, void* plan, int Bp,
                                      int n, int m, int block, int tile, int keys_major,
                                      int plan_w, const long long* strides, void* stream) {
  const int rows = keys_major ? m : n, cols = keys_major ? n : m;
  if (Bp <= 0 || Bp > 65535 || n <= 0 || m <= 0 || block <= 0 || tile <= 0 || plan == nullptr ||
      (seg_q == nullptr) != (seg_k == nullptr) || strides[0] < 0 || strides[1] < 0 ||
      strides[2] < 0 || plan_w < 1 + (cols + tile - 1) / tile ||
      (cols + tile - 1) / tile >= kPartialTile)
    return cudaErrorInvalidValue;
  const PlanParams p{static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), strides[0],
                     strides[1], static_cast<int*>(plan), strides[2], plan_w, n, m, block,
                     tile, keys_major != 0};
  flash_fp32_plan_kernel<<<dim3((rows + block - 1) / block, Bp), kPlanThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
