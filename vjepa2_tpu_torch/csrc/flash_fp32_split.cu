// The fp32 flash kernels' pre-pass (`flash_fp32.cuh`): each operand that a
// product reads from shared memory, split once a call into its tf32 parts
// x = hi + lo, in the layouts the products need, and the backward's row
// statistics. Replaces no TPU kernel: the TPU's fp32 matrix unit needs no
// split; it exists for the 3xTF32 products of B3 and B4/B5 on fp32 operands.
// It also takes the TPU kernels' RoPE prologue (`flash_attention.py:208-211`,
// `_rope_rotate :112`): q and k are rotated here, once a call, in fp32.
//
//   * `flash_fp32_split_kernel`: an operand [B, H, n, D] (strides; float4 reads)
//     -> token-major hi/lo [2][B][H][n][D] and/or feature-major hi/lo
//     [2][B][H][D][np] (np = n rounded up to 8, pad tokens zero), the latter
//     with its tokens permuted in each group of 8 (`permuted`). A block stages
//     64 tokens in shared memory, so both writes are coalesced; with tables
//     it rotates the staged tokens there first (`rope_pair`: each product and
//     sum rounded once, the plain version's `rope_rotate`), then splits the
//     rotated values. With kv_valid the wrapper passes the valid keys as n,
//     so only those are split;
//   * `flash_fp32_stats_kernel`: delta = rowsum(dout * out) in fp32 and
//     lse * log2(e) (+inf where lse is -inf, and past N), [B, H, Np], a warp a row.
// What bounds it: bytes, O(N*D): at [1,16,36864,88] the backward's pre-pass
// reads 0.8 GB and writes 2.9 GB, next to the main kernels' O(N^2 D) work.

#include "flash_fp32.cuh"

namespace {

constexpr int kSplitRows = 64;  // tokens a block

struct SplitParams {
  const float* x;    // [B, H, n, D] at element strides (b, h, n), unit along d
  long long sb, sh, sn;
  const float* cos;  // split-half tables [B|1, >= n, D] at (t_b, t_n), unit along d; null: no rotation
  const float* sin;
  long long t_b, t_n;
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

template <int D>
__global__ void __launch_bounds__(256) flash_fp32_split_kernel(const SplitParams p) {
  constexpr int kVec = D / 4, kHalf = D / 2;
  __shared__ float tile[kSplitRows][D + 1];  // D + 1: a warp's column reads hit 32 banks
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kSplitRows;
  const long long bh = (long long)b * p.H + h;
  const float* x = p.x + b * p.sb + h * p.sh;
  const long long nat_part = (long long)p.B * p.H * p.n * D;
  const bool rope = p.cos != nullptr;
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
  if (rope) {  // rotate the staged tokens in place, a pair (d, d + D/2) a thread
    __syncthreads();
    const float* cos_t = p.cos + b * p.t_b;
    const float* sin_t = p.sin + b * p.t_b;
    for (int i = threadIdx.x; i < kSplitRows * kHalf; i += blockDim.x) {
      const int r = i / kHalf, d = i - r * kHalf, n = t0 + r;
      if (n >= p.n) continue;
      const long long at = n * p.t_n + d;
      float lo = tile[r][d], hi = tile[r][d + kHalf];
      rope_pair(lo, hi, cos_t[at], sin_t[at], cos_t[at + kHalf], sin_t[at + kHalf]);
      tile[r][d] = lo;
      tile[r][d + kHalf] = hi;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSplitRows * kVec && p.nat != nullptr; i += blockDim.x) {
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
  const float* o;     // out [B, H, N, D] at strides (b, h, n), unit along d
  const float* dout;  // the same
  long long ob, oh, on, gb, gh, gn;
  const float* lse;   // [B, H, N]
  float* delta;       // [B, H, Np]
  float* lse2;        // [B, H, Np]
  int H, N, Np, D;
};

__global__ void __launch_bounds__(256) flash_fp32_stats_kernel(const StatsParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * 8 + warp, h = blockIdx.y, b = blockIdx.z;
  if (n >= p.Np) return;
  const long long bh = (long long)b * p.H + h;
  float acc = 0.f, l2 = INFINITY;  // past N: p = exp2(s - inf) = 0
  if (n < p.N) {
    const float* o = p.o + b * p.ob + h * p.oh + n * p.on;
    const float* g = p.dout + b * p.gb + h * p.gh + n * p.gn;
    for (int d = lane; d < p.D; d += 32) acc = fmaf(o[d], g[d], acc);
    const float l = p.lse[bh * p.N + n];
    if (l != -INFINITY) l2 = l * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[bh * p.Np + n] = acc;
    p.lse2[bh * p.Np + n] = l2;
  }
}

// float4 reads of an operand with element strides st (b, h, n, d).
bool vec4_operand(const void* x, const long long* st, int B, int H, int n) {
  return x != nullptr && aligned16(x) && st[3] == 1 && (B == 1 || st[0] % 4 == 0) &&
         (H == 1 || st[1] % 4 == 0) && (n == 1 || st[2] % 4 == 0);
}

struct RunSplit {
  template <int D>
  static int run(const SplitParams& p, cudaStream_t s) {
    flash_fp32_split_kernel<D><<<dim3((p.np + kSplitRows - 1) / kSplitRows, p.H, p.B), 256, 0, s>>>(p);
    return cudaGetLastError();
  }
};

// The RoPE tables of a call: (cos, sin) or neither, and their strides.
struct Tables {
  const float* cos;
  const float* sin;
  long long t_b, t_n;
};
const Tables kNoTables{nullptr, nullptr, 0, 0};

// Splits x (strides st: b, h, n, d) into nat and/or tr (either may be null),
// rotated by the tables `t` where it has them.
int split(const void* x, const long long* st, const Tables& t, void* nat, void* tr, int B, int H,
          int D, int n, cudaStream_t s) {
  if (!vec4_operand(x, st, B, H, n) || (nat != nullptr && !aligned16(nat)) ||
      (tr != nullptr && !aligned16(tr)))
    return cudaErrorInvalidValue;
  const SplitParams p{static_cast<const float*>(x), st[0], st[1], st[2], t.cos, t.sin, t.t_b,
                      t.t_n, static_cast<float*>(nat), static_cast<float*>(tr), B, H, n,
                      padded8(n)};
  return dispatch_width<RunSplit>(D, p, s);
}

// The tables of an entry point's arguments; false if only one is given or
// the row stride is below D.
bool tables(const void* cos, const void* sin, long long t_b, long long t_n, int D, Tables* t) {
  if ((cos == nullptr) != (sin == nullptr) || (cos != nullptr && (t_n < D || t_b < 0))) return false;
  *t = Tables{static_cast<const float*>(cos), static_cast<const float*>(sin), t_b, t_n};
  return true;
}

}  // namespace

// The forward's pre-pass: q and k token-major, v feature-major, each hi/lo
// ([2][B][H][N][D], [2][B][H][M][D], [2][B][H][D][padded8(M)]); q and k
// rotated first where cos and sin are given (split-half [B|1, N, D]). M: the
// keys to split (kv_valid where the call has it). strides: (b, h, n, d) of
// q, k, v, then the tables' (t_b, t_n). Returns the cudaError_t of the
// launches (0 on success).
extern "C" int vjepa2_flash_fp32_prepass_fwd(const void* q, const void* k, const void* v,
                                             const void* cos, const void* sin, void* q_nat,
                                             void* k_nat, void* v_tr, int B, int H, int D, int N,
                                             int M, const long long* strides, void* stream) {
  Tables t;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B > 65535 || H > 65535 ||
      !tables(cos, sin, strides[12], strides[13], D, &t) || (t.cos != nullptr && M > N))
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
// k, v, out and dout, then the tables' (t_b, t_n); lse [B, H, N] contiguous.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int vjepa2_flash_fp32_prepass_bwd(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             const void* cos, const void* sin, void* q_nat,
                                             void* q_tr, void* k_nat, void* k_tr, void* v_nat,
                                             void* do_nat, void* do_tr, void* delta, void* lse2,
                                             int B, int H, int D, int N, int M, int Np,
                                             const long long* strides, void* stream) {
  Tables t;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B > 65535 || H > 65535 || Np < N || Np % 64 != 0 ||
      lse == nullptr || delta == nullptr || lse2 == nullptr || strides[15] != 1 ||
      !tables(cos, sin, strides[20], strides[21], D, &t) || (t.cos != nullptr && M > N))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = split(q, strides, t, q_nat, q_tr, B, H, D, N, s);
  if (err == 0) err = split(k, strides + 4, t, k_nat, k_tr, B, H, D, M, s);
  if (err == 0) err = split(v, strides + 8, kNoTables, v_nat, nullptr, B, H, D, M, s);
  if (err == 0) err = split(dout, strides + 16, kNoTables, do_nat, do_tr, B, H, D, N, s);
  if (err != 0) return err;
  const StatsParams p{static_cast<const float*>(out), static_cast<const float*>(dout), strides[12],
                      strides[13], strides[14], strides[16], strides[17], strides[18],
                      static_cast<const float*>(lse), static_cast<float*>(delta),
                      static_cast<float*>(lse2), H, N, Np, D};
  flash_fp32_stats_kernel<<<dim3(Np / 8, H, B), 256, 0, s>>>(p);
  return cudaGetLastError();
}
