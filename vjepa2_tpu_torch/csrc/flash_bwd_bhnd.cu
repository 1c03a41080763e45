// Flash-attention backward over [B, H, N, D] ("BHND") operands, for Hopper (sm_90a).
//
// Replaces both TPU backward kernels of the BHND family:
//   * `vjepa2_tpu/ops/flash_attention.py:511 _bwd_fused_kernel` (B4, one
//     pass, `pallas_call` `:688`, fp32 dk/dv partials [B, H, nq, M, D]
//     summed in XLA), and
//   * `:361 _dq_kernel` plus `:434 _dkv_kernel` (B5, two passes, `:713`,
//     `:755`),
// between which `_flash_bwd_bhnd:613` chooses by a scoped-VMEM rule of the
// TPU (`:660-664`). Both compute one function, and so does this file, given
// what the forward (B3, `flash_fwd_bhnd.cu`) saved:
//   * q, k, v, out, do bf16 [B, H, N|M, D]; v, do and (without RoPE) q and
//     k are read by TMA (unit stride along d, strides multiples of 8 from a
//     16-byte aligned base; the wrapper copies any other operand first), out
//     at any element strides; lse [B, H, N] fp32, natural log (the
//     forward's, or a global one passed in from outside, as a ring hop
//     does); D in {32, 64, 80, 88, 104};
//   * the scores are recomputed from q and k rotated and rounded exactly as
//     B3 does (`dn_common.cuh:rope_pair`, `round_scaled`), so
//     p = exp2(s - lse*log2(e)) is the forward's softmax. A row whose lse is
//     -inf gets p = 0; keys at or past kv_lim, pairs with seg_q < seg_k and,
//     with `causal`, keys after the query get p = 0;
//   * delta = rowsum(do * out) in fp32; dv = p^T do; dp = do v^T;
//     ds = p (dp - delta) scale, rounded to bf16 as the TPU kernels do;
//     dk = ds^T q_u with q_u the rotated q rounded WITHOUT the scale (B4's
//     choice; B5 folds the scale into k instead, `:473-475`, a rounding
//     choice of the TPU, not part of the function); dq = ds k_rot;
//   * the RoPE adjoint (`_rope_rotate_t:120`; not R(-theta): the two slots of
//     a pair carry different angles) on dq and dk in fp32 after
//     accumulation; dq, dk, dv written bf16 [B, H, N|M, D] contiguous.
//
// What bounds it on this card: 10*Dh FLOPs per score on the tensor cores
// (S, dP, dV, dK, dQ; 14*Dh with dQ's recomputation of S and dP) against a
// dozen scalar operations (exp2, masks, subtract, multiply, conversions).
//
// Design (`bhnd_hopper.cuh` for the machinery), three launches:
//   * `bhnd_bwd_prologue_kernel` writes only what has to exist: q_s =
//     bf16(rot(q) * scale*log2(e)), and with RoPE q_u = bf16(rot(q)) and
//     k_rot = bf16(rot(k)), token-major [B, H, N|M, D] (without RoPE q_u is
//     q and k_rot is k, read in place); delta and lse*log2(e) in fp32
//     [B, H, Np]. No feature-major copy: v and do are read as the caller
//     laid them out;
//   * `flash_bwd_bhnd_dkdv_kernel`: one block per (b, h, 128 keys), two
//     consumer warpgroups of 64 keys and a producer warp. The producer loads
//     k_rot and v once and streams 64-query tiles of q_s, q_u, do, lse and
//     delta through a 3-stage TMA ring. Per tile (or per 32 queries of it
//     at D 80-104, where dK and dV leave too few registers for 64) a
//     consumer issues S^T = K_rot Q_s^T and dP^T = V dO^T (wgmma, both
//     operands in shared memory), masks and exponentiates P^T and forms dS^T
//     in registers, then dV += P^T dO and dK += dS^T Q_u with P^T and dS^T
//     as register A operands and do and q_u as transposed (MN-major) B
//     operands. dK and dV stay in fp32 registers;
//   * `flash_bwd_bhnd_dq_kernel`: one block per (b, h, 128 queries), 64-key
//     tiles of k_rot and v through the ring; S = Q_s K_rot^T and dP = dO V^T
//     again, dQ += dS K_rot with k_rot as the transposed B operand. This
//     deterministic split recomputes S and dP (14*Dh FLOPs a score where
//     10*Dh would do) and needs no atomics, so two calls give equal bits;
//   * in both, the two consumers take turns on the tensor cores (named
//     barriers, ping-pong), so one's elementwise work overlaps the other's
//     products;
//   * both epilogues stage the fp32 accumulators in shared memory, where the
//     RoPE adjoint reads each pair (d, d + D/2), which at D 80, 88 and 104
//     straddles the 64-feature chunks.
// Not done yet, for later work: skipping tiles that a segment mask hides
// entirely.

#include "bhnd_hopper.cuh"

namespace {

constexpr int kKeyBlock = 128;  // keys a dK/dV block, 64 a consumer warpgroup
constexpr int kQTile = 64;      // queries a dK/dV loop step
constexpr int kQBlock = 128;    // queries a dQ block, 64 a consumer warpgroup
constexpr int kKTile = 64;      // keys a dQ loop step
constexpr int kStages = 3;
constexpr int kRows = 64;       // tokens per prologue block

struct Str {
  long long b, h, n, d;
};

struct PrologueParams {
  const bf16* q;
  const bf16* k;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // [B, H, N]
  Str sq, sk, so, sdo;
  const float* cos;  // null: no RoPE
  const float* sin;
  long long t_b, t_n, t_d;
  bf16* qs;          // [B, H, N, D]  bf16(rot(q) * qscale)
  bf16* qu;          // [B, H, N, D]  bf16(rot(q)); null without RoPE
  bf16* kr;          // [B, H, M, D]  bf16(rot(k)); null without RoPE
  float* delta;      // [B, H, Np]
  float* lse2;       // [B, H, Np]    lse * log2(e); +inf where p must be 0
  int H, N, M, Np;
  int vec;           // bit i: 8-byte loads for q, k, out, do (i = 0..3)
  float qscale;
};

struct BwdParams {
  CUtensorMap tm_k, tm_v;             // 128-key boxes: a dK/dV block's keys
  CUtensorMap tm_qs, tm_qu, tm_do;    // 64-query boxes: its query tiles
  CUtensorMap tm_qs_blk, tm_do_blk;   // 128-query boxes: a dQ block's queries
  CUtensorMap tm_k_tile, tm_v_tile;   // 64-key boxes: its key tiles
  const float* lse2;
  const float* delta;
  const float* cos;
  const float* sin;
  long long t_b, t_n, t_d;
  const int* seg_q;  // null: no segment mask
  const int* seg_k;
  long long segq_b, segk_b;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, N, M, Np, kv_lim, causal;
  float scale;
};

// One block per (b, h, 64 tokens): the query side below Np, k_rot below M.
// A thread takes four features of a row and their RoPE partners D/2 further
// (8-byte loads where the strides allow).
template <int D>
__global__ void __launch_bounds__(256) bhnd_bwd_prologue_kernel(const PrologueParams p) {
  constexpr int kHalf = D / 2, kQuads = kHalf / 4;
  __shared__ float s_part[kRows][kQuads + 1];  // delta's partial sums
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRows;
  const long long bh = (long long)b * p.H + h;
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  if (t0 < p.Np) {
    const bf16* q = p.q + b * p.sq.b + h * p.sq.h;
    const bf16* o = p.o + b * p.so.b + h * p.so.h;
    const bf16* dout = p.dout + b * p.sdo.b + h * p.sdo.h;
    for (int i = threadIdx.x; i < kRows * kQuads; i += blockDim.x) {
      const int r = i / kQuads, d = (i % kQuads) * 4, n = t0 + r;
      float part = 0.f;
      if (n < p.N) {
        float4 lo = load4(q + n * p.sq.n + d * p.sq.d, p.sq.d, p.vec & 1);
        float4 hi = load4(q + n * p.sq.n + (d + kHalf) * p.sq.d, p.sq.d, p.vec & 1);
        if (cos_t != nullptr) rope4(lo, hi, cos_t + n * p.t_n, sin_t + n * p.t_n, d, kHalf, p.t_d);
        const long long at = (bh * p.N + n) * D + d;
        store4(p.qs + at, lo, p.qscale);
        store4(p.qs + at + kHalf, hi, p.qscale);
        if (p.qu != nullptr) {
          store4(p.qu + at, lo, 1.f);
          store4(p.qu + at + kHalf, hi, 1.f);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = d + half * kHalf;
          const float4 g = load4(dout + n * p.sdo.n + c * p.sdo.d, p.sdo.d, (p.vec >> 3) & 1);
          const float4 x = load4(o + n * p.so.n + c * p.so.d, p.so.d, (p.vec >> 2) & 1);
          part += g.x * x.x + g.y * x.y + g.z * x.z + g.w * x.w;
        }
      }
      s_part[r][i % kQuads] = part;
    }
    __syncthreads();
    if (threadIdx.x < kRows) {  // delta = rowsum(do * out) in fp32; lse * log2(e)
      const int n = t0 + threadIdx.x;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kQuads; ++c) acc += s_part[threadIdx.x][c];
      float l2 = INFINITY;  // past N, or a row with no key: p = exp2(s - inf) = 0
      if (n < p.N) {
        const float l = p.lse[bh * p.N + n];
        if (l != -INFINITY) l2 = l * kLog2e;
      }
      p.delta[bh * p.Np + n] = acc;
      p.lse2[bh * p.Np + n] = l2;
    }
  }
  if (p.kr != nullptr && t0 < p.M) {
    const bf16* k = p.k + b * p.sk.b + h * p.sk.h;
    for (int i = threadIdx.x; i < kRows * kQuads; i += blockDim.x) {
      const int n = t0 + i / kQuads, d = (i % kQuads) * 4;
      if (n >= p.M) continue;
      float4 lo = load4(k + n * p.sk.n + d * p.sk.d, p.sk.d, (p.vec >> 1) & 1);
      float4 hi = load4(k + n * p.sk.n + (d + kHalf) * p.sk.d, p.sk.d, (p.vec >> 1) & 1);
      rope4(lo, hi, cos_t + n * p.t_n, sin_t + n * p.t_n, d, kHalf, p.t_d);
      const long long at = (bh * p.M + n) * D + d;
      store4(p.kr + at, lo, 1.f);
      store4(p.kr + at + kHalf, hi, 1.f);
    }
  }
}

// This warpgroup's 64 rows of a product (64 x Dp fp32, accumulator layout)
// -> rows t0 + r < lim of dst, a [*, D] bf16 array, through fp32 staging in
// s_f [64][Dp + 4]; the RoPE adjoint R^T first when cos_t is given (pairs
// (d, d + D/2) read back from s_f, which at D 80, 88 and 104 lie in both
// 64-feature chunks).
template <int D>
__device__ __forceinline__ void write_rows(bf16* dst, float* s_f,
                                           const float (&acc)[padded_width(D) / 2],
                                           const float* cos_t, const float* sin_t, long long t_n,
                                           long long t_d, int t0, int lim, int bar_id) {
  constexpr int kHalf = D / 2, kF = padded_width(D) + 4;
  const int t = threadIdx.x % kWgThreads, lane = t & 31, t4 = lane & 3;
  const int lr = (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int dt = 0; dt < padded_width(D) / 8; ++dt) {
      s_f[(lr + 8 * r) * kF + dt * 8 + 2 * t4] = acc[4 * dt + 2 * r];
      s_f[(lr + 8 * r) * kF + dt * 8 + 2 * t4 + 1] = acc[4 * dt + 2 * r + 1];
    }
  }
  bar_sync(bar_id, kWgThreads);
  if (cos_t != nullptr) {
    for (int i = t; i < 64 * kHalf; i += kWgThreads) {
      const int r = i / kHalf, d = i % kHalf, n = t0 + r;
      if (n >= lim) continue;
      const long long i_lo = n * t_n + d * t_d, i_hi = n * t_n + (d + kHalf) * t_d;
      const float g_lo = s_f[r * kF + d], g_hi = s_f[r * kF + d + kHalf];
      dst[(long long)n * D + d] = __float2bfloat16_rn(g_lo * cos_t[i_lo] + g_hi * sin_t[i_hi]);
      dst[(long long)n * D + d + kHalf] =
          __float2bfloat16_rn(g_hi * cos_t[i_hi] - g_lo * sin_t[i_lo]);
    }
  } else {
    for (int i = t; i < 64 * D; i += kWgThreads) {
      const int r = i / D, d = i % D, n = t0 + r;
      if (n < lim) dst[(long long)n * D + d] = __float2bfloat16_rn(s_f[r * kF + d]);
    }
  }
}

template <int D>
__host__ __device__ constexpr int dkdv_stage_bytes() {  // q_s, q_u, do; lse2 and delta
  return 3 * tile_bytes(D, kQTile) + 1024;
}
template <int D>
constexpr int dkdv_smem_bytes() {
  return 2 * tile_bytes(D, kKeyBlock) + kStages * dkdv_stage_bytes<D>() + 64 + 1024;
}
template <int D>
__host__ __device__ constexpr int dq_stage_bytes() {  // k_rot, v
  return 2 * tile_bytes(D, kKTile);
}
template <int D>
constexpr int dq_smem_bytes() {
  return 2 * tile_bytes(D, kQBlock) + kStages * dq_stage_bytes<D>() + 64 + 1024;
}

// dk and dv for 128 keys of one (b, h), looping over 64-query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bhnd_dkdv_kernel(const __grid_constant__ BwdParams p) {
  constexpr int Dp = padded_width(D), kF = Dp + 4;
  constexpr int kSteps = Dp / 16, kKv = tile_bytes(D, kKeyBlock);
  // Queries per step of the loop body: the whole tile, or half of it where
  // dK and dV (fp32, 64 x Dp each) leave too few registers for S^T, dP^T
  // and their packed copies at 64 queries.
  constexpr int kSub = Dp > 64 ? 32 : kQTile, kPer = kQTile / kSub;
  constexpr int kQ = tile_bytes(D, kQTile), kStage = dkdv_stage_bytes<D>();
  static_assert(2 * 2 * 64 * kF * 4 <= 2 * kKv + kStages * kStage, "the epilogue fits");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* s_k = smem;
  unsigned char* s_v = s_k + kKv;
  unsigned char* stages = s_v + kKv;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeyBlock;
  const long long bh = (long long)b * p.H + h;
  const int n_qt = (p.N + kQTile - 1) / kQTile;
  const int qt_begin = p.causal ? k0 / kQTile : 0;  // earlier queries see none of these keys
  const bool work = k0 < p.kv_lim && qt_begin < n_qt;  // else dk = dv = 0

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * kWgThreads && work) {
      mbar_expect_tx(kv_full, 2 * kKv);
      tma_tile<D, kKeyBlock>(s_k, &p.tm_k, k0, h, b, kv_full);
      tma_tile<D, kKeyBlock>(s_v, &p.tm_v, k0, h, b, kv_full);
      for (int it = 0; it < n_qt - qt_begin; ++it) {
        const int s = it % kStages, q0 = (qt_begin + it) * kQTile;
        unsigned char* st = stages + s * kStage;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 3 * kQ + 2 * kQTile * 4);
        tma_tile<D, kQTile>(st, &p.tm_qs, q0, h, b, &full[s]);
        tma_tile<D, kQTile>(st + kQ, &p.tm_qu, q0, h, b, &full[s]);
        tma_tile<D, kQTile>(st + 2 * kQ, &p.tm_do, q0, h, b, &full[s]);
        bulk_load(st + 3 * kQ, p.lse2 + bh * p.Np + q0, kQTile * 4, &full[s]);
        bulk_load(st + 3 * kQ + kQTile * 4, p.delta + bh * p.Np + q0, kQTile * 4, &full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int t = threadIdx.x % kWgThreads, lane = t & 31, t4 = lane & 3;
  const int rbase = wg * 64;
  const bool use_seg = p.seg_q != nullptr;
  const int* segq_p = use_seg ? p.seg_q + b * p.segq_b : nullptr;
  float dk[Dp / 2], dv[Dp / 2];  // 64 keys x Dp features each
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) dk[i] = dv[i] = 0.f;

  // The tensor cores in turns (ping-pong on named barriers 1 and 2): a
  // warpgroup issues its products, hands the turn to the other and does its
  // elementwise work while the other's products run.
  const int n_steps = work ? n_qt - qt_begin : 0, mine = 1 + wg, other = 1 + (wg ^ 1);
  if (n_steps > 0) {
    int key[2], segk[2] = {0, 0};
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      key[r] = k0 + rbase + (t >> 5) * 16 + (lane >> 2) + 8 * r;
      key_ok[r] = key[r] < p.kv_lim;
      if (use_seg && key[r] < p.M) segk[r] = p.seg_k[b * p.segk_b + key[r]];
    }
    mbar_wait(kv_full, 0);
    if (wg == 1) bar_arrive(other, 2 * kWgThreads);  // warpgroup 0 takes the first turn
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kStages, q0 = (qt_begin + it) * kQTile;
      const unsigned char* st = stages + s * kStage;
      const float* s_l = reinterpret_cast<const float*>(st + 3 * kQ);
      const float* s_dl = s_l + kQTile;
      mbar_wait(&full[s], (it / kStages) & 1);
#pragma unroll 1
      for (int hq = 0; hq < kPer; ++hq) {  // the tile's queries, kSub at a time
        const int c0 = hq * kSub;
        const uint64_t d_k = opaque(desc_k<kKeyBlock>(s_k, rbase));
        const uint64_t d_v = opaque(desc_k<kKeyBlock>(s_v, rbase));
        const uint64_t d_qs = opaque(desc_k<kQTile>(st, c0));
        const uint64_t d_do = opaque(desc_k<kQTile>(st + 2 * kQ, c0));
        float sT[kSub / 2], dpT[kSub / 2];  // S^T and dP^T, 64 keys x kSub queries
        bar_sync(mine, 2 * kWgThreads);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {  // S^T = K_rot Q_s^T, base-2 units
          wgmma_ss<kSub>(sT, d_k + step_k<kKeyBlock>(ks), d_qs + step_k<kQTile>(ks), ks > 0);
        }
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {  // dP^T = V dO^T
          wgmma_ss<kSub>(dpT, d_v + step_k<kKeyBlock>(ks), d_do + step_k<kQTile>(ks), ks > 0);
        }
        wgmma_commit();
        bar_arrive(other, 2 * kWgThreads);
        wgmma_wait<0>();
        fence_regs(sT);
        fence_regs(dpT);
        // P^T and dS^T, packed as A fragments as they are made; the masked
        // variant only where segments or causality can hide a pair (keys
        // past kv_lim are whole rows here)
        uint32_t pa[kSub / 16][4], da[kSub / 16][4];
        auto elementwise = [&](bool masked) {
#pragma unroll
          for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = c0 + nt * 8 + 2 * t4 + (e & 1), qry = q0 + col;
              bool ok = key_ok[e >> 1];
              if (masked) {
                if (use_seg && ok) ok = (qry < p.N ? segq_p[qry] : 0) >= segk[e >> 1];
                if (p.causal) ok = ok && key[e >> 1] <= qry;
              }
              const float pv = ok ? exp2_approx(sT[4 * nt + e] - s_l[col]) : 0.f;
              dpT[4 * nt + e] = pv * (dpT[4 * nt + e] - s_dl[col]) * p.scale;  // dS^T
              sT[4 * nt + e] = pv;
            }
            pack_tile(pa[nt / 2], nt & 1, sT + 4 * nt);
            pack_tile(da[nt / 2], nt & 1, dpT + 4 * nt);
          }
        };
        if (use_seg || p.causal) {
          elementwise(true);
        } else {
          elementwise(false);
        }
        const uint64_t t_do = opaque(desc_mn<kQTile>(st + 2 * kQ));
        const uint64_t t_qu = opaque(desc_mn<kQTile>(st + kQ));
        bar_sync(mine, 2 * kWgThreads);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {  // dV += P^T dO, dK += dS^T Q_u
          const int kq = c0 / 16 + kk;
          wgmma_rs<Dp>(dv, pa[kk], t_do + step_mn<kQTile>(0, kq), 1);
          wgmma_rs<Dp>(dk, da[kk], t_qu + step_mn<kQTile>(0, kq), 1);
        }
        wgmma_commit();
        if (wg == 0 || it + 1 < n_steps || hq + 1 < kPer) bar_arrive(other, 2 * kWgThreads);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  bar_sync(5, 2 * kWgThreads);  // both consumers are done with the rings
  float* s_f = reinterpret_cast<float*>(smem) + wg * 2 * 64 * kF;
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  write_rows<D>(p.dk + bh * p.M * D, s_f, dk, cos_t, sin_t, p.t_n, p.t_d, k0 + rbase, p.M,
                3 + wg);
  write_rows<D>(p.dv + bh * p.M * D, s_f + 64 * kF, dv, nullptr, nullptr, 0, 0, k0 + rbase, p.M,
                3 + wg);
}

// dq for 128 queries of one (b, h), looping over 64-key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bhnd_dq_kernel(const __grid_constant__ BwdParams p) {
  constexpr int Dp = padded_width(D), kF = Dp + 4;
  constexpr int kSteps = Dp / 16, kQ = tile_bytes(D, kQBlock);
  constexpr int kK = tile_bytes(D, kKTile), kStage = dq_stage_bytes<D>();
  static_assert(2 * 64 * kF * 4 <= 2 * kQ + kStages * kStage, "the epilogue fits");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* s_qs = smem;
  unsigned char* s_do = s_qs + kQ;
  unsigned char* stages = s_do + kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQBlock;
  const long long bh = (long long)b * p.H + h;
  int n_kt = (p.kv_lim + kKTile - 1) / kKTile;  // tiles past kv_lim are all masked
  if (p.causal) n_kt = min(n_kt, (min(q0 + kQBlock, p.N) - 1) / kKTile + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(q_full, 2 * kQ);
      tma_tile<D, kQBlock>(s_qs, &p.tm_qs_blk, q0, h, b, q_full);
      tma_tile<D, kQBlock>(s_do, &p.tm_do_blk, q0, h, b, q_full);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        unsigned char* st = stages + s * kStage;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kK);
        tma_tile<D, kKTile>(st, &p.tm_k_tile, kt * kKTile, h, b, &full[s]);
        tma_tile<D, kKTile>(st + kK, &p.tm_v_tile, kt * kKTile, h, b, &full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int t = threadIdx.x % kWgThreads, lane = t & 31, t4 = lane & 3;
  const int rbase = wg * 64;
  const bool use_seg = p.seg_q != nullptr;
  const int* segk_p = use_seg ? p.seg_k + b * p.segk_b : nullptr;
  int qry[2], segq[2] = {0, 0};
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qry[r] = q0 + rbase + (t >> 5) * 16 + (lane >> 2) + 8 * r;  // < Np: the scratch is padded
    l2[r] = p.lse2[bh * p.Np + qry[r]];
    dl[r] = p.delta[bh * p.Np + qry[r]];
    if (use_seg && qry[r] < p.N) segq[r] = p.seg_q[b * p.segq_b + qry[r]];
  }
  float dq[Dp / 2];  // 64 queries x Dp features
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) dq[i] = 0.f;

  // ping-pong as in the dK/dV kernel
  const int mine = 1 + wg, other = 1 + (wg ^ 1);
  mbar_wait(q_full, 0);
  if (wg == 1) bar_arrive(other, 2 * kWgThreads);  // warpgroup 0 takes the first turn
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages, k0 = kt * kKTile;
    const unsigned char* st = stages + s * kStage;
    mbar_wait(&full[s], (kt / kStages) & 1);

    const uint64_t d_qs = opaque(desc_k<kQBlock>(s_qs, rbase));
    const uint64_t d_do = opaque(desc_k<kQBlock>(s_do, rbase));
    const uint64_t d_k = opaque(desc_k<kKTile>(st, 0));
    const uint64_t d_v = opaque(desc_k<kKTile>(st + kK, 0));
    float sc[32], dp[32];  // S and dP, 64 queries x 64 keys
    bar_sync(mine, 2 * kWgThreads);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {  // S = Q_s K_rot^T, base-2 units
      wgmma_ss<64>(sc, d_qs + step_k<kQBlock>(ks), d_k + step_k<kKTile>(ks), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {  // dP = dO V^T
      wgmma_ss<64>(dp, d_do + step_k<kQBlock>(ks), d_v + step_k<kKTile>(ks), ks > 0);
    }
    wgmma_commit();
    bar_arrive(other, 2 * kWgThreads);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // dS, packed as A fragments as it is made; the masked variant only for a
    // tile a mask can touch
    uint32_t da[4][4];
    auto elementwise = [&](bool masked) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1), r = e >> 1;
          bool ok = true;
          if (masked) {
            ok = key < p.kv_lim;
            if (use_seg && ok) ok = segq[r] >= segk_p[key];
            if (p.causal) ok = ok && key <= qry[r];
          }
          const float pv = ok ? exp2_approx(sc[4 * nt + e] - l2[r]) : 0.f;
          dp[4 * nt + e] = pv * (dp[4 * nt + e] - dl[r]) * p.scale;  // dS
        }
        pack_tile(da[nt / 2], nt & 1, dp + 4 * nt);
      }
    };
    if (use_seg || p.causal || k0 + kKTile > p.kv_lim) {
      elementwise(true);
    } else {
      elementwise(false);
    }
    const uint64_t t_k = opaque(desc_mn<kKTile>(st));
    bar_sync(mine, 2 * kWgThreads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {  // dQ += dS K_rot
      wgmma_rs<Dp>(dq, da[kk], t_k + step_mn<kKTile>(0, kk), 1);
    }
    wgmma_commit();
    if (wg == 0 || kt + 1 < n_kt) bar_arrive(other, 2 * kWgThreads);
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  bar_sync(5, 2 * kWgThreads);  // both consumers are done with the rings
  const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
  const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
  write_rows<D>(p.dq + bh * p.N * D, reinterpret_cast<float*>(smem) + wg * 64 * kF, dq, cos_t,
                sin_t, p.t_n, p.t_d, q0 + rbase, p.N, 3 + wg);
}

template <int D>
cudaError_t launch(const PrologueParams& pro, const BwdParams& p, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem<flash_bwd_bhnd_dkdv_kernel<D>>(dkdv_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  err = allow_smem<flash_bwd_bhnd_dq_kernel<D>>(dq_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const int longest = p.Np > p.M ? p.Np : p.M;
  bhnd_bwd_prologue_kernel<D><<<dim3((longest + kRows - 1) / kRows, p.H, B), 256, 0, stream>>>(pro);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_bhnd_dkdv_kernel<D><<<dim3((p.M + kKeyBlock - 1) / kKeyBlock, p.H, B), kThreads,
                                  dkdv_smem_bytes<D>(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_bhnd_dq_kernel<D><<<dim3(p.Np / kQBlock, p.H, B), kThreads, dq_smem_bytes<D>(),
                                stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 25 element strides, in order
//   q (b, h, n, d), k (b, h, n, d), v (b, h, n, d), out (b, h, n, d),
//   do (b, h, n, d), RoPE tables (b, n, d), query segment ids (b), key
//   segment ids (b).
// cos/sin null: no RoPE (else N == M, and qu, kr are scratch for
// bf16(rot(q)) [B, H, N, D] and bf16(rot(k)) [B, H, M, D]). seg_q null: no
// segment mask (else seg_k is given too). lse is [B, H, N] contiguous; dq
// [B, H, N, D], dk and dv [B, H, M, D] are written contiguous. Scratch, each
// 16-byte aligned: qs [B, H, N, D] bf16, delta and lse2 [B, H, Np] fp32 with
// Np = N rounded up to 128. qscale: scale*log2(e) exactly as B3 received it,
// so q rounds the same. Returns kNotTmaReady (-1) if v, do or (without RoPE)
// q or k is not TMA-ready (unit stride along d, other strides multiples of 8,
// a 16-byte aligned base), else the cudaError_t of the launches (0 on
// success).
extern "C" int vjepa2_flash_bwd_bhnd_bf16(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, const void* cos_t, const void* sin_t, const void* seg_q, const void* seg_k,
    void* dq, void* dk, void* dv, void* qs, void* qu, void* kr, void* delta, void* lse2, int B,
    int H, int D, int N, int M, int kv_lim, int causal, const long long* strides, float scale,
    float qscale, void* stream) {
  const bool rope = cos_t != nullptr;
  if (N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M || (seg_q != nullptr && seg_k == nullptr) ||
      (rope && (N != M || qu == nullptr || kr == nullptr)) || !aligned16(qs) ||
      !aligned16(delta) || !aligned16(lse2))
    return cudaErrorInvalidValue;
  if (strides[11] != 1 || strides[19] != 1 || (!rope && (strides[3] != 1 || strides[7] != 1)))
    return kNotTmaReady;
  const int Np = (N + kQBlock - 1) / kQBlock * kQBlock;
  auto str = [&](int i) { return Str{strides[i], strides[i + 1], strides[i + 2], strides[i + 3]}; };
  auto given = [&](const void* x, int i, int n) {
    return operand(x, strides[i + 2], strides[i + 1], strides[i], D, n, H, B);
  };
  auto packed = [&](const void* x, int n) {
    return operand(x, D, (long long)n * D, (long long)H * n * D, D, n, H, B);
  };

  PrologueParams pro;
  pro.q = static_cast<const bf16*>(q);
  pro.k = static_cast<const bf16*>(k);
  pro.o = static_cast<const bf16*>(out);
  pro.dout = static_cast<const bf16*>(dout);
  pro.lse = static_cast<const float*>(lse);
  pro.sq = str(0);
  pro.sk = str(4);
  pro.so = str(12);
  pro.sdo = str(16);
  pro.cos = static_cast<const float*>(cos_t);
  pro.sin = static_cast<const float*>(sin_t);
  pro.t_b = strides[20];
  pro.t_n = strides[21];
  pro.t_d = strides[22];
  pro.qs = static_cast<bf16*>(qs);
  pro.qu = rope ? static_cast<bf16*>(qu) : nullptr;
  pro.kr = rope ? static_cast<bf16*>(kr) : nullptr;
  pro.delta = static_cast<float*>(delta);
  pro.lse2 = static_cast<float*>(lse2);
  pro.H = H;
  pro.N = N;
  pro.M = M;
  pro.Np = Np;
  pro.qscale = qscale;
  pro.vec = (vec4_ok(q, strides[0], strides[1], strides[2], strides[3]) ? 1 : 0) |
            (vec4_ok(k, strides[4], strides[5], strides[6], strides[7]) ? 2 : 0) |
            (vec4_ok(out, strides[12], strides[13], strides[14], strides[15]) ? 4 : 0) |
            (vec4_ok(dout, strides[16], strides[17], strides[18], strides[19]) ? 8 : 0);

  BwdParams p;
  const Operand o_qs = packed(qs, N), o_do = given(dout, 16, N), o_v = given(v, 8, M);
  const Operand o_qu = rope ? packed(qu, N) : given(q, 0, N);
  const Operand o_kr = rope ? packed(kr, M) : given(k, 4, M);
  if (!tma_ok(o_do) || !tma_ok(o_v) || !tma_ok(o_qu) || !tma_ok(o_kr)) return kNotTmaReady;
  if (!encode(&p.tm_k, o_kr, D, M, H, B, kKeyBlock) ||
      !encode(&p.tm_v, o_v, D, M, H, B, kKeyBlock) ||
      !encode(&p.tm_qs, o_qs, D, N, H, B, kQTile) || !encode(&p.tm_qu, o_qu, D, N, H, B, kQTile) ||
      !encode(&p.tm_do, o_do, D, N, H, B, kQTile) ||
      !encode(&p.tm_qs_blk, o_qs, D, N, H, B, kQBlock) ||
      !encode(&p.tm_do_blk, o_do, D, N, H, B, kQBlock) ||
      !encode(&p.tm_k_tile, o_kr, D, M, H, B, kKTile) ||
      !encode(&p.tm_v_tile, o_v, D, M, H, B, kKTile))
    return cudaErrorInvalidValue;
  p.lse2 = pro.lse2;
  p.delta = pro.delta;
  p.cos = pro.cos;
  p.sin = pro.sin;
  p.t_b = pro.t_b;
  p.t_n = pro.t_n;
  p.t_d = pro.t_d;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.segq_b = strides[23];
  p.segk_b = strides[24];
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.H = H;
  p.N = N;
  p.M = M;
  p.Np = Np;
  p.kv_lim = kv_lim;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(pro, p, B, s);
    case 64: return launch<64>(pro, p, B, s);
    case 80: return launch<80>(pro, p, B, s);
    case 88: return launch<88>(pro, p, B, s);
    case 104: return launch<104>(pro, p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
