// Flash-attention forward over [B, H, N, D] ("BHND") operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vjepa2_tpu/ops/flash_attention.py:166 _fwd_kernel`
// (wrapper `_flash_fwd_bhnd:257`, `pallas_call` `:307`). Same contract:
//   * q, k, v bf16 [B, H, N|M, D], unit stride along d and strides that are
//     multiples of 8 elements from a 16-byte aligned base, as TMA reads them
//     (q, k and v are usually views of one qkv projection output
//     [B, N, 3, H, D]; the wrapper copies any other operand first);
//     D in {80, 88, 104}, the head widths above the DN route's 64, and
//     32 and 64, which the fused LayerNorm route sends here rope-free;
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
//   * out bf16 in the layout its strides give (unit stride along d, even
//     strides), lse [B, H, N] fp32 natural log; a row with no key to attend
//     gives output 0 and lse -inf (the TPU kernel's finite -1e30 mask
//     averages v there).
//
// What bounds it on this card: per score the tensor cores do 4*Dh FLOPs
// (320 at Dh 80) against about 10 scalar operations of softmax; at 989
// TFLOP/s the scalar work and its latency, not the tensor cores or memory,
// set the pace unless the two overlap (memory traffic is ~1/100 of the
// FLOP bound).
//
// Design (`bhnd_hopper.cuh` for the machinery):
//   * with RoPE, one prologue launch (`bhnd_rope_pack_kernel`) writes
//     bf16(rot(k)) token-major [B, H, M, D], since every query block reads
//     every key; a rope-free call (the fused route's) launches nothing else;
//   * the main kernel (`flash_fwd_bhnd_kernel`): 128 queries a block, two
//     consumer warpgroups of 64 rows (232 registers each after setmaxnreg)
//     and a producer warp (40). The producer loads q once and 128-key tiles
//     of k and v through a 3-stage ring by TMA, straight from the caller's
//     (or the prologue's) token-major layout;
//   * each consumer rotates, scales and rounds its 64 q rows in shared
//     memory once (the same `rope_pair` / `round_scaled` as the backward);
//   * S = Q K^T is wgmma m64nNk16 over ceil(D/16) k-steps, both operands in
//     shared memory, N the 128 keys of a tile, or 64 at D 88 and 104, where
//     the wider O accumulator leaves too few registers for a 64 x 128 S and
//     its P; masks, running max and one exp2 per score in registers; P
//     stays in registers as the A operand of O += P V, one wgmma of N = Dp
//     per 16 keys, with v read as the transposed (MN-major) B operand: no
//     copy of v exists;
//   * the two consumers take turns on named barriers (ping-pong): each
//     issues O += P_{u-1} V_{u-1} and S_u = Q K_u, hands the tensor cores to
//     the other, and runs its softmax while the other's products run;
//   * key tiles wholly past kv_lim or above the causal diagonal are skipped.

#include "bhnd_hopper.cuh"

namespace {

constexpr int kBlockQ = 128;  // queries a block, 64 a consumer warpgroup
constexpr int kBlockK = 128;  // keys a tile
constexpr int kStages = 3;
constexpr int kRows = 64;     // tokens per prologue block

struct FwdParams {
  CUtensorMap tm_q, tm_k, tm_v;  // boxes of 64 features x 128 tokens
  const float* cos;              // null: no RoPE
  const float* sin;
  const int* seg_q;              // null: no segment mask; [B|1, N] int32
  const int* seg_k;              // [B|1, M]
  bf16* o;
  float* lse;                    // [B, H, N]
  long long o_n, o_h, o_b;       // out's element strides (unit along d)
  long long t_b, t_n, t_d;       // RoPE table strides
  long long segq_b, segk_b;      // segment-id batch strides
  int H, N, M, kv_lim, causal;
  float qscale;                  // scale * log2(e)
};

struct RotParams {
  const bf16* k;
  long long k_n, k_h, k_b, k_d;
  const float* cos;
  const float* sin;
  long long t_b, t_n, t_d;
  bf16* kr;  // [B, H, M, D]
  int H, M;
  bool vec;  // 8-byte loads of k
};

// Prologue: bf16(rot(k)) for 64 keys of one (b, h), four features a thread
// and their partners D/2 further.
template <int D>
__global__ void __launch_bounds__(256) bhnd_rope_pack_kernel(const RotParams p) {
  constexpr int kHalf = D / 2, kQuads = kHalf / 4;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRows;
  const bf16* k = p.k + b * p.k_b + h * p.k_h;
  const float* cos_t = p.cos + b * p.t_b;
  const float* sin_t = p.sin + b * p.t_b;
  bf16* kr = p.kr + ((long long)b * p.H + h) * p.M * D;
  for (int i = threadIdx.x; i < kRows * kQuads; i += blockDim.x) {
    const int n = t0 + i / kQuads, d = (i % kQuads) * 4;
    if (n >= p.M) continue;
    float4 lo = load4(k + n * p.k_n + d * p.k_d, p.k_d, p.vec);
    float4 hi = load4(k + n * p.k_n + (d + kHalf) * p.k_d, p.k_d, p.vec);
    rope4(lo, hi, cos_t + n * p.t_n, sin_t + n * p.t_n, d, kHalf, p.t_d);
    store4(kr + (long long)n * D + d, lo, 1.f);
    store4(kr + (long long)n * D + d + kHalf, hi, 1.f);
  }
}

template <int D>
constexpr int fwd_smem_bytes() {  // q, the k and v rings, barriers, alignment slack
  return (1 + 2 * kStages) * tile_bytes(D, kBlockK) + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bhnd_kernel(const __grid_constant__ FwdParams p) {
  constexpr int kTile = tile_bytes(D, kBlockK);
  constexpr int Dp = padded_width(D), kSteps = Dp / 16, kHalf = D / 2;
  // Keys per softmax step: the whole tile, or half of it at the widths whose
  // O accumulator leaves too few registers for a 64 x 128 S and its P.
  constexpr int kSub = Dp > 80 ? 64 : kBlockK, kPer = kBlockK / kSub, kNt = kSub / 8;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_q = align1024(smem_raw);
  unsigned char* s_k = s_q + kTile;              // [kStages][kTile]
  unsigned char* s_v = s_k + kStages * kTile;    // [kStages][kTile]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_v + kStages * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  int n_u = (p.kv_lim + kSub - 1) / kSub;  // key sub-tiles; those past kv_lim are all masked
  if (p.causal) n_u = min(n_u, (min(q0 + kBlockQ, p.N) - 1) / kSub + 1);
  const int n_kt = (n_u + kPer - 1) / kPer;  // 128-key tiles through the ring

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
  if (wg == 2) {  // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(q_full, kTile);
      tma_tile<D, kBlockQ>(s_q, &p.tm_q, q0, h, b, q_full);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        tma_tile<D, kBlockK>(s_k + s * kTile, &p.tm_k, j * kBlockK, h, b, &full[s]);
        tma_tile<D, kBlockK>(s_v + s * kTile, &p.tm_v, j * kBlockK, h, b, &full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int t = threadIdx.x % kWgThreads, warp = t >> 5, lane = t & 31;
  const int t4 = lane & 3;
  const int rbase = wg * 64;                         // this warpgroup's rows in the block
  const int row0 = rbase + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const long long bh = (long long)b * p.H + h;
  const bool use_seg = p.seg_q != nullptr;
  const int* segk_p = use_seg ? p.seg_k + b * p.segk_b : nullptr;
  int qrow[2], segq[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + row0 + 8 * r;
    if (use_seg && qrow[r] < p.N) segq[r] = p.seg_q[b * p.segq_b + qrow[r]];
  }

  // q_s = bf16(rot(q) * qscale) for this warpgroup's rows, in place
  mbar_wait(q_full, 0);
  {
    bf16* q = reinterpret_cast<bf16*>(s_q);
    const float* cos_t = p.cos != nullptr ? p.cos + b * p.t_b : nullptr;
    const float* sin_t = p.cos != nullptr ? p.sin + b * p.t_b : nullptr;
    for (int i = t; i < 64 * kHalf; i += kWgThreads) {
      const int r = rbase + i / kHalf, d = i % kHalf, n = q0 + r;
      bf16* lo_p = q + swz(kBlockQ, r, d);
      bf16* hi_p = q + swz(kBlockQ, r, d + kHalf);
      float lo = __bfloat162float(*lo_p), hi = __bfloat162float(*hi_p);
      if (cos_t != nullptr && n < p.N) {
        const long long i_lo = n * p.t_n + d * p.t_d, i_hi = n * p.t_n + (d + kHalf) * p.t_d;
        rope_pair(lo, hi, cos_t[i_lo], sin_t[i_lo], cos_t[i_hi], sin_t[i_hi]);
      }
      *lo_p = round_scaled(lo, p.qscale);
      *hi_p = round_scaled(hi, p.qscale);
    }
  }
  fence_async_smem();
  bar_sync(3 + wg, kWgThreads);

  float s[kSub / 2];                             // S, 64 rows x kSub keys
  float o[Dp / 2];                               // O, 64 rows x Dp features
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) o[i] = 0.f;
  uint32_t pf[kSub / 16][4];                     // P as A fragments, k-steps of 16 keys
  float m_run[2] = {-INFINITY, -INFINITY};       // running max, base-2 units
  float l_run[2] = {0.f, 0.f};                   // this thread's share of the denominator

  // The tensor cores in turns (`pingpong`): O += P V trails S = Q K^T by one
  // sub-tile u (keys [u kSub, (u + 1) kSub), in ring stage (u / kPer) %
  // kStages), so each turn issues both.
  const uint64_t d_q = desc_k<kBlockQ>(s_q, rbase);
  auto issue_s = [&](int u) {  // S_u = Q K_u^T
    const unsigned char* k = s_k + ((u / kPer) % kStages) * kTile;
    const uint64_t d_k = opaque(desc_k<kBlockK>(k, (u % kPer) * kSub));
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      wgmma_ss<kSub>(s, d_q + step_k<kBlockQ>(ks), d_k + step_k<kBlockK>(ks), ks > 0);
    }
  };
  auto issue_pv = [&](int u) {  // O += P_u V_u
    const uint64_t d_v = opaque(desc_mn<kBlockK>(s_v + ((u / kPer) % kStages) * kTile));
    const int kk0 = (u % kPer) * (kSub / 16);
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      wgmma_rs<Dp>(o, pf[kk], d_v + step_mn<kBlockK>(0, kk0 + kk), 1);
    }
  };
  auto finish = [&]() {  // the products issued this turn, done
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
  };
  // masks, running max and denominators, P_u as A fragments, O rescaled
  auto softmax = [&](int u) {
    const int k0 = u * kSub;
    if (use_seg || p.causal || k0 + kSub > p.kv_lim) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          bool ok = key < p.kv_lim;
          if (use_seg && ok) ok = segq[e >> 1] >= segk_p[key];
          if (p.causal) ok = ok && key <= qrow[e >> 1];
          if (!ok) s[4 * nt + e] = -INFINITY;
        }
      }
    }
    online_softmax<kSub>(s, o, pf, m_run, l_run);
  };

  pingpong<kPer, kStages>(wg, lane, n_u, full, empty, issue_s, issue_pv, finish, softmax);

  float denom[2], lse[2];
  row_totals(l_run, m_run, denom, lse);
  bf16* op = p.o + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= p.N) continue;
    bf16* orow = op + qrow[r] * p.o_n;
#pragma unroll
    for (int dt = 0; dt < Dp / 8; ++dt) {
      const int d = dt * 8 + 2 * t4;
      if (d < D) {
        *reinterpret_cast<uint32_t*>(orow + d) =
            pack_bf16(o[4 * dt + 2 * r] / denom[r], o[4 * dt + 2 * r + 1] / denom[r]);
      }
    }
    if (t4 == 0) p.lse[bh * p.N + qrow[r]] = lse[r];
  }
}

template <int D>
cudaError_t launch(const FwdParams& p, const RotParams& rot, int B, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem<flash_fwd_bhnd_kernel<D>>(kSmem);
  if (err != cudaSuccess) return err;
  if (p.cos != nullptr) {
    bhnd_rope_pack_kernel<D><<<dim3((p.M + kRows - 1) / kRows, p.H, B), 256, 0, stream>>>(rot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.N + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd_bhnd_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 21 element strides, in order
//   q (b, h, n, d), k (b, h, n, d), v (b, h, n, d), out (b, h, n, d),
//   RoPE tables (b, n, d), query segment ids (b), key segment ids (b).
// q, v and (without RoPE) k are read by TMA: unit stride along d, the other
// strides multiples of 8, 16-byte aligned bases. cos/sin null: no RoPE (else
// N == M and kr is scratch for bf16(rot(k)), [B, H, M, D], 16-byte
// aligned). seg_q null: no segment mask (else seg_k is given too). out needs
// unit stride along d and even strides; lse is [B, H, N] contiguous. Returns
// kNotTmaReady (-1), launching nothing, if q, v or k is not TMA-ready, else
// the cudaError_t of the launches (0 on success).
extern "C" int vjepa2_flash_fwd_bhnd_bf16(const void* q, const void* k, const void* v,
                                          const void* cos_t, const void* sin_t,
                                          const void* seg_q, const void* seg_k, void* out,
                                          void* lse, void* kr, int B, int H, int D, int N,
                                          int M, int kv_lim, int causal,
                                          const long long* strides, float qscale, void* stream) {
  FwdParams p;
  p.cos = static_cast<const float*>(cos_t);
  p.sin = static_cast<const float*>(sin_t);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.o = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_b = strides[12];
  p.o_h = strides[13];
  p.o_n = strides[14];
  p.t_b = strides[16];
  p.t_n = strides[17];
  p.t_d = strides[18];
  p.segq_b = strides[19];
  p.segk_b = strides[20];
  p.H = H;
  p.N = N;
  p.M = M;
  p.kv_lim = kv_lim;
  p.causal = causal;
  p.qscale = qscale;
  const bool rope = cos_t != nullptr;
  if (N <= 0 || M <= 0 || kv_lim <= 0 || kv_lim > M || strides[15] != 1 ||
      (seg_q != nullptr && seg_k == nullptr) || (rope && (N != M || kr == nullptr)))
    return cudaErrorInvalidValue;
  if (strides[3] != 1 || strides[11] != 1 || (!rope && strides[7] != 1)) return kNotTmaReady;
  const Operand oq = operand(q, strides[2], strides[1], strides[0], D, N, H, B);
  const Operand ov = operand(v, strides[10], strides[9], strides[8], D, M, H, B);
  const Operand ok = rope ? operand(kr, D, (long long)M * D, (long long)H * M * D, D, M, H, B)
                          : operand(k, strides[6], strides[5], strides[4], D, M, H, B);
  if (!tma_ok(oq) || !tma_ok(ov) || !tma_ok(ok)) return kNotTmaReady;
  if (!encode(&p.tm_q, oq, D, N, H, B, kBlockQ) || !encode(&p.tm_k, ok, D, M, H, B, kBlockK) ||
      !encode(&p.tm_v, ov, D, M, H, B, kBlockK))
    return cudaErrorInvalidValue;
  const RotParams rot{static_cast<const bf16*>(k), strides[6], strides[5], strides[4], strides[7],
                      p.cos, p.sin, p.t_b, p.t_n, p.t_d, static_cast<bf16*>(kr), H, M,
                      vec4_ok(k, strides[4], strides[5], strides[6], strides[7])};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, rot, B, s);
    case 64: return launch<64>(p, rot, B, s);
    case 80: return launch<80>(p, rot, B, s);
    case 88: return launch<88>(p, rot, B, s);
    case 104: return launch<104>(p, rot, B, s);
    default: return cudaErrorInvalidValue;
  }
}
