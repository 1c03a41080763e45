// The fp32 BHND flash forward's build unit and C entry point (the kernel:
// `flash_fp32.cuh`, `flash_fp32_fwd_kernel`). B3 on fp32 operands.

#include "flash_fp32.cuh"

// The forward: out (its strides) and lse [B, H, N] contiguous fp32.
// strides: (b, h, n, d) of q, k, v and out. qscale = scale * log2(e).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vjepa2_flash_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int B, int H, int D, int N, int M,
                                     const long long* strides, float qscale, void* stream) {
  FwdParams p;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B * H > 65535 || !aligned16(lse) ||
      !make_operand(&p.q, q, strides, B, H, N) || !make_operand(&p.k, k, strides + 4, B, H, M) ||
      !make_operand(&p.v, v, strides + 8, B, H, M))
    return cudaErrorInvalidValue;
  Operand o;
  if (!make_operand(&o, out, strides + 12, B, H, N)) return cudaErrorInvalidValue;
  p.o = static_cast<float*>(out);
  p.o_b = o.b;
  p.o_h = o.h;
  p.o_n = o.n;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.N = N;
  p.M = M;
  p.qscale = qscale;
  return dispatch(D, p, B, static_cast<cudaStream_t>(stream), RunFwd{});
}
