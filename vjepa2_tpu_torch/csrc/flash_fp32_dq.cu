// The fp32 BHND flash backward's first build unit and C entry point (the
// kernel: `flash_fp32.cuh`, `flash_fp32_dq_kernel`). B4/B5 on fp32 operands
// is two launches with the same arguments: this one (delta, then dQ), then
// `vjepa2_flash_bwd_fp32_dkdv` (`flash_fp32_dkdv.cu`), which reads delta.

#include "flash_fp32.cuh"

// dq [B, H, N, D] contiguous fp32 and delta [B, H, N] fp32 = rowsum(dout *
// out); lse [B, H, N] contiguous fp32, natural log. strides: (b, h, n, d) of
// q, k, v, out and dout. Returns the cudaError_t of the launch (0 on success).
extern "C" int vjepa2_flash_bwd_fp32_dq(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B, int H,
                                        int D, int N, int M, const long long* strides,
                                        float scale, float qscale, void* stream) {
  BwdParams p;
  if (!bwd_params(&p, q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, N, M, strides, scale,
                  qscale))
    return cudaErrorInvalidValue;
  return dispatch(D, p, B, static_cast<cudaStream_t>(stream), RunDq{});
}
