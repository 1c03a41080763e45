// The fp32 BHND flash backward's second build unit and C entry point (the
// kernel: `flash_fp32.cuh`, `flash_fp32_dkdv_kernel`), launched after
// `vjepa2_flash_bwd_fp32_dq` (`flash_fp32_dq.cu`) with the same arguments.

#include "flash_fp32.cuh"

// dk and dv [B, H, M, D] contiguous fp32, from the delta the dQ launch wrote.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vjepa2_flash_bwd_fp32_dkdv(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B, int H,
                                        int D, int N, int M, const long long* strides,
                                        float scale, float qscale, void* stream) {
  BwdParams p;
  if (!bwd_params(&p, q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, N, M, strides, scale,
                  qscale))
    return cudaErrorInvalidValue;
  return dispatch(D, p, B, static_cast<cudaStream_t>(stream), RunDkdv{});
}
