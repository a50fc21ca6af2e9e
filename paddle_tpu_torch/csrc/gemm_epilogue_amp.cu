// Fused matmul + epilogue and the FFN chain for Hopper (sm_90a): the
// bfloat16 and float16 entries (AMP).  The kernels are gemm_epilogue.cuh's,
// instantiated here at those element types only; the float32 entries are
// gemm_epilogue.cu's.
#include "gemm_epilogue.cuh"

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  Every tensor is contiguous and 16-byte aligned; the wrappers
// in ops/fused_matmul.py and ops/ffn_chain.py check the shapes.
// The bfloat16 and float16 entries: x, w (w1, w2), residual, y and z0 in
// the element type; gemm_epilogue's ybuf is float32 scratch [M, N] for
// pre-norm rows when a norm runs over N > 768 (else null).
#define ELT_ENTRIES(T, SFX)                                                   \
  int gemm_epilogue_##SFX(                                                    \
      const T* x, const T* w, const float* bias, const T* residual,           \
      const float* gamma, const float* beta, T* y, T* z0,                     \
      unsigned char* mask, float* ybuf, int M, int K, int N, int act,         \
      int approximate, float rate, int norm, float eps, unsigned int seed0,   \
      unsigned int seed1, void* stream) {                                     \
    return gemm_entry(x, w, bias, residual, gamma, beta, y, z0, mask, ybuf,   \
                      M, K, N, act, approximate, rate, norm, eps, seed0,      \
                      seed1, stream);                                         \
  }                                                                           \
  int ffn_chain_##SFX(                                                        \
      const T* x, const T* w1, const float* b1, const T* w2, const float* b2, \
      const T* residual, const float* gamma, const float* beta, T* y,         \
      unsigned char* mask, int M, int K, int F, int N, int act,               \
      int approximate, float rate, int norm, float eps, unsigned int seed0,   \
      unsigned int seed1, void* stream) {                                     \
    return ffn_entry(x, w1, b1, w2, b2, residual, gamma, beta, y, mask, M, K, \
                     F, N, act, approximate, rate, norm, eps, seed0, seed1,   \
                     stream);                                                 \
  }

ELT_ENTRIES(__nv_bfloat16, bf16)
ELT_ENTRIES(__half, f16)
#undef ELT_ENTRIES

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
