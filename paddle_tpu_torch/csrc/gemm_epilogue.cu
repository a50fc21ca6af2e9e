// Fused matmul + epilogue and the FFN chain for Hopper (sm_90a): the
// float32 entries.  The kernels, their notes and the element-type
// templates are in gemm_epilogue.cuh; the bfloat16 and float16 entries are
// built from gemm_epilogue_amp.cu, a translation unit of their own, so the
// two libraries compile in parallel.
#include "gemm_epilogue.cuh"

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  Every tensor is contiguous and 16-byte aligned; the wrappers
// in ops/fused_matmul.py and ops/ffn_chain.py check the shapes.

int gemm_epilogue_f32(const float* x, const float* w, const float* bias,
                      const float* residual, const float* gamma,
                      const float* beta, float* y, float* z0,
                      unsigned char* mask, int M, int K, int N, int act,
                      int approximate, float rate, int norm, float eps,
                      unsigned int seed0, unsigned int seed1, void* stream) {
  return gemm_entry(x, w, bias, residual, gamma, beta, y, z0, mask, nullptr,
                    M, K, N, act, approximate, rate, norm, eps, seed0, seed1,
                    stream);
}

int ffn_chain_f32(const float* x, const float* w1, const float* b1,
                  const float* w2, const float* b2, const float* residual,
                  const float* gamma, const float* beta, float* y,
                  unsigned char* mask, int M, int K, int F, int N, int act,
                  int approximate, float rate, int norm, float eps,
                  unsigned int seed0, unsigned int seed1, void* stream) {
  return ffn_entry(x, w1, b1, w2, b2, residual, gamma, beta, y, mask, M, K,
                   F, N, act, approximate, rate, norm, eps, seed0, seed1,
                   stream);
}


const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
