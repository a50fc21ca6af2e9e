// Flash attention for Hopper (sm_90a): the bfloat16 and float16 entries
// (AMP) of flash_fwd_packed, flash_fwd_qkv and the packed backward pair.
// The kernels are flash_attention.cuh's, instantiated here at those
// element types only (d_head up to 64 on the 64-wide shape, up to 128 on
// the 128-wide one); the float32 entries are flash_attention.cu's.
#include "flash_attention.cuh"

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched): flash_attention.cu's packed entries with the element type in
// place of float for q, k, v, dout, o, dq, dk and dv (bias, lse, delta and
// dbias stay float32).
#define PACKED_ENTRIES(T, SFX)                                                \
  int flash_fwd_packed_##SFX(                                                 \
      const T* q, long long q_sb, long long q_st, const T* k, long long k_sb, \
      long long k_st, const T* v, long long v_sb, long long v_st,             \
      const float* bias, T* o, long long o_sb, long long o_st, float* lse,    \
      int B, int nh, int Tq, int Tk, int D, float scale, int causal,          \
      float rate, unsigned int seed0, unsigned int seed1, void* stream) {     \
    return fwd_packed(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bias, o,   \
                      o_sb, o_st, lse, B, nh, Tq, Tk, D, scale, causal, rate, \
                      seed0, seed1, stream);                                  \
  }                                                                           \
  int flash_bwd_dq_packed_##SFX(                                              \
      const T* q, long long q_sb, long long q_st, const T* k, long long k_sb, \
      long long k_st, const T* v, long long v_sb, long long v_st,             \
      const float* bias, const T* dout, long long do_sb, long long do_st,     \
      const float* lse, const float* delta, T* dq, long long dq_sb,           \
      long long dq_st, int B, int nh, int Tq, int Tk, int D, float scale,     \
      int causal, float rate, unsigned int seed0, unsigned int seed1,         \
      void* stream) {                                                         \
    return bwd_dq_packed(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bias,   \
                         dout, do_sb, do_st, lse, delta, dq, dq_sb, dq_st, B, \
                         nh, Tq, Tk, D, scale, causal, rate, seed0, seed1,    \
                         stream);                                             \
  }                                                                           \
  int flash_bwd_dkv_packed_##SFX(                                             \
      const T* q, long long q_sb, long long q_st, const T* k, long long k_sb, \
      long long k_st, const T* v, long long v_sb, long long v_st,             \
      const float* bias, const T* dout, long long do_sb, long long do_st,     \
      const float* lse, const float* delta, T* dk, long long dk_sb,           \
      long long dk_st, T* dv, long long dv_sb, long long dv_st, float* dbias, \
      int B, int nh, int Tq, int Tk, int D, float scale, int causal,          \
      float rate, unsigned int seed0, unsigned int seed1, void* stream) {     \
    return bwd_dkv_packed(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bias,  \
                          dout, do_sb, do_st, lse, delta, dk, dk_sb, dk_st,   \
                          dv, dv_sb, dv_st, dbias, B, nh, Tq, Tk, D, scale,   \
                          causal, rate, seed0, seed1, stream);                \
  }                                                                           \
  int flash_fwd_qkv_##SFX(                                                    \
      const T* qkv, long long qkv_sb, long long qkv_st, const float* b_qkv,   \
      const float* bias, T* o, long long o_sb, long long o_st, float* lse,    \
      int B, int nh, int Tq, int Tk, int D, float scale, int causal,          \
      float rate, unsigned int seed0, unsigned int seed1, void* stream) {     \
    return fwd_qkv(qkv, qkv_sb, qkv_st, b_qkv, bias, o, o_sb, o_st, lse, B,   \
                   nh, Tq, Tk, D, scale, causal, rate, seed0, seed1, stream); \
  }

PACKED_ENTRIES(__nv_bfloat16, bf16)
PACKED_ENTRIES(__half, f16)
#undef PACKED_ENTRIES

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
