// Flash attention for Hopper (sm_90a): the float32 entries.  The kernels,
// their notes and the element-type templates are in flash_attention.cuh;
// the bfloat16 and float16 entries of the packed layout are built from
// flash_attention_amp.cu, a translation unit of their own, so the two
// libraries compile in parallel.
#include "flash_attention.cuh"

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  Packed entries: strides are in elements, `*_sb` between
// batches, `*_st` between rows; the head dimension is contiguous.  The
// packed and qkv entries come in float32 (*_f32), bfloat16 (*_bf16) and
// float16 (*_f16), one signature with the element type in place of float
// for q, k, v, dout, o, dq, dk and dv.

int flash_fwd_packed_f32(const float* q, long long q_sb, long long q_st,
                         const float* k, long long k_sb, long long k_st,
                         const float* v, long long v_sb, long long v_st,
                         const float* bias, float* o, long long o_sb,
                         long long o_st, float* lse, int B, int nh, int Tq,
                         int Tk, int D, float scale, int causal, float rate,
                         unsigned int seed0, unsigned int seed1,
                         void* stream) {
  return fwd_packed(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bias, o,
                    o_sb, o_st, lse, B, nh, Tq, Tk, D, scale, causal, rate,
                    seed0, seed1, stream);
}

int flash_bwd_dq_packed_f32(const float* q, long long q_sb, long long q_st,
                            const float* k, long long k_sb, long long k_st,
                            const float* v, long long v_sb, long long v_st,
                            const float* bias, const float* dout,
                            long long do_sb, long long do_st,
                            const float* lse, const float* delta, float* dq,
                            long long dq_sb, long long dq_st, int B, int nh,
                            int Tq, int Tk, int D, float scale, int causal,
                            float rate, unsigned int seed0,
                            unsigned int seed1, void* stream) {
  return bwd_dq_packed(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bias,
                       dout, do_sb, do_st, lse, delta, dq, dq_sb, dq_st, B,
                       nh, Tq, Tk, D, scale, causal, rate, seed0, seed1,
                       stream);
}

// dk and dv [B, Tk, nh*D] at their own strides (the column slices of one
// [B, T, 3H] dqkv, say); dbias [B, nh, Tk]
int flash_bwd_dkv_packed_f32(const float* q, long long q_sb, long long q_st,
                             const float* k, long long k_sb, long long k_st,
                             const float* v, long long v_sb, long long v_st,
                             const float* bias, const float* dout,
                             long long do_sb, long long do_st,
                             const float* lse, const float* delta, float* dk,
                             long long dk_sb, long long dk_st, float* dv,
                             long long dv_sb, long long dv_st, float* dbias,
                             int B, int nh, int Tq, int Tk, int D,
                             float scale, int causal, float rate,
                             unsigned int seed0, unsigned int seed1,
                             void* stream) {
  return bwd_dkv_packed(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bias,
                        dout, do_sb, do_st, lse, delta, dk, dk_sb, dk_st, dv,
                        dv_sb, dv_st, dbias, B, nh, Tq, Tk, D, scale, causal,
                        rate, seed0, seed1, stream);
}

// q, k, v at column offsets 0, H, 2H of the pre-bias packed projection
// qkv [B, T, 3H] (strides qkv_sb, qkv_st), biased on load by b_qkv [3H];
// self-attention (Tq = Tk = T), o and lse as flash_fwd_packed_f32's.
int flash_fwd_qkv_f32(const float* qkv, long long qkv_sb, long long qkv_st,
                      const float* b_qkv, const float* bias, float* o,
                      long long o_sb, long long o_st, float* lse, int B,
                      int nh, int Tq, int Tk, int D, float scale, int causal,
                      float rate, unsigned int seed0, unsigned int seed1,
                      void* stream) {
  return fwd_qkv(qkv, qkv_sb, qkv_st, b_qkv, bias, o, o_sb, o_st, lse, B, nh,
                 Tq, Tk, D, scale, causal, rate, seed0, seed1, stream);
}


// The flat [B, H, T, D] layout: strides in elements, `*_sb` between
// batches, `*_sh` between heads, `*_st` between rows (the head dimension
// contiguous); the key bias row of (b, h) starts at b*bias_sb + h*bias_sh
// (0 broadcasts a [1|B, 1|H, 1, Tk] bias); lse and delta are [B, H, Tq];
// dk and dv are written contiguous [B, H, Tk, D], dbias [B, H, Tk].
int flash_fwd_flat_f32(const float* q, long long q_sb, long long q_sh,
                       long long q_st, const float* k, long long k_sb,
                       long long k_sh, long long k_st, const float* v,
                       long long v_sb, long long v_sh, long long v_st,
                       const float* bias, long long bias_sb,
                       long long bias_sh, float* o, long long o_sb,
                       long long o_sh, long long o_st, float* lse, int B,
                       int nh, int Tq, int Tk, int D, float scale, int causal,
                       float rate, unsigned int seed0, unsigned int seed1,
                       void* stream) {
  FlashParams P = make_params(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                              bias, B, nh, Tq, Tk, D, scale, causal, rate,
                              seed0, seed1);
  P.q_sh = q_sh; P.k_sh = k_sh; P.v_sh = v_sh;
  P.bias_sb = bias_sb; P.bias_sh = bias_sh;
  P.out = o; P.out_sb = o_sb; P.out_sh = o_sh; P.out_st = o_st;
  P.lse_out = lse;
  P.vec = vec_loads(P);
  return launch(kFwdFlat, P, stream);
}

int flash_bwd_dq_flat_f32(const float* q, long long q_sb, long long q_sh,
                          long long q_st, const float* k, long long k_sb,
                          long long k_sh, long long k_st, const float* v,
                          long long v_sb, long long v_sh, long long v_st,
                          const float* bias, long long bias_sb,
                          long long bias_sh, const float* dout,
                          long long do_sb, long long do_sh, long long do_st,
                          const float* lse, const float* delta, float* dq,
                          long long dq_sb, long long dq_sh, long long dq_st,
                          int B, int nh, int Tq, int Tk, int D, float scale,
                          int causal, float rate, unsigned int seed0,
                          unsigned int seed1, void* stream) {
  FlashParams P = make_params(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                              bias, B, nh, Tq, Tk, D, scale, causal, rate,
                              seed0, seed1);
  P.q_sh = q_sh; P.k_sh = k_sh; P.v_sh = v_sh;
  P.bias_sb = bias_sb; P.bias_sh = bias_sh;
  P.dout = dout; P.do_sb = do_sb; P.do_sh = do_sh; P.do_st = do_st;
  P.lse = lse; P.delta = delta;
  P.out = dq; P.out_sb = dq_sb; P.out_sh = dq_sh; P.out_st = dq_st;
  P.vec = vec_loads(P);
  return launch(kDq, P, stream);
}

int flash_bwd_dkv_flat_f32(const float* q, long long q_sb, long long q_sh,
                           long long q_st, const float* k, long long k_sb,
                           long long k_sh, long long k_st, const float* v,
                           long long v_sb, long long v_sh, long long v_st,
                           const float* bias, long long bias_sb,
                           long long bias_sh, const float* dout,
                           long long do_sb, long long do_sh, long long do_st,
                           const float* lse, const float* delta, float* dk,
                           float* dv, float* dbias, int B, int nh, int Tq,
                           int Tk, int D, float scale, int causal, float rate,
                           unsigned int seed0, unsigned int seed1,
                           void* stream) {
  FlashParams P = make_params(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                              bias, B, nh, Tq, Tk, D, scale, causal, rate,
                              seed0, seed1);
  P.q_sh = q_sh; P.k_sh = k_sh; P.v_sh = v_sh;
  P.bias_sb = bias_sb; P.bias_sh = bias_sh;
  P.dout = dout; P.do_sb = do_sb; P.do_sh = do_sh; P.do_st = do_st;
  P.lse = lse; P.delta = delta;
  P.dk = dk; P.dv = dv; P.dbias = dbias;
  P.vec = vec_loads(P);
  return launch(kDkvFlat, P, stream);
}

// Debug entry: the keep mask [B, nh, Tq, Tk] (1 = kept) the kernels
// draw for (rate, seed), so a plain version can be handed the same mask.
int flash_dropout_mask_u8(unsigned char* mask, int B, int nh, int Tq,
                          int Tk, float rate, unsigned int seed0,
                          unsigned int seed1, void* stream) {
  const long long n = (long long)B * nh * Tq * Tk;
  if (n == 0) return 0;
  FlashParams P = make_params(nullptr, 0, 0, nullptr, 0, 0, nullptr, 0, 0,
                              nullptr, B, nh, Tq, Tk, 1, 1.f, 0, rate, seed0,
                              seed1);
  const long long blocks = (n + 255) / 256;
  dropout_mask_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                        (cudaStream_t)stream>>>(P, mask);
  return (int)cudaGetLastError();
}

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
