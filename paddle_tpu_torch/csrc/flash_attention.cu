// Flash attention for Hopper (sm_90a), float32: three forwards and the
// backward kernels they share, over packed heads and over the flat
// [B, H, T, D] layout.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_ops.py:
//   flash_fwd_packed     <- `_fwd_kernel_packed`      (launched by `_flash_fwd_packed`)
//   flash_bwd_dq_packed  <- `_bwd_dq_kernel_packed`   (launched by `_flash_bwd_packed`)
//   flash_bwd_dkv_packed <- `_bwd_dkv_kernel_packed`  (launched by `_flash_bwd_packed`)
//   flash_fwd_flat       <- `_fwd_kernel`             (launched by `_flash_fwd`)
//   flash_bwd_dq_flat    <- `_bwd_dq_kernel`          (launched by `_flash_bwd`)
//   flash_bwd_dkv_flat   <- `_bwd_dkv_kernel`         (launched by `_flash_bwd`)
// and of paddle_tpu/ops/attention_epilogue.py:
//   flash_fwd_qkv        <- `_qkv_fwd_kernel`         (launched by `_qkv_attn_fwd`)
// The flat kernels are the packed ones instantiated with FLAT: a head
// starts `*_sh` elements (T*D in [B, H, T, D]) into its batch instead of
// h*D, the key bias is one row per (batch, head) (bias_sb, bias_sh: 0
// broadcasts), dk and dv are written in [B, H, Tk, D], and dbias stays
// per (batch, head), as the JAX custom VJP returns it.  The lse cotangent
// of flash_attention_lse is folded into delta by the caller (delta =
// rowsum(do*o) - dlse), so the backward kernels are unchanged by it.
// flash_fwd_qkv is flash_fwd_packed reading q, k and v at column offsets
// 0, H and 2H of the PRE-bias [B, T, 3H] qkv projection (row stride 3H) and
// adding the matching slice of the qkv bias [3H] as each tile is loaded, so
// neither the biased qkv nor its slices are ever written; its dropout
// stream and lse layout are flash_fwd_packed's, so the two backward
// kernels differentiate it (on strided views of the re-biased qkv).
//
// What they compute, per batch b and head h (q, k, v are [B, T, nh*D]
// packed-head tensors, read through their batch and row strides, so the
// three slices of one [B, T, 3H] qkv projection are read in place):
//   s[i][j] = (q_i . k_j) * sm_scale + bias[b][j]       (float32;
//             bias[b][h][j] in the flat layout)
//   s[i][j] = -1e30 where causal and j > i + Tk - Tq    (end-aligned; a
//             finite mask value, so a fully masked row stays finite)
//   p = softmax_j(s); o_i = sum_j drop(p)[i][j] v_j; lse_i = logsumexp_j s
// where drop(p) = p / (1 - rate) if the key-query pair is kept, else 0.
// Backward, from lse (p = exp(s - lse)) and delta_i = do_i . o_i:
//   dp = do . v^T (dropped like p), ds = p * (dp - delta)
//   dq = sm_scale * ds k, dk = sm_scale * ds^T q, dv = drop(p)^T do,
//   dbias[b][h][j] = sum_i ds[i][j]   (summed over heads by the packed
//                                      caller).
// The dropout mask is never stored: bit (b, h, i, j) is Philox-4x32-10 of
// counter (j, i, b*nh + h, 0) under the 64-bit seed, kept when it exceeds
// rate * 2^32, so all three kernels (and the debug mask entry) regenerate
// the same mask.
//
// What bounds them on this card: operations.  At BERT-base shapes (B=32,
// T=128, nh=12, D=64) the forward does 4*B*nh*T*T*D flops (1.6 GFLOP)
// over ~50 MB of q, k, v, o; backward recomputes the scores (dq: 6, dk/dv:
// 8 flops per (i, j, d)), all in float32 outside the tensor cores (the
// reference computes in float32, and TF32 would not hold the 1e-5
// tolerance), so 67 TFLOP/s bounds them, not the 3.35 TB/s of HBM.  The
// flat kernels likewise: at the 4-D op's step (B=8, H=12, T=512, D=64) the
// forward is 6.4 GFLOP over ~50 MB; a causal ring chunk at T=4096 skips
// the tiles above the diagonal, about half.
//
// Design: the TPU kernels walked a sequential grid, carrying the online
// softmax state (or the dq / dk, dv accumulators) in VMEM scratch from one
// grid step to the next, and sliced 128-lane head groups out of the packed
// layout with BlockSpec index maps.  Hopper runs blocks in parallel and in
// no order, so each CTA owns one (64-row tile, head, batch) and loops over
// the other sequence axis itself: the forward and dq kernels loop over key
// tiles for a query tile, the dk/dv kernel loops over query tiles for a key
// tile, so no reduction crosses CTAs and no atomics are needed.  Tiles of
// 64 rows x D are staged in shared memory (rows padded by one float, so the
// 16 threads of a half-warp that read one column of 16 rows hit 16 banks);
// 256 threads as a 16 x 16 grid each hold a 4 x 4 block of the 64 x 64
// score tile (rows ty + 16i, columns tx + 16j) and a 4 x D/16 block of the
// output accumulator, all float32 FMA.  Row maxima and sums reduce across
// the 16 threads of a row with warp shuffles.  Ragged tails (any T) are
// masked: keys past Tk get p = 0 and rows past Tq are not written.  Causal
// tiles entirely above the diagonal are skipped where that is exact.
// Later work: wgmma on tf32/bf16 operands, TMA loads, a deeper pipeline.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // query rows and key columns per tile
constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kLdS = kTile + 1;
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

struct FlashParams {
  const float* q;
  long long q_sb, q_st;
  const float* k;
  long long k_sb, k_st;
  const float* v;
  long long v_sb, v_st;
  const float* bias;  // [B, Tk] key-padding bias (flat: strided rows per
                      // (b, h), see bias_sb / bias_sh), or nullptr
  const float* qkv_bias;  // flash_fwd_qkv: [3H], added to q | k | v on load
  const float* dout;  // backward: the output cotangent
  long long do_sb, do_st;
  const float* lse;    // backward: [B, nh, Tq]
  const float* delta;  // backward: [B, nh, Tq]
  float* out;          // forward: o; dq kernel: dq (strides below)
  long long out_sb, out_st;
  float* lse_out;  // forward: [B, nh, Tq]
  float* dk;       // dk/dv kernel: [B, Tk, nh*D] (flat: [B, nh, Tk, D])
  float* dv;
  float* dbias;  // dk/dv kernel: [B, nh, Tk]
  int B, nh, Tq, Tk, D;
  float scale;
  int causal;
  int dropout;
  uint32_t drop_threshold;  // keep when bits > threshold
  float drop_scale;         // 1 / (1 - rate)
  uint32_t seed0, seed1;
  // the flat layout only, last so that the packed kernels' parameters
  // keep their offsets: the bias row of (b, h) at b*bias_sb + h*bias_sh,
  // and the head strides
  long long bias_sb, bias_sh;
  long long q_sh, k_sh, v_sh, do_sh, out_sh;
};

__device__ __forceinline__ uint32_t philox_bits(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t k0,
                                                uint32_t k1) {
  uint32_t c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ bool keep_pair(const FlashParams& P, int key,
                                          int query, int bh) {
  return philox_bits((uint32_t)key, (uint32_t)query, (uint32_t)bh, P.seed0,
                     P.seed1) > P.drop_threshold;
}

// reductions over the 16 threads of one score row (lanes that differ in
// their low four bits)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [r0, r0 + kTile) x dims [0, DM) of a strided [T, *] head slice into
// shared memory (leading dimension DM + 1), zeros past `rows` and `D`;
// with ADD, add[d] (the head's slice of the qkv bias) to every loaded row
template <int DM, bool ADD = false>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long st, int r0, int rows,
                                          int D, const float* add = nullptr) {
  for (int idx = threadIdx.x; idx < kTile * DM; idx += kThreads) {
    const int r = idx / DM, d = idx % DM, row = r0 + r;
    float x = 0.f;
    if (row < rows && d < D) {
      x = __ldg(g + (long long)row * st + d);
      if (ADD) x += __ldg(add + d);
    }
    s[r * (DM + 1) + d] = x;
  }
}

// Offset of head h in a batch: h*D packed, h*sh flat.  The packed
// branches here and in masked_score are written apart from the flat ones
// on purpose: a bias row pointer shared by both layouts was hoisted out
// of the key loop and cost the packed forward 3 registers, a spill and a
// fifth of its time; as written, the packed kernels compile to the same
// SASS as they do without the flat layout.
template <bool FLAT>
__device__ __forceinline__ long long head_off(long long sh, int h, int D) {
  if constexpr (FLAT) return (long long)h * sh;
  else return (long long)h * D;
}

// the score (i = query, j = key) after scale, bias and the causal mask
template <bool FLAT>
__device__ __forceinline__ float masked_score(const FlashParams& P, float dot,
                                              int b, int h, int query,
                                              int key) {
  float x;
  if constexpr (FLAT)
    x = dot * P.scale +
        (P.bias ? __ldg(P.bias + b * P.bias_sb + h * P.bias_sh + key) : 0.f);
  else
    x = dot * P.scale +
        (P.bias ? __ldg(P.bias + (long long)b * P.Tk + key) : 0.f);
  if (P.causal && key > query + P.Tk - P.Tq) x = kNegInf;
  return x;
}

// key tiles a query tile must visit: under the causal mask, tiles right of
// the diagonal hold only masked keys, whose p is exactly 0 when the row
// sees key 0 (a row with no visible key attends uniformly to all keys, as
// the reference's softmax over -1e30 does, so then nothing is skipped)
__device__ __forceinline__ int key_end(const FlashParams& P, int q0) {
  const int off = P.Tk - P.Tq;
  if (P.causal && q0 + off >= 0) return min(P.Tk, q0 + kTile + off);
  return P.Tk;
}

// QKV: flash_fwd_qkv (q, k, v biased on load by P.qkv_bias); FLAT: the
// [B, H, T, D] layout (never with QKV)
template <int DM, bool QKV, bool FLAT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashParams P) {
  constexpr int LD = DM + 1;
  constexpr int ND = DM / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;  // [kTile][kLdS]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = P.D, bh = b * P.nh + h;

  const int H = P.nh * D;
  const float* qadd = QKV ? P.qkv_bias + (long long)h * D : nullptr;
  const float* kadd = QKV ? qadd + H : nullptr;
  const float* vadd = QKV ? qadd + 2 * H : nullptr;
  load_tile<DM, QKV>(sQ, P.q + b * P.q_sb + head_off<FLAT>(P.q_sh, h, D),
                     P.q_st, q0, P.Tq, D, qadd);
  const float* kb = P.k + b * P.k_sb + head_off<FLAT>(P.k_sh, h, D);
  const float* vb = P.v + b * P.v_sb + head_off<FLAT>(P.v_sh, h, D);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(P, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    load_tile<DM, QKV>(sK, kb, P.k_st, k0, P.Tk, D, kadd);
    load_tile<DM, QKV>(sV, vb, P.v_st, k0, P.Tk, D, vadd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        s[i][j] = kj < P.Tk ? masked_score<FLAT>(P, s[i][j], b, h, qi, kj)
                            : -CUDART_INF_F;  // past the keys: p = 0
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = expf(s[i][j] - m_new);
        rs += p;  // the denominator counts every key, dropped or not
        if (P.dropout) p = keep_pair(P, kj, qi, bh) ? p * P.drop_scale : 0.f;
        sP[(ty + 16 * i) * kLdS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      float pv[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdS + n];
#pragma unroll
      for (int c = 0; c < ND; ++c) vv[c] = sV[n * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= P.Tq) continue;
    const float inv = 1.f / l[i];
    float* o = P.out + b * P.out_sb + qi * P.out_st
               + head_off<FLAT>(P.out_sh, h, D);
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = tx + 16 * c;
      if (d < D) o[d] = acc[i][c] * inv;
    }
    if (tx == 0) P.lse_out[(long long)bh * P.Tq + qi] = m[i] + logf(l[i]);
  }
}

template <int DM, bool FLAT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const FlashParams P) {
  constexpr int LD = DM + 1;
  constexpr int ND = DM / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * LD;
  float* sK = sdO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sS = sV + kTile * LD;  // ds, [kTile][kLdS]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = P.D, bh = b * P.nh + h;

  load_tile<DM>(sQ, P.q + b * P.q_sb + head_off<FLAT>(P.q_sh, h, D), P.q_st,
                q0, P.Tq, D);
  load_tile<DM>(sdO, P.dout + b * P.do_sb + head_off<FLAT>(P.do_sh, h, D),
                P.do_st, q0, P.Tq, D);
  const float* kb = P.k + b * P.k_sb + head_off<FLAT>(P.k_sh, h, D);
  const float* vb = P.v + b * P.v_sb + head_off<FLAT>(P.v_sh, h, D);

  float lse[4], delta[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse[i] = qi < P.Tq ? P.lse[(long long)bh * P.Tq + qi] : 0.f;
    delta[i] = qi < P.Tq ? P.delta[(long long)bh * P.Tq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(P, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<DM>(sK, kb, P.k_st, k0, P.Tk, D);
    load_tile<DM>(sV, vb, P.v_st, k0, P.Tk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      float a[4], g[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + d];
        g[i] = sdO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = sK[(tx + 16 * j) * LD + d];
        w[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = 0.f, dpv = dp[i][j];
        if (kj < P.Tk)
          p = expf(masked_score<FLAT>(P, s[i][j], b, h, qi, kj) - lse[i]);
        if (P.dropout) dpv = keep_pair(P, kj, qi, bh) ? dpv * P.drop_scale : 0.f;
        sS[(ty + 16 * i) * kLdS + tx + 16 * j] = p * (dpv - delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      float ds[4], kv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(ty + 16 * i) * kLdS + n];
#pragma unroll
      for (int c = 0; c < ND; ++c) kv[c] = sK[n * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= P.Tq) continue;
    float* dq = P.out + b * P.out_sb + qi * P.out_st
                + head_off<FLAT>(P.out_sh, h, D);
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dq[d] = acc[i][c] * P.scale;
    }
  }
}

template <int DM, bool FLAT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const FlashParams P) {
  constexpr int LD = DM + 1;
  constexpr int ND = DM / 16;
  extern __shared__ float smem[];
  float* sK = smem;               // key rows of this CTA
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;    // query rows of the current tile
  float* sdO = sQ + kTile * LD;
  float* sPd = sdO + kTile * LD;  // dropped p, [key][query], kLdS
  float* sS = sPd + kTile * kLdS; // ds, [key][query], kLdS
  float* sL = sS + kTile * kLdS;  // lse of the query tile
  float* sDl = sL + kTile;        // delta of the query tile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int D = P.D, bh = b * P.nh + h;

  load_tile<DM>(sK, P.k + b * P.k_sb + head_off<FLAT>(P.k_sh, h, D), P.k_st,
                k0, P.Tk, D);
  load_tile<DM>(sV, P.v + b * P.v_sb + head_off<FLAT>(P.v_sh, h, D), P.v_st,
                k0, P.Tk, D);
  const float* qb = P.q + b * P.q_sb + head_off<FLAT>(P.q_sh, h, D);
  const float* dob = P.dout + b * P.do_sb + head_off<FLAT>(P.do_sh, h, D);

  float dk[4][ND], dv[4][ND], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  // under the causal mask, query tiles wholly before the first query that
  // sees key k0 contribute exactly 0 — unless some row sees no key at all
  // (Tq > Tk), which attends uniformly and so reaches every key
  int q_begin = 0;
  if (P.causal && P.Tq <= P.Tk)
    q_begin = max(0, k0 - (P.Tk - P.Tq)) / kTile * kTile;
  for (int q0 = q_begin; q0 < P.Tq; q0 += kTile) {
    __syncthreads();
    load_tile<DM>(sQ, qb, P.q_st, q0, P.Tq, D);
    load_tile<DM>(sdO, dob, P.do_st, q0, P.Tq, D);
    if (tid < kTile) {
      const int qi = q0 + tid;
      sL[tid] = qi < P.Tq ? P.lse[(long long)bh * P.Tq + qi] : 0.f;
      sDl[tid] = qi < P.Tq ? P.delta[(long long)bh * P.Tq + qi] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // [key i][query j]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      float a[4], w[4], c[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sK[(ty + 16 * i) * LD + d];
        w[i] = sV[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = sQ[(tx + 16 * j) * LD + d];
        g[j] = sdO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j, qi = q0 + ql;
        float p = 0.f;
        if (kj < P.Tk && qi < P.Tq)
          p = expf(masked_score<FLAT>(P, s[i][j], b, h, qi, kj) - sL[ql]);
        float pd = p, dpv = dp[i][j];
        if (P.dropout) {
          const bool keep = keep_pair(P, kj, qi, bh);
          pd = keep ? p * P.drop_scale : 0.f;
          dpv = keep ? dpv * P.drop_scale : 0.f;
        }
        const float ds = p * (dpv - sDl[ql]);
        sPd[(ty + 16 * i) * kLdS + ql] = pd;
        sS[(ty + 16 * i) * kLdS + ql] = ds;
        db[i] += ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      float pd[4], ds[4], qv[ND], gv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pd[i] = sPd[(ty + 16 * i) * kLdS + n];
        ds[i] = sS[(ty + 16 * i) * kLdS + n];
      }
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        qv[c] = sQ[n * LD + tx + 16 * c];
        gv[c] = sdO[n * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          dv[i][c] = fmaf(pd[i], gv[c], dv[i][c]);
          dk[i][c] = fmaf(ds[i], qv[c], dk[i][c]);
        }
    }
  }

  const int H = P.nh * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dbias = row_sum(db[i]);
    const int kj = k0 + ty + 16 * i;
    if (kj >= P.Tk) continue;
    const long long row =
        FLAT ? ((long long)bh * P.Tk + kj) * D
             : ((long long)b * P.Tk + kj) * H + (long long)h * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        P.dk[row + d] = dk[i][c] * P.scale;
        P.dv[row + d] = dv[i][c];
      }
    }
    if (tx == 0) P.dbias[(long long)bh * P.Tk + kj] = dbias;
  }
}

__global__ void dropout_mask_kernel(const FlashParams P, uint8_t* mask) {
  const long long n = (long long)P.B * P.nh * P.Tq * P.Tk;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int key = (int)(idx % P.Tk);
    const int query = (int)((idx / P.Tk) % P.Tq);
    const int bh = (int)(idx / ((long long)P.Tk * P.Tq));
    mask[idx] = keep_pair(P, key, query, bh) ? 1 : 0;
  }
}

enum Which { kFwd, kDq, kDkv, kFwdQkv, kFwdFlat, kDqFlat, kDkvFlat };

template <int DM>
size_t smem_bytes(Which w) {
  const size_t tile = (size_t)kTile * (DM + 1);
  const size_t sq = (size_t)kTile * kLdS;
  switch (w) {
    case kFwd:
    case kFwdQkv:
    case kFwdFlat: return (3 * tile + sq) * sizeof(float);
    case kDq:
    case kDqFlat: return (4 * tile + sq) * sizeof(float);
    default: return (4 * tile + 2 * sq + 2 * kTile) * sizeof(float);
  }
}

template <int DM>
cudaError_t launch_dm(Which w, const FlashParams& P, cudaStream_t stream) {
  void (*kernel)(const FlashParams) =
      w == kFwd ? flash_fwd_kernel<DM, false, false>
      : w == kFwdQkv ? flash_fwd_kernel<DM, true, false>
      : w == kFwdFlat ? flash_fwd_kernel<DM, false, true>
      : w == kDq ? flash_bwd_dq_kernel<DM, false>
      : w == kDqFlat ? flash_bwd_dq_kernel<DM, true>
      : w == kDkv ? flash_bwd_dkv_kernel<DM, false>
      : flash_bwd_dkv_kernel<DM, true>;
  const size_t bytes = smem_bytes<DM>(w);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int rows = (w == kDkv || w == kDkvFlat) ? P.Tk : P.Tq;
  const dim3 grid((rows + kTile - 1) / kTile, P.nh, P.B);
  kernel<<<grid, kThreads, bytes, stream>>>(P);
  return cudaGetLastError();
}

int launch(Which w, const FlashParams& P, void* stream) {
  if (P.B == 0 || P.nh == 0 || P.Tq == 0 || P.Tk == 0) return 0;
  if (P.D <= 0 || P.D > 128 || P.B > 65535 || P.nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (P.D <= 32) return (int)launch_dm<32>(w, P, s);
  if (P.D <= 64) return (int)launch_dm<64>(w, P, s);
  return (int)launch_dm<128>(w, P, s);
}

FlashParams make_params(const float* q, long long q_sb, long long q_st,
                        const float* k, long long k_sb, long long k_st,
                        const float* v, long long v_sb, long long v_st,
                        const float* bias, int B, int nh, int Tq, int Tk,
                        int D, float scale, int causal, float rate,
                        unsigned int seed0, unsigned int seed1) {
  FlashParams P = {};
  P.q = q; P.q_sb = q_sb; P.q_st = q_st;
  P.k = k; P.k_sb = k_sb; P.k_st = k_st;
  P.v = v; P.v_sb = v_sb; P.v_st = v_st;
  P.bias = bias;
  P.B = B; P.nh = nh; P.Tq = Tq; P.Tk = Tk; P.D = D;
  P.scale = scale;
  P.causal = causal;
  P.dropout = rate > 0.f;
  const double thr = (double)rate * 4294967296.0;
  P.drop_threshold = thr >= 4294967295.0 ? 0xffffffffu : (uint32_t)thr;
  P.drop_scale = rate > 0.f ? 1.f / (1.f - rate) : 1.f;
  P.seed0 = seed0;
  P.seed1 = seed1;
  return P;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  Packed entries: strides are in elements, `*_sb` between
// batches, `*_st` between rows; the head dimension is contiguous.

int flash_fwd_packed_f32(const float* q, long long q_sb, long long q_st,
                         const float* k, long long k_sb, long long k_st,
                         const float* v, long long v_sb, long long v_st,
                         const float* bias, float* o, long long o_sb,
                         long long o_st, float* lse, int B, int nh, int Tq,
                         int Tk, int D, float scale, int causal, float rate,
                         unsigned int seed0, unsigned int seed1,
                         void* stream) {
  FlashParams P = make_params(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                              bias, B, nh, Tq, Tk, D, scale, causal, rate,
                              seed0, seed1);
  P.out = o; P.out_sb = o_sb; P.out_st = o_st;
  P.lse_out = lse;
  return launch(kFwd, P, stream);
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
  FlashParams P = make_params(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                              bias, B, nh, Tq, Tk, D, scale, causal, rate,
                              seed0, seed1);
  P.dout = dout; P.do_sb = do_sb; P.do_st = do_st;
  P.lse = lse; P.delta = delta;
  P.out = dq; P.out_sb = dq_sb; P.out_st = dq_st;
  return launch(kDq, P, stream);
}

int flash_bwd_dkv_packed_f32(const float* q, long long q_sb, long long q_st,
                             const float* k, long long k_sb, long long k_st,
                             const float* v, long long v_sb, long long v_st,
                             const float* bias, const float* dout,
                             long long do_sb, long long do_st,
                             const float* lse, const float* delta, float* dk,
                             float* dv, float* dbias, int B, int nh, int Tq,
                             int Tk, int D, float scale, int causal,
                             float rate, unsigned int seed0,
                             unsigned int seed1, void* stream) {
  FlashParams P = make_params(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                              bias, B, nh, Tq, Tk, D, scale, causal, rate,
                              seed0, seed1);
  P.dout = dout; P.do_sb = do_sb; P.do_st = do_st;
  P.lse = lse; P.delta = delta;
  P.dk = dk; P.dv = dv; P.dbias = dbias;
  return launch(kDkv, P, stream);
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
  if (Tq != Tk || b_qkv == nullptr) return (int)cudaErrorInvalidValue;
  const long long H = (long long)nh * D;
  FlashParams P = make_params(qkv, qkv_sb, qkv_st, qkv + H, qkv_sb, qkv_st,
                              qkv + 2 * H, qkv_sb, qkv_st, bias, B, nh, Tq,
                              Tk, D, scale, causal, rate, seed0, seed1);
  P.qkv_bias = b_qkv;
  P.out = o; P.out_sb = o_sb; P.out_st = o_st;
  P.lse_out = lse;
  return launch(kFwdQkv, P, stream);
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
  return launch(kDqFlat, P, stream);
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
  return launch(kDkvFlat, P, stream);
}

// Debug entry: the keep mask [B, nh, Tq, Tk] (1 = kept) the three kernels
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
