// Fused matmul + epilogue and the chained two-GEMM FFN for Hopper (sm_90a),
// float32.
//
// Replaces the Pallas TPU kernels
//   gemm_epilogue <- `_fused_kernel` (paddle_tpu/ops/pallas_matmul.py,
//                    launched by `_fused_fwd`)
//   ffn_chain     <- `_chain_kernel` (paddle_tpu/ops/pallas_ffn_chain.py,
//                    launched by `_chain_fwd`)
//
// What they compute:
//   gemm_epilogue: z = x[M,K] w[K,N] (+ bias), then the epilogue
//   ffn_chain:     h1 = act(x[M,K] w1[K,F] + b1), z = h1 w2[F,N] (+ b2), then
//                  the epilogue without an activation; h1 never leaves the SM
// with the epilogue, in this order and in float32:
//   z0 = z (written out when an activation or a norm follows: backward
//        replays the epilogue from it); h = act(z) (gelu with erf, or its
//        tanh form, or relu); dropout: h = keep ? h / (1 - rate) : 0 and the
//        keep mask (uint8) written out, where keep = Philox-4x32-10 of
//        counter (column, row, 0, 0) under the 64-bit seed > rate * 2^32 — a
//        function of the element alone, so the mask does not depend on the
//        tiles; h += residual; layer norm over the row (population variance,
//        (h - mean) * rsqrt(var + eps)) or rms norm (h * rsqrt(mean(h^2) +
//        eps)), then * gamma + beta.
//
// What bounds them on this card: operations.  At BERT-base (M = 4096 rows,
// K = 768) gemm_epilogue's attention-output call does 2*M*K*N = 4.8 GFLOP
// over ~65 MB, and ffn_chain 2*M*(K*F + F*N) = 38.7 GFLOP over ~69 MB
// (F = 3072, N = 768), in float32 outside the tensor cores (the reference
// computes in float32; TF32 would not hold the parity gates), so 67
// TFLOP/s bounds them, not the 3.35 TB/s of HBM.  Each CTA reads the whole
// weight matrix, from L2 (2.4 MB, and 9.4 MB each for the FFN's two),
// 2*32 flops per weight element: L2's rate is the second limit.
//
// Design: the TPU kernels walked a sequential grid with an f32 accumulator
// in VMEM scratch and ran the epilogue on the last K step; the norm
// reduced over a whole [bm, N] row block held in VMEM.  Here one CTA of
// 256 threads owns 32 rows.  Its threads are 4 x 2 warps: a warp covers 8
// rows and half of a column chunk of 256*NV columns, a lane 8 rows x 4*NV
// columns (float4 groups 128 columns apart, so a warp's shared-memory reads
// of a weight row are 512 contiguous bytes), all float32 FMA with the
// accumulators in registers (NV = 3: 96 a thread).  The x tile is stored
// transposed ([k][row]) so the 8 rows a warp needs at one k are two
// broadcast 16-byte reads.  Weight tiles stream through a double buffer
// filled by cp.async (zero-filled past N) while the previous tile is
// consumed.
//   gemm_epilogue: without a norm, blockIdx.y picks the column chunk; with
//   one, the CTA walks every chunk of its rows, writes the pre-norm rows to
//   y, and then each warp normalises 4 whole rows (two reads for the mean
//   and the variance, one for the result, from L2/L1).
//   ffn_chain: x's 32 rows stay in shared memory (transposed) for the whole
//   kernel; F is walked in panels of 128: GEMM1 gives the [32, 128] panel
//   (a lane 4 x 4), its activation goes to shared memory, and GEMM2 adds
//   panel x w2[panel, :] into the [32, N <= 768] accumulator in registers.
//   One cp.async sequence streams w1 and w2 tiles across both phases and
//   across panels, so no phase starts on an empty pipe.
// 4096 / 32 = 128 CTAs fill 128 of the 132 SMs in one wave.
// Later work: wgmma on tf32/bf16 operands, TMA, clusters multicasting the
// weight tiles (each CTA reads all of w today).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;    // rows per CTA
constexpr int kBK = 8;     // gemm_epilogue: K tile; ffn_chain: F tile of GEMM2
constexpr int kBF = 128;   // ffn_chain: F panel
constexpr int kBK1 = 16;   // ffn_chain: K tile of GEMM1

struct Epilogue {
  const float* bias;      // [N] or nullptr
  const float* residual;  // [M, N] or nullptr
  const float* gamma;     // [N] or nullptr
  const float* beta;      // [N] or nullptr
  float* y;               // [M, N]
  float* z0;              // [M, N] or nullptr
  uint8_t* mask;          // [M, N] or nullptr
  int M, N;
  int act, approximate;   // act: 0 none, 1 gelu, 2 relu
  int dropout;
  uint32_t drop_threshold;  // keep when bits > threshold
  float drop_scale;         // 1 / (1 - rate)
  int norm;                 // 0 none, 1 layer_norm, 2 rms_norm
  float eps;
  uint32_t seed0, seed1;
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

__device__ __forceinline__ float activation(float z, int act,
                                            int approximate) {
  if (act == 1) {
    if (approximate) {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * z * (1.f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
  }
  if (act == 2) return fmaxf(z, 0.f);
  return z;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16 bytes global -> shared without registers; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The epilogue up to the norm for 4 consecutive columns of one row; the
// result goes to y (and z0, the mask) — a function of (row, col) alone.
__device__ __forceinline__ void epilogue4(const Epilogue& E, int row, int col,
                                          float v[4]) {
  const long long o = (long long)row * E.N + col;
  if (E.bias) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(E.bias + col));
    v[0] += b.x; v[1] += b.y; v[2] += b.z; v[3] += b.w;
  }
  if (E.z0)
    *reinterpret_cast<float4*>(E.z0 + o) = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = activation(v[e], E.act, E.approximate);
  if (E.dropout) {
    uchar4 m;
    unsigned char* mb = reinterpret_cast<unsigned char*>(&m);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool keep = philox_bits((uint32_t)(col + e), (uint32_t)row, 0u,
                                    E.seed0, E.seed1) > E.drop_threshold;
      v[e] = keep ? v[e] * E.drop_scale : 0.f;
      mb[e] = keep ? 1 : 0;
    }
    *reinterpret_cast<uchar4*>(E.mask + o) = m;
  }
  if (E.residual) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(E.residual + o));
    v[0] += r.x; v[1] += r.y; v[2] += r.z; v[3] += r.w;
  }
  *reinterpret_cast<float4*>(E.y + o) = make_float4(v[0], v[1], v[2], v[3]);
}

// The norm over whole rows [row0, row0 + kBM) of y, written by this CTA
// before the barrier that precedes this call: warp w takes rows w, w + 8, ...
__device__ void norm_rows(const Epilogue& E, int row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_n = 1.f / (float)E.N;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= E.M) break;
    float* yr = E.y + (long long)row * E.N;
    float mu = 0.f;
    if (E.norm == 1) {
      float s = 0.f;
      for (int c = 4 * lane; c < E.N; c += 128) {
        const float4 v = *reinterpret_cast<const float4*>(yr + c);
        s += (v.x + v.y) + (v.z + v.w);
      }
      mu = warp_sum(s) * inv_n;
    }
    float q = 0.f;
    for (int c = 4 * lane; c < E.N; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(yr + c);
      const float a = v.x - mu, b = v.y - mu, d = v.z - mu, e = v.w - mu;
      q += (a * a + b * b) + (d * d + e * e);
    }
    const float inv = rsqrtf(warp_sum(q) * inv_n + E.eps);
    for (int c = 4 * lane; c < E.N; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(yr + c);
      float o[4] = {(v.x - mu) * inv, (v.y - mu) * inv, (v.z - mu) * inv,
                    (v.w - mu) * inv};
      if (E.gamma) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(E.gamma + c));
        o[0] *= g.x; o[1] *= g.y; o[2] *= g.z; o[3] *= g.w;
      }
      if (E.beta) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(E.beta + c));
        o[0] += b.x; o[1] += b.y; o[2] += b.z; o[3] += b.w;
      }
      *reinterpret_cast<float4*>(yr + c) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// acc[8][4*NV] += A[k][rows 8wr..8wr+7] * B[k][lane's columns] over KT
// steps; A is [KT][32] (transposed rows), B is [KT][256*NV].
template <int NV, int KT>
__device__ __forceinline__ void mma_rows8(float (&acc)[8][4 * NV],
                                          const float* sA, const float* sB,
                                          int wr, int wc, int lane) {
  constexpr int BN = 256 * NV, HW = 128 * NV;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(sA + k * kBM + 8 * wr);
    const float4 a1 =
        *reinterpret_cast<const float4*>(sA + k * kBM + 8 * wr + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[4 * NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(
          sB + k * BN + wc * HW + c * 128 + 4 * lane);
      b[4 * c] = t.x; b[4 * c + 1] = t.y; b[4 * c + 2] = t.z;
      b[4 * c + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the thread's accumulators through epilogue4 (rows past M, columns past N
// are skipped; N % 4 == 0, so a float4 group is all in or all out)
template <int NV>
__device__ __forceinline__ void store_rows8(const Epilogue& E,
                                            float (&acc)[8][4 * NV], int row0,
                                            int n0, int wr, int wc, int lane) {
  constexpr int HW = 128 * NV;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 8 * wr + i;
    if (row >= E.M) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = n0 + wc * HW + c * 128 + 4 * lane;
      if (col >= E.N) continue;
      float v[4] = {acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                    acc[i][4 * c + 3]};
      epilogue4(E, row, col, v);
    }
  }
}

// a [rows, 256*NV] tile of a row-major [*, ld] matrix into shared memory
// by cp.async, columns at or past n_valid zero-filled
template <int NV, int ROWS>
__device__ __forceinline__ void load_b_tile(float* s, const float* g,
                                            long long ld, int n0,
                                            int n_valid) {
  constexpr int BN = 256 * NV, CH = ROWS * BN / 4;
  for (int idx = threadIdx.x; idx < CH; idx += kThreads) {
    const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    const bool ok = n0 + c < n_valid;
    cp_async16(s + r * BN + c, ok ? g + r * ld + n0 + c : g, ok);
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
gemm_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const Epilogue E, int K) {
  constexpr int BN = 256 * NV;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                 // [2][kBK][kBM]
  float* sB = sA + 2 * kBK * kBM;   // [2][kBK][BN]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;
  const int row0 = blockIdx.x * kBM;
  const int nk = K / kBK;
  // x tile loaders: threads 0..63 each move one float4 (row, 4 k's)
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const bool a_loader = tid < kBM * kBK / 4;
  const bool a_row_ok = a_loader && row0 + ar < E.M;
  const float* xa = x + (long long)(row0 + ar) * K + ak;

  for (int n0 = blockIdx.y * BN; n0 < E.N; n0 += gridDim.y * BN) {
    float acc[8][4 * NV];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;

    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // the previous chunk's tiles are consumed
    load_b_tile<NV, kBK>(sB, w, E.N, n0, E.N);
    cp_async_commit();
    if (a_row_ok) av = __ldg(reinterpret_cast<const float4*>(xa));
    if (a_loader) {
      sA[(ak + 0) * kBM + ar] = av.x; sA[(ak + 1) * kBM + ar] = av.y;
      sA[(ak + 2) * kBM + ar] = av.z; sA[(ak + 3) * kBM + ar] = av.w;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int buf = kt & 1;
      const bool more = kt + 1 < nk;
      if (more) {
        load_b_tile<NV, kBK>(sB + (buf ^ 1) * kBK * BN,
                             w + (long long)(kt + 1) * kBK * E.N, E.N, n0,
                             E.N);
        cp_async_commit();
        if (a_row_ok)
          av = __ldg(reinterpret_cast<const float4*>(xa + (kt + 1) * kBK));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mma_rows8<NV, kBK>(acc, sA + buf * kBK * kBM, sB + buf * kBK * BN, wr,
                         wc, lane);
      if (more && a_loader) {
        float* d = sA + (buf ^ 1) * kBK * kBM;
        d[(ak + 0) * kBM + ar] = av.x; d[(ak + 1) * kBM + ar] = av.y;
        d[(ak + 2) * kBM + ar] = av.z; d[(ak + 3) * kBM + ar] = av.w;
      }
      __syncthreads();
    }
    store_rows8<NV>(E, acc, row0, n0, wr, wc, lane);
  }
  if (E.norm) {
    __syncthreads();  // every chunk of these rows is in y
    norm_rows(E, row0);
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
ffn_chain_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const Epilogue E, int K, int F, int act, int approximate) {
  constexpr int BN = 256 * NV;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                  // [K][kBM], x transposed
  float* sW1 = sX + K * kBM;         // [2][kBK1][kBF]
  float* sH = sW1 + 2 * kBK1 * kBF;  // [kBF][kBM], activated panel transposed
  float* sW2 = sH + kBF * kBM;       // [2][kBK][BN]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;  // GEMM2 layout
  const int rg = lane >> 2, cg = lane & 3;  // GEMM1: rows 4rg.., cols 16w+4cg..
  const int row0 = blockIdx.x * kBM;

  // x rows, transposed; lanes take consecutive rows (conflict-free stores)
  for (int idx = tid; idx < kBM * K / 4; idx += kThreads) {
    const int r = idx % kBM, k = (idx / kBM) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < E.M)
      v = __ldg(reinterpret_cast<const float4*>(x + (long long)(row0 + r) * K +
                                                k));
    sX[(k + 0) * kBM + r] = v.x; sX[(k + 1) * kBM + r] = v.y;
    sX[(k + 2) * kBM + r] = v.z; sX[(k + 3) * kBM + r] = v.w;
  }

  // one tile sequence over all panels: per panel T1 w1 tiles, then T2 w2
  const int T1 = K / kBK1, T2 = kBF / kBK, TP = T1 + T2;
  const int steps = (F / kBF) * TP;
  auto issue = [&](int s) {
    const int p = s / TP, t = s % TP, f0 = p * kBF;
    if (t < T1) {
      const float* g = w1 + (long long)t * kBK1 * F + f0;
      float* d = sW1 + (t & 1) * kBK1 * kBF;
      for (int idx = tid; idx < kBK1 * kBF / 4; idx += kThreads) {
        const int r = idx / (kBF / 4), c = (idx % (kBF / 4)) * 4;
        cp_async16(d + r * kBF + c, g + (long long)r * F + c, true);
      }
    } else {
      const int u = t - T1;
      load_b_tile<NV, kBK>(sW2 + (u & 1) * kBK * BN,
                           w2 + (long long)(f0 + u * kBK) * E.N, E.N, 0, E.N);
    }
    cp_async_commit();
  };

  float acc[8][4 * NV];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;
  float acc1[4][4];

  issue(0);
  for (int s = 0; s < steps; ++s) {
    const int p = s / TP, t = s % TP, f0 = p * kBF;
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile s (and, at s = 0, x) is in shared memory
    if (t < T1) {
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc1[i][j] = 0.f;
      }
      const float* a = sX + t * kBK1 * kBM + 4 * rg;
      const float* b = sW1 + (t & 1) * kBK1 * kBF + 16 * warp + 4 * cg;
#pragma unroll
      for (int k = 0; k < kBK1; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(a + k * kBM);
        const float4 bv = *reinterpret_cast<const float4*>(b + k * kBF);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(ar[i], br[j], acc1[i][j]);
      }
      if (t == T1 - 1) {
        // the activated panel, transposed, for GEMM2 (read after the
        // barrier that ends this step)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = 16 * warp + 4 * cg + j;
          const float bb = b1 ? __ldg(b1 + f0 + f) : 0.f;
          float4 h;
          h.x = activation(acc1[0][j] + bb, act, approximate);
          h.y = activation(acc1[1][j] + bb, act, approximate);
          h.z = activation(acc1[2][j] + bb, act, approximate);
          h.w = activation(acc1[3][j] + bb, act, approximate);
          *reinterpret_cast<float4*>(sH + f * kBM + 4 * rg) = h;
        }
      }
    } else {
      const int u = t - T1;
      mma_rows8<NV, kBK>(acc, sH + u * kBK * kBM, sW2 + (u & 1) * kBK * BN, wr,
                         wc, lane);
    }
    __syncthreads();  // tile s is consumed; its buffer may be refilled
  }
  store_rows8<NV>(E, acc, row0, 0, wr, wc, lane);
  if (E.norm) {
    __syncthreads();
    norm_rows(E, row0);
  }
}

Epilogue make_epilogue(const float* bias, const float* residual,
                       const float* gamma, const float* beta, float* y,
                       float* z0, unsigned char* mask, int M, int N, int act,
                       int approximate, float rate, int norm, float eps,
                       unsigned int seed0, unsigned int seed1) {
  Epilogue E = {};
  E.bias = bias; E.residual = residual; E.gamma = gamma; E.beta = beta;
  E.y = y; E.z0 = z0; E.mask = mask;
  E.M = M; E.N = N;
  E.act = act; E.approximate = approximate;
  E.dropout = rate > 0.f;
  const double thr = (double)rate * 4294967296.0;
  E.drop_threshold = thr >= 4294967295.0 ? 0xffffffffu : (uint32_t)thr;
  E.drop_scale = rate > 0.f ? 1.f / (1.f - rate) : 1.f;
  E.norm = norm; E.eps = eps;
  E.seed0 = seed0; E.seed1 = seed1;
  return E;
}

// column groups of 256 a CTA chunk holds: the NV in {3, 2, 1} that pads N
// least (the larger on a tie)
int pick_nv(int N, int max_nv) {
  int best = 1;
  long long best_w = 1LL << 40;
  for (int nv = max_nv; nv >= 1; --nv) {
    const long long w = (long long)((N + 256 * nv - 1) / (256 * nv)) * 256 * nv;
    if (w < best_w) { best_w = w; best = nv; }
  }
  return best;
}

template <int NV>
cudaError_t launch_gemm(const float* x, const float* w, const Epilogue& E,
                        int K, cudaStream_t stream) {
  const size_t bytes = (size_t)(2 * kBK * kBM + 2 * kBK * 256 * NV) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_epilogue_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int chunks = (E.N + 256 * NV - 1) / (256 * NV);
  const dim3 grid((E.M + kBM - 1) / kBM, E.norm ? 1 : chunks);
  gemm_epilogue_kernel<NV><<<grid, kThreads, bytes, stream>>>(x, w, E, K);
  return cudaGetLastError();
}

size_t ffn_smem_bytes(int K, int NV) {
  return (size_t)(K * kBM + 2 * kBK1 * kBF + kBF * kBM + 2 * kBK * 256 * NV) *
         4;
}

template <int NV>
cudaError_t launch_ffn(const float* x, const float* w1, const float* b1,
                       const float* w2, const Epilogue& E, int K, int F,
                       int act, int approximate, cudaStream_t stream) {
  const size_t bytes = ffn_smem_bytes(K, NV);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_chain_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((E.M + kBM - 1) / kBM);
  ffn_chain_kernel<NV><<<grid, kThreads, bytes, stream>>>(
      x, w1, b1, w2, E, K, F, act, approximate);
  return cudaGetLastError();
}

}  // namespace

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
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % kBK || N % 4 || N > 8192 || M < 0 ||
      (M + kBM - 1) / kBM > 2147483647)
    return (int)cudaErrorInvalidValue;
  const Epilogue E = make_epilogue(bias, residual, gamma, beta, y, z0, mask,
                                   M, N, act, approximate, rate, norm, eps,
                                   seed0, seed1);
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_nv(N, 3)) {
    case 3: return (int)launch_gemm<3>(x, w, E, K, s);
    case 2: return (int)launch_gemm<2>(x, w, E, K, s);
    default: return (int)launch_gemm<1>(x, w, E, K, s);
  }
}

int ffn_chain_f32(const float* x, const float* w1, const float* b1,
                  const float* w2, const float* b2, const float* residual,
                  const float* gamma, const float* beta, float* y,
                  unsigned char* mask, int M, int K, int F, int N, int act,
                  int approximate, float rate, int norm, float eps,
                  unsigned int seed0, unsigned int seed1, void* stream) {
  if (M == 0) return 0;
  const int nv = (N + 255) / 256;
  if (K <= 0 || K % kBK1 || F <= 0 || F % kBF || N <= 0 || N % 4 ||
      nv > 3 || ffn_smem_bytes(K, nv) > 232448)
    return (int)cudaErrorInvalidValue;
  // the output epilogue has no activation: act runs between the GEMMs
  const Epilogue E = make_epilogue(b2, residual, gamma, beta, y, nullptr,
                                   mask, M, N, 0, 0, rate, norm, eps, seed0,
                                   seed1);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nv) {
    case 3: return (int)launch_ffn<3>(x, w1, b1, w2, E, K, F, act,
                                      approximate, s);
    case 2: return (int)launch_ffn<2>(x, w1, b1, w2, E, K, F, act,
                                      approximate, s);
    default: return (int)launch_ffn<1>(x, w1, b1, w2, E, K, F, act,
                                       approximate, s);
  }
}

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
