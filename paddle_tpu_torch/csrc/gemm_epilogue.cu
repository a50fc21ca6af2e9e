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
// TFLOP/s bounds them, not the 3.35 TB/s of HBM.
//
// The TPU kernels walked a sequential grid with an f32 accumulator in VMEM
// scratch and ran the epilogue on the last K step; the norm reduced over a
// whole [bm, N] row block held in VMEM.
//
// gemm_epilogue: one CTA of 256 threads owns 32 rows.  Its threads are
// 4 x 2 warps: a warp covers 8 rows and half of a column chunk of 256*NV
// columns, a lane 8 rows x 4*NV columns (float4 groups 128 columns apart,
// so a warp's shared-memory reads of a weight row are 512 contiguous
// bytes), all float32 FMA with the accumulators in registers (NV = 3: 96 a
// thread).  The x tile is stored transposed ([k][row]) so the 8 rows a
// warp needs at one k are two broadcast 16-byte reads.  Weight tiles
// stream through a double buffer filled by cp.async (zero-filled past N)
// while the previous tile is consumed.  Without a norm, blockIdx.y picks
// the column chunk; with one, the CTA walks every chunk of its rows, writes
// the pre-norm rows to y, and then each warp normalises 4 whole rows (two
// reads for the mean and the variance, one for the result, from L2/L1).
// 4096 / 32 = 128 CTAs fill 128 of the 132 SMs in one wave.
//
// ffn_chain: f32 FMA on the CUDA cores is fed from shared memory, and a
// warp's shared-memory read costs its 32 lanes' worth of bandwidth even
// when every lane reads the same word, so a thread tile of r x c outputs
// reads r + c words for r * c FMAs: the smaller tile is the one that is
// bound by shared memory, not by the FMA pipes.  Second, each CTA streams
// all of w1 and w2 from L2, so the rows a CTA owns set how often a weight
// element crosses L2.  The design:
//   * A cluster of two CTAs (__cluster_dims__(2, 1, 1), Hopper's
//     distributed shared memory) owns 64 rows, so each weight element is
//     read from L2 once per 64 rows (1.5 GB a call at BERT-base, not 2.4)
//     and 64 clusters still fill 128 SMs.  x is streamed in k tiles with
//     the weights (its rows are re-read once per panel), so shared memory
//     does not grow with K.
//   * F is walked in panels of 512.  CTA r runs GEMM1 for the panel's
//     columns [256r, 256r + 256) over all 64 rows (a thread 8 rows x 8
//     columns), adds b1, applies the activation and stores the half-panel,
//     transposed ([f][row]), into its own shared memory and, through
//     map_shared_rank, into the peer's.  After a cluster barrier each CTA
//     holds the whole activated panel and runs GEMM2 over it into its own
//     columns of N, [128*NV*r, 128*NV*(r+1)) (a thread 8 rows x 4*NV
//     columns, NV = 3: 96 accumulators, 8 rows of 64 x 384 at BERT-base).
//     The barrier is split (arrive after GEMM2 of a panel, wait before the
//     next panel's stores), so one CTA of the pair never waits on the
//     other's GEMM2.
//   * One ring of 2 stages streams x and w1 tiles (32 k) and then w2
//     tiles (16 f) across both phases and across panels.  Thread 0 loads
//     a stage as 2-D TMA boxes (x [64][32], w1 2 x [32][128], w2 NV x
//     [16][128]; zeros past M, K, F and N) counted on the stage's
//     mbarrier; one __syncthreads a stage frees the slot for the next
//     load.  The copies cost the other threads no instructions or load
//     slots, so fewer, deeper stages (fewer barriers) pay: with cp.async
//     from every thread, or with 4 stages of 16 k and 8 f, the kernel
//     was slower.
//   * The epilogue runs in registers: b2, dropout, the residual, then the
//     row norm over both CTAs' halves: each warp sums its 8 rows' halves,
//     lane 0 writes them into both CTAs' shared memory, one cluster
//     barrier; the mean first, then the centred variance the same way, so
//     the two-pass arithmetic of norm_rows is kept.  Both CTAs add rank 0's
//     half to rank 1's, so both normalise a row by the same numbers.
//   Shared memory: 2 stages of 40,960 bytes (x and w1; a w2 stage takes
//   24,576 of them), the panel 512 x 68 floats (139,264 bytes), 1,024
//   bytes of row sums and 2 mbarriers: 222,224 bytes, one CTA an SM.
//   ptxas: 255 registers and no spill at NV = 3 (168 at 1, 221 at 2).
//   Left for later: tensor cores (tf32, 3xtf32 or bf16 operands change the
//   numerics the parity gates assume), a TMA multicast of the x tile that
//   both CTAs of a pair read, and splitting GEMM1 and GEMM2 between
//   specialised warps (tried with 8 and with 12 warps: the 8-warp split
//   spills its 192 accumulators a thread, the 12-warp one leaves one GEMM1
//   warp a scheduler that the others wait on; both were slower, and so was
//   freeing ring slots by mbarrier instead of __syncthreads).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;    // gemm_epilogue: rows per CTA
constexpr int kBK = 8;     // gemm_epilogue: K tile

// ffn_chain
constexpr int kRows = 64;          // rows of a cluster (both CTAs)
constexpr int kPanel = 512;        // F panel
constexpr int kHalf = kPanel / 2;  // GEMM1 columns of one CTA
constexpr int kBK1 = 32;           // K depth of a GEMM1 stage
constexpr int kBK2 = 16;           // F depth of a GEMM2 stage
constexpr int kStages = 2;         // the ring of TMA stages
constexpr int kLdh = kRows + 4;    // row stride of the transposed panel

// floats of one ring stage: a GEMM1 stage (x [kRows][kBK1], w1
// [2][kBK1][128]) or a GEMM2 stage (w2 [NV][kBK2][128]), the larger
__host__ __device__ constexpr int ffn_stage_floats(int nv) {
  return kBK1 * (kRows + kHalf) > kBK2 * 128 * nv ? kBK1 * (kRows + kHalf)
                                                  : kBK2 * 128 * nv;
}

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

// ---- ffn_chain: a two-CTA cluster per 64 rows ------------------------------

// this CTA's rank in its cluster
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier, split: arrive releases this thread's earlier writes
// (to its own and to the peer's shared memory), wait acquires those of
// every thread of the cluster and orders this CTA like __syncthreads
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cta address of p
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// this thread's arrival, expecting `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the mbarrier's phase of `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a 2-D box of the tensor map at (c0 inner, c1 outer) -> shared memory by
// the TMA unit (past the tensor's edges: zeros), counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// GEMM1, one stage: acc[8][8] += x[rows 8w..8w+7][kBK1] w1[kBK1][lane's
// columns 4*lane + {0..3}, 128 + 4*lane + {0..3}]; sX is [kRows][kBK1] (x's
// own layout: four k of a row in one broadcast 16-byte read), sW is two
// TMA boxes [2][kBK1][128] of the half-panel's columns
__device__ __forceinline__ void ffn_gemm1(float (&acc)[8][8], const float* sX,
                                          const float* sW, int warp,
                                          int lane) {
  const float* xa = sX + 8 * warp * kBK1;
  const float* wb = sW + 4 * lane;
#pragma unroll
  for (int kk = 0; kk < kBK1; kk += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(xa + i * kBK1 + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(wb + (kk + q) * 128);
      const float4 v = *reinterpret_cast<const float4*>(
          wb + (kBK1 + kk + q) * 128);
      const float b[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                       : q == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// GEMM2, one stage: acc[8][4*NV] += h[f][rows 8w..8w+7] w2[f][lane's
// columns 128c + 4*lane + {0..3}] over kBK2 f; sH is the panel [f][kLdh]
// (transposed), sW is NV TMA boxes [NV][kBK2][128]
template <int NV>
__device__ __forceinline__ void ffn_gemm2(float (&acc)[8][4 * NV],
                                          const float* sH, const float* sW,
                                          int warp, int lane) {
  constexpr int W2 = 128 * NV;
#pragma unroll
  for (int k = 0; k < kBK2; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(sH + k * kLdh +
                                                       8 * warp);
    const float4 a1 = *reinterpret_cast<const float4*>(sH + k * kLdh +
                                                       8 * warp + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[4 * NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(
          sW + (c * kBK2 + k) * 128 + 4 * lane);
      b[4 * c] = t.x; b[4 * c + 1] = t.y; b[4 * c + 2] = t.z;
      b[4 * c + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the chain's output epilogue up to the norm for 4 consecutive columns of
// one row, in place: b2, dropout (the keep mask written out: Philox of
// (column, row), as epilogue4), the residual
__device__ __forceinline__ void ffn_tail4(const Epilogue& E, int row, int col,
                                          float* v) {
  const long long o = (long long)row * E.N + col;
  if (E.bias) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(E.bias + col));
    v[0] += b.x; v[1] += b.y; v[2] += b.z; v[3] += b.w;
  }
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
}

// the 8 row sums of the pair: each lane's partial s[i] summed over the
// warp, lane 0 writes them to this CTA's slot of red ([2 ranks][kRows]) in
// both CTAs, one cluster barrier, then rank 0's half + rank 1's half (in
// that order in both CTAs, so both get the same sums)
__device__ __forceinline__ void ffn_pair_sums(float (&s)[8], float* red,
                                              float* peer_red, unsigned rank,
                                              int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = warp_sum(s[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[rank * kRows + 8 * warp + i] = s[i];
      peer_red[rank * kRows + 8 * warp + i] = s[i];
    }
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s[i] = red[8 * warp + i] + red[kRows + 8 * warp + i];
}

// One cluster of two CTAs owns kRows rows.  F is walked in panels of
// kPanel: CTA r computes GEMM1 for the panel's columns [r*kHalf,
// (r+1)*kHalf) and writes the activated half-panel into both CTAs' sH;
// after a cluster barrier each CTA runs GEMM2 over the whole panel into
// its own columns of N, [r*128*NV, (r+1)*128*NV).  A warp holds 8 rows in
// both GEMMs.  One ring of TMA stages streams x and w1, then w2, across
// phases and panels; thread 0 issues them.
template <int NV>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
ffn_chain_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const float* __restrict__ b1, const Epilogue E, int K, int F,
                 int act, int approximate) {
  constexpr int W2 = 128 * NV;
  constexpr int STAGE = ffn_stage_floats(NV);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // [kStages][STAGE]
  float* sH = ring + kStages * STAGE;       // [kPanel][kLdh]
  float* sRed = sH + kPanel * kLdh;         // [2 passes][2 ranks][kRows]
  uint64_t* full = reinterpret_cast<uint64_t*>(sRed + 4 * kRows);  // [kStages]
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const unsigned rank = cluster_rank();
  float* peer_h = cluster.map_shared_rank(sH, rank ^ 1);
  float* peer_red = cluster.map_shared_rank(sRed, rank ^ 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (blockIdx.x >> 1) * kRows;
  const int n0 = rank * W2;                 // this CTA's columns of N
  const int T1 = (K + kBK1 - 1) / kBK1;     // GEMM1 stages of a panel
  // GEMM2 stages of panel p: its valid rows of w2 (F % 128 == 0)
  auto t2 = [&](int p) { return min(kPanel, F - p * kPanel) / kBK2; };
  const int steps = (F + kPanel - 1) / kPanel * T1 + F / kBK2;
  auto advance = [&](int& p, int& t) {
    if (++t == T1 + t2(p)) { t = 0; ++p; }
  };
  // stage (p, t) into ring slot `slot` by TMA boxes that thread 0 issues:
  // x [kRows][kBK1], w1 [2][kBK1][128] or w2 [NV][kBK2][128], zero-filled
  // past M, K, F and N (a box counts all its bytes, zeros too)
  auto issue = [&](int p, int t, int slot) {
    float* buf = ring + slot * STAGE;
    const int f0 = p * kPanel;
    if (t < T1) {
      const int k0 = t * kBK1, c0 = f0 + rank * kHalf;
      mbar_expect(full + slot, (kRows * kBK1 + kBK1 * kHalf) * 4);
      tma_load(buf, tx, k0, row0, full + slot);
      tma_load(buf + kRows * kBK1, tw1, c0, k0, full + slot);
      tma_load(buf + kRows * kBK1 + kBK1 * 128, tw1, c0 + 128, k0,
               full + slot);
    } else {
      const int fr = f0 + (t - T1) * kBK2;
      mbar_expect(full + slot, kBK2 * W2 * 4);
#pragma unroll
      for (int c = 0; c < NV; ++c)
        tma_load(buf + c * kBK2 * 128, tw2, n0 + 128 * c, fr, full + slot);
    }
  };

  float acc[8][4 * NV];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;
  float acc1[8][8];

  if (tid == 0) {  // a stage lands when thread 0 arrived and its bytes did
    for (int b = 0; b < kStages; ++b) mbar_init(full + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int ip = 0, it = 0;  // the stage to issue next
  for (int s = 0; s < kStages - 1 && s < steps; ++s) {
    if (tid == 0) issue(ip, it, s);
    advance(ip, it);
  }
  // the cluster barrier's phases alternate: "the peer has finished GEMM2
  // of the previous panel" (the first: "the peer runs"), then "the peer's
  // half of this panel is in sH"
  cluster_arrive();
  int p = 0, t = 0;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(full + s % kStages, (s / kStages) & 1);  // stage s landed
    __syncthreads();  // stage s - 1's slot is consumed by every thread
    if (s + kStages - 1 < steps) {
      if (tid == 0) {
        // the threads' reads of the slot before the TMA unit's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(ip, it, (s + kStages - 1) % kStages);
      }
      advance(ip, it);
    }
    const float* buf = ring + s % kStages * STAGE;
    if (t < T1) {
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc1[i][j] = 0.f;
      }
      ffn_gemm1(acc1, buf, buf + kRows * kBK1, warp, lane);
      if (t == T1 - 1) {
        cluster_wait();  // neither CTA still reads sH
        const int f0 = p * kPanel;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int fp = rank * kHalf + (j >> 2) * 128 + 4 * lane + (j & 3);
          const bool ok = f0 + fp < F;
          const float bb = b1 && ok ? __ldg(b1 + f0 + fp) : 0.f;
          float h[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            h[i] = activation(acc1[i][j] + bb, act, approximate);
          const float4 lo = make_float4(h[0], h[1], h[2], h[3]);
          const float4 hi = make_float4(h[4], h[5], h[6], h[7]);
          const int o = fp * kLdh + 8 * warp;
          *reinterpret_cast<float4*>(sH + o) = lo;
          *reinterpret_cast<float4*>(sH + o + 4) = hi;
          *reinterpret_cast<float4*>(peer_h + o) = lo;
          *reinterpret_cast<float4*>(peer_h + o + 4) = hi;
        }
        cluster_arrive();
        cluster_wait();  // the whole activated panel is in sH
      }
    } else {
      ffn_gemm2<NV>(acc, sH + (t - T1) * kBK2 * kLdh, buf, warp, lane);
      if (t == T1 + t2(p) - 1) cluster_arrive();
    }
    advance(p, t);
  }
  cluster_wait();

  // the epilogue, in registers: b2, dropout, residual, then the row norm
  // over both CTAs' halves (the mean, then the centred variance, as
  // norm_rows); values past M or N are 0 and stay out of the sums
  auto in = [&](int i, int c) {
    return row0 + 8 * warp + i < E.M && n0 + 128 * c + 4 * lane < E.N;
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (in(i, c)) {
        ffn_tail4(E, row0 + 8 * warp + i, n0 + 128 * c + 4 * lane,
                  &acc[i][4 * c]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * c + e] = 0.f;
      }
    }
  if (E.norm) {
    const float inv_n = 1.f / (float)E.N;
    float s[8];
    if (E.norm == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c)
          s[i] += (acc[i][4 * c] + acc[i][4 * c + 1]) +
                  (acc[i][4 * c + 2] + acc[i][4 * c + 3]);
      }
      ffn_pair_sums(s, sRed, peer_red, rank, warp, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float mu = s[i] * inv_n;
#pragma unroll
        for (int j = 0; j < 4 * NV; ++j) acc[i][j] -= mu;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        if (!in(i, c)) continue;
        const float* a = &acc[i][4 * c];
        s[i] += (a[0] * a[0] + a[1] * a[1]) + (a[2] * a[2] + a[3] * a[3]);
      }
    }
    ffn_pair_sums(s, sRed + 2 * kRows, peer_red + 2 * kRows, rank, warp,
                  lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float inv = rsqrtf(s[i] * inv_n + E.eps);
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] *= inv;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (!in(i, c)) continue;
      const int col = n0 + 128 * c + 4 * lane;
      float* o = &acc[i][4 * c];
      if (E.norm && E.gamma) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(E.gamma + col));
        o[0] *= g.x; o[1] *= g.y; o[2] *= g.z; o[3] *= g.w;
      }
      if (E.norm && E.beta) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(E.beta + col));
        o[0] += b.x; o[1] += b.y; o[2] += b.z; o[3] += b.w;
      }
      *reinterpret_cast<float4*>(E.y + (long long)(row0 + 8 * warp + i) *
                                           E.N + col) =
          make_float4(o[0], o[1], o[2], o[3]);
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

size_t ffn_smem_bytes(int NV) {
  return (size_t)(kStages * ffn_stage_floats(NV) + kPanel * kLdh +
                  4 * kRows) * 4 + kStages * sizeof(uint64_t);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the TMA descriptor of a row-major [rows, cols] float32 tensor read in
// boxes of [brows, bcols]; the driver's encoder is found through the runtime,
// so the library links no libcuda
cudaError_t tensor_map(CUtensorMap* map, const float* p, int rows, int cols,
                       int brows, int bcols) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (!fn || q != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bcols, (cuuint32_t)brows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                            (void*)p, dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NV>
cudaError_t launch_ffn(const float* x, const float* w1, const float* b1,
                       const float* w2, const Epilogue& E, int K, int F,
                       int act, int approximate, cudaStream_t stream) {
  CUtensorMap tx, tw1, tw2;
  cudaError_t err = tensor_map(&tx, x, E.M, K, kRows, kBK1);
  if (err == cudaSuccess) err = tensor_map(&tw1, w1, K, F, kBK1, 128);
  if (err == cudaSuccess) err = tensor_map(&tw2, w2, F, E.N, kBK2, 128);
  if (err != cudaSuccess) return err;
  const size_t bytes = ffn_smem_bytes(NV);
  err = cudaFuncSetAttribute(ffn_chain_kernel<NV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * (unsigned)(((long long)E.M + kRows - 1) / kRows));
  ffn_chain_kernel<NV><<<grid, kThreads, bytes, stream>>>(
      tx, tw1, tw2, b1, E, K, F, act, approximate);
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
  if (M < 0 || K <= 0 || K % 16 || F <= 0 || F % 128 || N <= 0 || N % 4 ||
      nv > 3)
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
