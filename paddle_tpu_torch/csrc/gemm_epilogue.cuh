#pragma once
// Fused matmul + epilogue and the chained two-GEMM FFN for Hopper (sm_90a),
// in float32 (gemm_epilogue.cu's entries), bfloat16 and float16
// (gemm_epilogue_amp.cu's).
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
// What bounds them on this card: operations.  gemm_epilogue runs x w as
// TF32 mma.sync.m16n8k8 on the tensor cores with the 3xTF32 split of
// flash_attention.cu (float32's accuracy: the reference computes in float32
// and one TF32 product would not hold the parity gates), three TF32 products
// per float32 one: at BERT-base's attention output (M = 4096 rows, K = N =
// 768) 3 * 4.83 GFLOP over 495 TFLOP/s of TF32 is 0.0293 ms, over the 55.8
// MB that it must move (0.0167 ms at 3.35 TB/s).  ffn_chain still runs
// float32 FMA outside the tensor cores: 2*M*(K*F + F*N) = 38.7 GFLOP (F =
// 3072, N = 768) over 67 TFLOP/s, not the ~69 MB it moves.
//
// The TPU kernels walked a sequential grid with an f32 accumulator in VMEM
// scratch and ran the epilogue on the last K step; the norm reduced over a
// whole [bm, N] row block held in VMEM.
//
// gemm_epilogue (gemm_tc_kernel):
//   * A cluster of two CTAs (__cluster_dims__(2, 1, 1)) owns 64 rows; CTA r
//     computes the columns [32 NB r, 32 NB (r + 1)) of a cluster chunk of
//     64 NB (NB = 12 at N 768: 384 columns a CTA), so each w element
//     crosses L2 once per 64 rows (151 MB a call at BERT-base, where 32-row
//     CTAs that each streamed all of w moved 302 MB) and 64 clusters fill
//     128 SMs.  Each of the 8 warps holds all 64 rows x every eighth n8
//     tile of the CTA's columns: 4 m16 x NB / 2 n8 MMA tiles, 96
//     accumulators a thread at NB 12.
//   * One ring of 3 stages: lanes of warp 0 load a stage as 2-D TMA boxes,
//     the x box [64][32] and NB w boxes [32][32] (128-byte rows, written
//     with the 128-byte swizzle; zeros past M, K and N, so K's, M's and N's
//     tails need no code), counted on the stage's mbarrier; one
//     __syncthreads a stage frees the slot for the next load.
//   * x, which all 8 warps read, is split into TF32 big and small planes
//     once, as the stage lands (each thread its 8 floats, before the
//     stage's barrier); w, which one warp reads, stays raw and is split as
//     its fragments are read.  A thread's k slots t and t + 4 of an m16n8k8
//     step read k = 2t + p and 2t + 1 - p (p the parity of t ^ t >> 1): a
//     sum over k does not care which k is which, and with the swizzle this
//     order puts both the x reads (rows g, g + 8) and the w reads (the k
//     slot's row, column g) on 32 distinct banks.
//   * The tensor cores round each accumulation toward zero.  Over the 288
//     MMAs of one running sum at K 768 that shrank every z by up to 4e-5,
//     always toward zero, and the sums over rows that the backward takes
//     (dgamma, dw) added the shrinkage up past EPI_ATOL.  So the three
//     MMAs of a k8 step sum from zero and the step is added to the
//     accumulator in IEEE float32: z's error falls to the plain float32
//     GEMM's (7e-6), at 4 FADDs an MMA tile a step.
//   * The epilogue runs on the accumulators: bias, z0, the activation,
//     dropout, the residual.  Dropout is a template flag (the path without
//     it carries no Philox code); the keep bits are drawn during the first
//     16 k stages, where the Philox work overlaps the tensor cores', into
//     three words a thread.  The residual tile is prefetched into L2 when a
//     chunk starts, and a row's residual pairs are loaded together ahead of
//     its stores (loads behind the z0 and mask stores could not be hoisted,
//     and each exposed its latency).  With a norm and N <= 768 (one chunk)
//     the rows stay in registers: each warp's quads sum their rows' parts,
//     lane 0 of a quad writes them into both CTAs' shared memory, one
//     cluster barrier, and both CTAs add the 16 partials of a row in one
//     order (the mean first, then the centred variance, as norm_rows).
//     Wider rows walk the chunks, write the pre-norm rows to y, and after a
//     cluster barrier each CTA normalises 32 of the pair's rows from y
//     (norm_rows).  Without a norm, blockIdx.y picks the chunk.
//   Shared memory at NB 12: 3 stages of 65,536 bytes (x's planes, the w
//   boxes), 8,192 bytes of row sums, the mbarriers and 1,024 bytes of
//   alignment slack: 205,848 bytes, one CTA an SM.  ptxas: 255 registers
//   at NB 12, no spill (the step sums and FADDs took it there from 208).
//   Tried and dropped, on one H100 at BERT-base: 2 x 4 warps of 32 x 96
//   with both operands split as read (0.154 ms against 0.153 for this
//   shape before the tail fixes); Philox drawn before the main loop (0.019
//   ms not hidden); a keep-mask word per n8 tile (a 56-byte spill); one
//   running sum (0.107 ms, but the gradient gates failed); spans of 128 k
//   folded through y (too close to the gates at 4096 rows in a CPU model
//   of the rounding, and each fold waits on its loads); all four x
//   fragments held across the step's folds (76-80 bytes spilled, 0.129
//   ms).  Left for later: wgmma (TF32 needs both shared-memory operands
//   K-major: y^T = w^T x^T with w^T from registers), a TMA multicast of x
//   and w in a 2 x 2 cluster (L2 traffic of w halves again).

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
//   Left for later: the tensor cores (3xTF32 holds the gates, as
//   gemm_epilogue shows), a TMA multicast of the x tile that
//   both CTAs of a pair read, and splitting GEMM1 and GEMM2 between
//   specialised warps (tried with 8 and with 12 warps: the 8-warp split
//   spills its 192 accumulators a thread, the 12-warp one leaves one GEMM1
//   warp a scheduler that the others wait on; both were slower, and so was
//   freeing ring slots by mbarrier instead of __syncthreads).
//
// Element types (AMP).  Both kernels also run in bfloat16 and float16
// (entries gemm_epilogue_bf16/_f16, ffn_chain_bf16/_f16; the element type
// Elt is their last template argument): x, the weights, the residual, y
// and z0 are in Elt; the biases, gamma and beta stay float32, and so does
// every sum.  An Elt value is exact in TF32 and in a float32 product, so
// each stage is widened to float32 as it lands and the float32 kernel's
// arithmetic runs on it: gemm_epilogue issues ONE TF32 mma.sync a k8 step
// (the 3xTF32 split's small parts are exactly zero), ffn_chain its float32
// FMAs; the products are exact and the sums float32, as the JAX dots with
// preferred_element_type=float32.  The JAX kernels' rounding points are
// kept: gemm_epilogue stores z0 = z in Elt (pallas_matmul.py
// `z.astype`), runs the epilogue on the float32 z and stores y in Elt;
// ffn_chain rounds the activated panel to Elt before GEMM2
// (pallas_ffn_chain.py `h1.astype(x.dtype)`) and stores y in Elt.  Rows
// that gemm_epilogue normalises after a cluster barrier (N past one chunk)
// wait in a float32 scratch, not in y.  The stages are not TMA boxes:
// every thread loads its part with plain 8-byte loads (4 elements) and
// writes it widened where the float32 box lands (gemm_epilogue: at the
// 128-byte swizzle's positions, so the fragment reads are unchanged), in
// the slot the TMA unit would fill and at the point where thread 0 would
// issue it; the ring's barriers order the writes.  Native bfloat16 mma,
// wgmma and 2-byte TMA stages are later work.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;    // gemm_epilogue: rows a CTA normalises

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

// ---- element types (see the header)

template <typename Elt>
constexpr bool kF32 = std::is_same<Elt, float>::value;

// the epilogue of an Elt kernel: Epilogue's float pointers residual, y
// and z0 hold Elt; x and the weights are read by the threads (no TMA), and
// pre-norm rows wider than one chunk wait in ybuf (float32)
template <typename Elt>
struct EpiT : Epilogue {
  const Elt* x;
  const Elt* w;   // gemm_epilogue's w; ffn_chain's w1
  const Elt* w2;  // ffn_chain
  float* ybuf;
};
template <>
struct EpiT<float> : Epilogue {};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename Elt>
__device__ __forceinline__ Elt narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to Elt (float32: x itself), a rounding point of the JAX kernels
template <typename Elt>
__device__ __forceinline__ float round_to(float x) {
  return widen(narrow<Elt>(x));
}

// n consecutive Elt at p (aligned to n elements), widened
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 widen2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
template <typename Elt>
__device__ __forceinline__ float4 widen4(const Elt* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = widen2(reinterpret_cast<const Elt*>(&u.x));
  const float2 b = widen2(reinterpret_cast<const Elt*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two and four floats stored at p as Elt
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
template <typename Elt>
__device__ __forceinline__ void store4(Elt* p, float4 v) {
  uint2 u;
  store2(reinterpret_cast<Elt*>(&u.x), v.x, v.y);
  store2(reinterpret_cast<Elt*>(&u.y), v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// the Epilogue's float pointer p as Elt
template <typename Elt>
__device__ __forceinline__ Elt* elem(const float* p) {
  return const_cast<Elt*>(reinterpret_cast<const Elt*>(p));
}

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

// The norm over whole rows [row0, row0 + kBM) of y (an Elt kernel: of
// ybuf, into y), written by this CTA before the barrier that precedes this
// call: warp w takes rows w, w + 8, ...
template <typename Elt>
__device__ void norm_rows(const EpiT<Elt>& E, int row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_n = 1.f / (float)E.N;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= E.M) break;
    float* yr;
    if constexpr (kF32<Elt>) yr = E.y + (long long)row * E.N;
    else yr = E.ybuf + (long long)row * E.N;
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
      if constexpr (kF32<Elt>)
        *reinterpret_cast<float4*>(yr + c) =
            make_float4(o[0], o[1], o[2], o[3]);
      else
        store4(elem<Elt>(E.y) + (long long)row * E.N + c,
               make_float4(o[0], o[1], o[2], o[3]));
    }
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
// (column, row), as gemm_keep), the residual
template <typename Elt>
__device__ __forceinline__ void ffn_tail4(const EpiT<Elt>& E, int row,
                                          int col, float* v) {
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
    float4 r;
    if constexpr (kF32<Elt>)
      r = __ldg(reinterpret_cast<const float4*>(E.residual + o));
    else
      r = widen4(elem<Elt>(E.residual) + o);
    v[0] += r.x; v[1] += r.y; v[2] += r.z; v[3] += r.w;
  }
}

// An Elt stage of ffn_chain (no TMA), loaded by every thread where
// issue()'s boxes land: a GEMM1 stage (x [kRows][kBK1] at buf, w1's two
// [kBK1][128] boxes after it) or a GEMM2 stage (w2's NV [kBK2][128]
// boxes), widened, zeros past M, K, F and N
template <int NV, typename Elt>
__device__ __forceinline__ void ffn_load(float* buf, const EpiT<Elt>& E,
                                         int K, int F, int row0, int k0,
                                         int c0, int fr, int n0, bool g1) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g1) {
    for (int i = threadIdx.x; i < kRows * kBK1 / 4; i += kThreads) {
      const int r = i / (kBK1 / 4), k = k0 + i % (kBK1 / 4) * 4;
      const int row = row0 + r;
      *reinterpret_cast<float4*>(buf + 4 * i) =
          row < E.M && k < K ? widen4(E.x + (long long)row * K + k) : zero;
    }
    float* bw = buf + kRows * kBK1;
    for (int i = threadIdx.x; i < 2 * kBK1 * 32; i += kThreads) {
      const int b = i / (kBK1 * 32), r = i / 32 % kBK1;
      const int col = c0 + 128 * b + i % 32 * 4, kr = k0 + r;
      *reinterpret_cast<float4*>(bw + 4 * i) =
          kr < K && col < F ? widen4(E.w + (long long)kr * F + col) : zero;
    }
  } else {
    for (int i = threadIdx.x; i < NV * kBK2 * 32; i += kThreads) {
      const int c = i / (kBK2 * 32), r = i / 32 % kBK2;
      const int col = n0 + 128 * c + i % 32 * 4, f = fr + r;
      *reinterpret_cast<float4*>(buf + 4 * i) =
          f < F && col < E.N ? widen4(E.w2 + (long long)f * E.N + col)
                             : zero;
    }
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
template <int NV, typename Elt = float>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
ffn_chain_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const float* __restrict__ b1, const EpiT<Elt> E, int K,
                 int F, int act, int approximate) {
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
  // an Elt stage: every thread loads its part of (p, t) into `slot`
  auto load = [&](int p, int t, int slot) {
    if constexpr (!kF32<Elt>) {
      const int f0 = p * kPanel;
      ffn_load<NV>(ring + slot * STAGE, E, K, F, row0, t * kBK1,
                   f0 + rank * kHalf, f0 + (t - T1) * kBK2, n0, t < T1);
    }
  };
  for (int s = 0; s < kStages - 1 && s < steps; ++s) {
    if constexpr (kF32<Elt>) {
      if (tid == 0) issue(ip, it, s);
    } else {
      load(ip, it, s);
    }
    advance(ip, it);
  }
  // the cluster barrier's phases alternate: "the peer has finished GEMM2
  // of the previous panel" (the first: "the peer runs"), then "the peer's
  // half of this panel is in sH"
  cluster_arrive();
  int p = 0, t = 0;
  for (int s = 0; s < steps; ++s) {
    if constexpr (kF32<Elt>)
      mbar_wait(full + s % kStages, (s / kStages) & 1);  // stage s landed
    __syncthreads();  // stage s - 1's slot is consumed by every thread
    if (s + kStages - 1 < steps) {
      if constexpr (kF32<Elt>) {
        if (tid == 0) {
          // the threads' reads of the slot before the TMA unit's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(ip, it, (s + kStages - 1) % kStages);
        }
      } else {
        load(ip, it, (s + kStages - 1) % kStages);
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
            h[i] = round_to<Elt>(activation(acc1[i][j] + bb, act,
                                            approximate));
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
      const long long yo = (long long)(row0 + 8 * warp + i) * E.N + col;
      if constexpr (kF32<Elt>)
        *reinterpret_cast<float4*>(E.y + yo) =
            make_float4(o[0], o[1], o[2], o[3]);
      else
        store4(elem<Elt>(E.y) + yo, make_float4(o[0], o[1], o[2], o[3]));
    }
}

// ---- gemm_epilogue: a 3xTF32 tensor-core GEMM, a two-CTA cluster per 64 rows

constexpr int kGRows = 64;   // rows of a cluster (both CTAs compute all 64)
constexpr int kGK = 32;      // K depth of a stage: the x box's 128-byte rows
constexpr int kGBox = 32;    // columns of a w box: 128-byte rows
constexpr int kGStages = 3;  // the ring of TMA stages

// floats of one stage: the x box [kGRows][kGK] (split in place: its big
// parts) and its small parts, then NB w boxes [kGK][kGBox]
__host__ __device__ constexpr int gemm_stage_floats(int nb) {
  return 2 * kGRows * kGK + nb * kGK * kGBox;
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, 10 mantissa
// bits kept), bit for bit on finite values and infinities: half a unit of
// the last kept place added to the magnitude bits, the 13 dropped bits
// cleared.  Two integer operations, where the PTX instruction compiles to
// a longer sequence with range checks and selects.  Not on a NaN: the add
// carries the canonical NaN 0x7fffffff through the exponent into a zero
// (split_tf32 keeps the NaN).  (This helper and the four below
// are flash_attention.cu's, copied: each kernel source builds alone.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// an m16n8k8 operand fragment as TF32 big and small parts
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
  // a NaN operand stays a NaN in the product (the plain version's and
  // the Pallas kernel's NaN), where tf32_rna would make it a zero
  if (x != x) big = 0x7fffffffu;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at float32 accuracy: the cross terms first, then big.big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Frag<4>& a,
                                           const Frag<2>& b) {
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

// the GEMM's keep bit: Philox of (column, row), as ffn_tail4 draws it (a
// function of its own so that tools/gemm_breakdown.py can compile Philox
// out of this kernel alone)
__device__ __forceinline__ bool gemm_keep(const Epilogue& E, int row,
                                          int col) {
  return philox_bits((uint32_t)col, (uint32_t)row, 0u, E.seed0, E.seed1) >
         E.drop_threshold;
}

// The epilogue up to the norm for columns col and col + 1 of one row, in
// place, given the bias b and the residual r of the pair (zeros where
// absent) and the keep bits k0, k1: bias, z0 written, the activation,
// dropout (the keep mask written), the residual.  col is even and N % 4
// == 0, so the pair is all in or out.
template <bool DROP, typename Elt>
__device__ __forceinline__ void epilogue2(const EpiT<Elt>& E, int row,
                                          int col, float& v0, float& v1,
                                          float2 b, float2 r, bool k0,
                                          bool k1) {
  const long long o = (long long)row * E.N + col;
  v0 += b.x;
  v1 += b.y;
  if constexpr (kF32<Elt>) {
    if (E.z0) *reinterpret_cast<float2*>(E.z0 + o) = make_float2(v0, v1);
  } else {
    if (E.z0) store2(elem<Elt>(E.z0) + o, v0, v1);
  }
  v0 = activation(v0, E.act, E.approximate);
  v1 = activation(v1, E.act, E.approximate);
  if (DROP) {
    v0 = k0 ? v0 * E.drop_scale : 0.f;
    v1 = k1 ? v1 * E.drop_scale : 0.f;
    *reinterpret_cast<uchar2*>(E.mask + o) = make_uchar2(k0, k1);
  }
  v0 += r.x;
  v1 += r.y;
}

// 128 bytes at p into L2 (a hint)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// the sums of this thread's 8 rows (8 i + g of the cluster's 64) over the
// pair's columns: each s[i] summed over the quad, lane t = 0 writes it to
// slot [rank][warp][row] of red ([2 ranks][8 warps][kGRows]) in both CTAs,
// one cluster barrier, then the 16 partials of a row added in one order
// (rank 0's warps, then rank 1's) in both CTAs, so both normalise a row by
// the same numbers
__device__ __forceinline__ void gemm_pair_sums(float (&s)[8], float* red,
                                               float* peer_red, unsigned rank,
                                               int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (rank * 8 + warp) * kGRows + 8 * i + g;
      red[o] = s[i];
      peer_red[o] = s[i];
    }
  }
  cluster_arrive();  // this CTA's partial sums are in both CTAs' red
  cluster_wait();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * i + g;
    float a = red[r];
#pragma unroll
    for (int q = 1; q < 16; ++q) a += red[q * kGRows + r];
    s[i] = a;
  }
}

// One cluster of two CTAs owns kGRows rows; cluster chunk c of N is 64 NB
// columns, CTA r computes [64 NB c + 32 NB r, + 32 NB).  Warp w holds all
// 64 rows x NB / 2 n8 tiles of the CTA's columns, every eighth: acc[mi][j]
// is the m16n8 tile (rows 16 mi, columns 64 j + 8 w), element e at row
// g + 8 (e / 2), column 2t + e % 2.  Without a norm blockIdx.y is the
// chunk; with one the cluster walks every chunk (gridDim.y = 1), in
// registers when there is only one.
// An Elt stage of gemm_epilogue (no TMA), loaded by every thread where
// issue()'s boxes land: the x box [kGRows][kGK] (its big plane: an Elt
// value is its own TF32 big part) and NB w boxes [kGK][kGBox] from column
// c0, each 16-byte chunk q of a box's row r at chunk q ^ (r % 8) as the
// 128-byte swizzle puts it, widened, zeros past M, K and N
template <int NB, typename Elt>
__device__ __forceinline__ void gemm_load(float* buf, const EpiT<Elt>& E,
                                          int K, int row0, int k0, int c0) {
  constexpr int XT = kGRows * kGK, BOX = kGK * kGBox;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < XT / 4; i += kThreads) {
    const int r = i >> 3, q = i & 7, row = row0 + r, k = k0 + 4 * q;
    *reinterpret_cast<float4*>(buf + r * kGK + ((q ^ (r & 7)) << 2)) =
        row < E.M && k < K ? widen4(E.x + (long long)row * K + k) : zero;
  }
  for (int i = threadIdx.x; i < NB * BOX / 4; i += kThreads) {
    const int b = i / (BOX / 4), r = (i >> 3) % kGK, q = i & 7;
    const int kr = k0 + r, col = c0 + b * kGBox + 4 * q;
    *reinterpret_cast<float4*>(buf + 2 * XT + b * BOX + r * kGBox +
                               ((q ^ (r & 7)) << 2)) =
        kr < K && col < E.N ? widen4(E.w + (long long)kr * E.N + col) : zero;
  }
}

template <int NB, bool DROP, typename Elt = float>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw, const EpiT<Elt> E,
               int K) {
  constexpr int STAGE = gemm_stage_floats(NB), CW = kGBox * NB, NJ = NB / 2,
                XT = kGRows * kGK;  // the x box; its small plane XT on
  extern __shared__ float gsm[];
  // the ring at a 1024-byte boundary, the period of the 128-byte swizzle
  float* ring = gsm + ((1024u - (smem_u32(gsm) & 1023u)) & 1023u) / 4;
  float* sRed = ring + kGStages * STAGE;  // [2 passes][2 ranks][8][kGRows]
  uint64_t* full = reinterpret_cast<uint64_t*>(sRed + 32 * kGRows);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const unsigned rank = cluster_rank();
  float* peer_red = cluster.map_shared_rank(sRed, rank ^ 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x >> 1) * kGRows;
  const int T = (K + kGK - 1) / kGK;  // stages of a chunk
  const int chunks = (E.N + 2 * CW - 1) / (2 * CW);
  const int steps =
      (chunks - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y * T;
  const bool reg_norm = E.norm && chunks == 1;

  // stage s (chunk blockIdx.y + s / T * gridDim.y, k tile s % T) into ring
  // slot `slot`, by warp 0: lane 0 counts the stage's bytes on the slot's
  // mbarrier and loads the x box, lane 1 + b the w box b (a box counts all
  // its bytes, the zeros past M, K and N too)
  auto issue = [&](int s, int slot) {
    const int c = blockIdx.y + s / T * gridDim.y, k0 = s % T * kGK;
    float* buf = ring + slot * STAGE;
    if (lane == 0) {
      mbar_expect(full + slot, (XT + NB * kGK * kGBox) * 4);
      tma_load(buf, tx, k0, row0, full + slot);
    } else if (lane <= NB) {
      tma_load(buf + 2 * XT + (lane - 1) * kGK * kGBox, tw,
               c * 2 * CW + rank * CW + (lane - 1) * kGBox, k0, full + slot);
    }
  };

  // fragment offsets.  The swizzle stores the 16-byte chunk q of a box's
  // row r at chunk q ^ (r % 8).  k slot t of an m16n8k8 step reads k = 2t
  // + p, slot t + 4 reads 2t + 1 - p (p = parity of t ^ t >> 1): the four
  // k's of a slot then differ in k % 4 and in k / 2, which spreads the x
  // reads (row g, chunk (k / 4) ^ g, word k % 4) and the w reads (row k,
  // chunk (2 (warp % 4) + g / 4) ^ k, word g % 4) over 32 banks.  The
  // warp's n8 tile j is the CTA's 8 j + warp: w box 2 j + warp / 4, its
  // columns 8 (warp % 4) on, so one offset a k slot serves every j
  const int p = (t ^ (t >> 1)) & 1;
  const int ks0 = 2 * t + p, ks1 = 2 * t + 1 - p;
  const int ag = (t >> 1) ^ g;  // x chunk of k step kk: ag ^ 2 kk
  const int xo0 = g * kGK + (ks0 & 3), xo1 = g * kGK + (ks1 & 3);
  const int wbox = 2 * XT + (warp >> 2) * kGK * kGBox;
  const int wo0 = wbox + ks0 * kGBox + 8 * ((warp & 3) ^ t) +
                  4 * ((g >> 2) ^ (ks0 & 1)) + (g & 3);
  const int wo1 = wbox + ks1 * kGBox + 8 * ((warp & 3) ^ t) +
                  4 * ((g >> 2) ^ (ks1 & 1)) + (g & 3);

  // an Elt stage: every thread loads its part of stage s into `slot`
  auto load = [&](int s, int slot) {
    if constexpr (!kF32<Elt>)
      gemm_load<NB>(ring + slot * STAGE, E, K, row0, s % T * kGK,
                    (blockIdx.y + s / T * gridDim.y) * 2 * CW + rank * CW);
  };

  float acc[4][NJ][4];
  if (tid == 0) {  // a stage lands when lane 0 arrived and its bytes did
    for (int b = 0; b < kGStages; ++b) mbar_init(full + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < kGStages - 1 && s < steps; ++s) {
    if constexpr (kF32<Elt>) {
      if (warp == 0) issue(s, s);
    } else {
      load(s, s);
    }
  }
  cluster_arrive();  // "this CTA runs": the peer may write its red
  int s = 0, c = blockIdx.y;
  for (;; c += gridDim.y) {
    // this thread's first column: its n8 tile j holds columns n0 + 64 j
    // and n0 + 64 j + 1
    const int n0 = c * 2 * CW + rank * CW + 8 * warp + 2 * t;
    if (E.residual) {
      // the chunk's residual tile into L2 while the products run, a line
      // of 32 floats a thread at a time, so that the epilogue finds it
      // there
      const int ncta = c * 2 * CW + rank * CW;
      for (int l = tid; l < kGRows * NB; l += kThreads) {
        const int row = row0 + l / NB, col = ncta + l % NB * kGBox;
        if (row < E.M && col < E.N)
          prefetch_l2(E.residual + (long long)row * E.N + col);
      }
    }
    // the keep bits, drawn during the chunk's first 16 stages (the Philox
    // work then overlaps the tensor cores'): draw(q) draws those of
    // (row 8 (q / 2) + g, column n0 + 64 j + q % 2) for every j into bit
    // q of the j-th half-word of kb
    uint32_t kb[(NJ + 1) / 2] = {};
    auto draw = [&](int q) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kb[j >> 1] |= (uint32_t)gemm_keep(E, row0 + 8 * (q >> 1) + g,
                                          n0 + 64 * j + (q & 1))
                      << (16 * (j & 1) + q);
    };
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    for (int kt = 0; kt < T; ++kt, ++s) {
      float* st = ring + s % kGStages * STAGE;
      if constexpr (kF32<Elt>) {
        mbar_wait(full + s % kGStages, (s / kGStages) & 1);  // stage s is in
        // the x box, which all 8 warps read, split once: this thread's 8
        // floats, big in place, small XT floats on
        float4* xb = reinterpret_cast<float4*>(st) + 2 * tid;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float4 v = xb[q], sm;
          uint32_t b, m;
          split_tf32(v.x, b, m); v.x = __uint_as_float(b); sm.x = __uint_as_float(m);
          split_tf32(v.y, b, m); v.y = __uint_as_float(b); sm.y = __uint_as_float(m);
          split_tf32(v.z, b, m); v.z = __uint_as_float(b); sm.z = __uint_as_float(m);
          split_tf32(v.w, b, m); v.w = __uint_as_float(b); sm.w = __uint_as_float(m);
          xb[q] = v;
          xb[q + XT / 4] = sm;
        }
      }
      // stage s - 1's slot is consumed and stage s's x planes are written
      __syncthreads();
      if constexpr (kF32<Elt>) {
        if (warp == 0 && s + kGStages - 1 < steps) {
          // the threads' accesses to the slot before the TMA unit's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(s + kGStages - 1, (s + kGStages - 1) % kGStages);
        }
      } else if (s + kGStages - 1 < steps) {
        load(s + kGStages - 1, (s + kGStages - 1) % kGStages);
      }
      if (DROP && kt < 16) draw(kt);
#pragma unroll
      for (int kk = 0; kk < kGK / 8; ++kk) {
        // the k8 step's w fragments first, then one m16 row tile at a time:
        // fewer live registers than all four x fragments at once
        const float* xa = st + ((ag ^ (2 * kk)) << 2);
        const float* wb = st + kk * 8 * kGBox;
        Frag<2> b[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          split_tf32(wb[wo0 + 2 * j * kGK * kGBox], b[j].big[0],
                     b[j].small[0]);
          split_tf32(wb[wo1 + 2 * j * kGK * kGBox], b[j].big[1],
                     b[j].small[1]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const float* r0 = xa + xo0 + 512 * mi;
          const float* r1 = xa + xo1 + 512 * mi;
          Frag<4> a;
          a.big[0] = __float_as_uint(r0[0]);
          a.big[1] = __float_as_uint(r0[256]);
          a.big[2] = __float_as_uint(r1[0]);
          a.big[3] = __float_as_uint(r1[256]);
          a.small[0] = __float_as_uint(r0[XT]);
          a.small[1] = __float_as_uint(r0[XT + 256]);
          a.small[2] = __float_as_uint(r1[XT]);
          a.small[3] = __float_as_uint(r1[XT + 256]);
          // the tensor cores round each accumulation toward zero, a bias
          // that would grow with the 3 K / 8 MMAs of one running sum: they
          // sum one k8 step from zero, and that is added in IEEE float32
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float step[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (kF32<Elt>) mma_3xtf32(step, a, b[j]);
            else mma_tf32(step, a.big, b[j].big);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] += step[e];
          }
        }
      }
    }

    if (DROP)
      for (int q = T; q < 16; ++q) draw(q);  // K shorter than 16 stages

    // the epilogue up to the norm; values past M or N become 0.  A row's
    // residual pairs are loaded together, ahead of its stores
    float2 bias[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bias[j] = E.bias && n0 + 64 * j < E.N
                    ? __ldg(reinterpret_cast<const float2*>(E.bias + n0 +
                                                            64 * j))
                    : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + 8 * i + g;
      float2 res[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if constexpr (kF32<Elt>)
          res[j] = E.residual && row < E.M && n0 + 64 * j < E.N
                       ? __ldg(reinterpret_cast<const float2*>(
                             E.residual + (long long)row * E.N + n0 + 64 * j))
                       : make_float2(0.f, 0.f);
        else
          res[j] = E.residual && row < E.M && n0 + 64 * j < E.N
                       ? widen2(elem<Elt>(E.residual) + (long long)row * E.N +
                                n0 + 64 * j)
                       : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float& v0 = acc[i >> 1][j][2 * (i & 1)];
        float& v1 = acc[i >> 1][j][2 * (i & 1) + 1];
        if (row < E.M && n0 + 64 * j < E.N) {
          const uint32_t bits = kb[j >> 1] >> (16 * (j & 1) + 2 * i);
          epilogue2<DROP>(E, row, n0 + 64 * j, v0, v1, bias[j], res[j],
                          bits & 1, (bits >> 1) & 1);
        } else {
          v0 = 0.f;
          v1 = 0.f;
        }
      }
    }
    if (reg_norm) break;  // one chunk: the norm below, in registers
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + 8 * i + g;
      if (row >= E.M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if constexpr (kF32<Elt>) {
          if (n0 + 64 * j < E.N)
            *reinterpret_cast<float2*>(E.y + (long long)row * E.N + n0 +
                                       64 * j) =
                make_float2(acc[i >> 1][j][2 * (i & 1)],
                            acc[i >> 1][j][2 * (i & 1) + 1]);
        } else if (n0 + 64 * j < E.N) {
          const long long o = (long long)row * E.N + n0 + 64 * j;
          const float a0 = acc[i >> 1][j][2 * (i & 1)];
          const float a1 = acc[i >> 1][j][2 * (i & 1) + 1];
          if (E.norm)  // pre-norm rows wait in float32
            *reinterpret_cast<float2*>(E.ybuf + o) = make_float2(a0, a1);
          else
            store2(elem<Elt>(E.y) + o, a0, a1);
        }
    }
    if (c + (int)gridDim.y >= chunks) break;
  }
  cluster_wait();  // the peer runs

  if (reg_norm) {
    // the row norm over both CTAs' columns (the mean, then the centred
    // variance, as norm_rows); row i of the thread is 8 i + g
    const float inv_n = 1.f / (float)E.N;
    const int n0 = rank * CW + 8 * warp + 2 * t;
    float sum[8];
    if (E.norm == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sum[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          sum[i] += acc[i >> 1][j][2 * (i & 1)] +
                    acc[i >> 1][j][2 * (i & 1) + 1];
      }
      gemm_pair_sums(sum, sRed, peer_red, rank, warp, g, t);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float mu = sum[i] * inv_n;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i >> 1][j][2 * (i & 1)] -= mu;
          acc[i >> 1][j][2 * (i & 1) + 1] -= mu;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (n0 + 64 * j >= E.N) continue;
        const float a = acc[i >> 1][j][2 * (i & 1)];
        const float b = acc[i >> 1][j][2 * (i & 1) + 1];
        sum[i] += a * a + b * b;
      }
    }
    gemm_pair_sums(sum, sRed + 16 * kGRows, peer_red + 16 * kGRows, rank,
                   warp, g, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + 8 * i + g;
      if (row >= E.M) continue;
      const float inv = rsqrtf(sum[i] * inv_n + E.eps);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + 64 * j;
        if (col >= E.N) continue;
        float o0 = acc[i >> 1][j][2 * (i & 1)] * inv;
        float o1 = acc[i >> 1][j][2 * (i & 1) + 1] * inv;
        if (E.gamma) {
          const float2 gm =
              __ldg(reinterpret_cast<const float2*>(E.gamma + col));
          o0 *= gm.x;
          o1 *= gm.y;
        }
        if (E.beta) {
          const float2 bt =
              __ldg(reinterpret_cast<const float2*>(E.beta + col));
          o0 += bt.x;
          o1 += bt.y;
        }
        if constexpr (kF32<Elt>)
          *reinterpret_cast<float2*>(E.y + (long long)row * E.N + col) =
              make_float2(o0, o1);
        else
          store2(elem<Elt>(E.y) + (long long)row * E.N + col, o0, o1);
      }
    }
  } else if (E.norm) {
    // wider rows: both CTAs' pre-norm columns are in y; each normalises 32
    // of the pair's rows
    __threadfence();
    cluster_arrive();
    cluster_wait();
    norm_rows(E, row0 + (int)rank * kBM);
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
// boxes of [brows, bcols] (written to shared memory with `swizzle`); the
// driver's encoder is found through the runtime, so the library links no
// libcuda
cudaError_t tensor_map(
    CUtensorMap* map, const float* p, int rows, int cols, int brows,
    int bcols, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
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
                            swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the kernels' epilogue for element type Elt: an Elt kernel reads x and
// the weights itself (no tensor maps) and parks wide pre-norm rows in ybuf
template <typename Elt>
EpiT<Elt> epi_t(const Epilogue& base, const Elt* x, const Elt* w,
                const Elt* w2, float* ybuf) {
  EpiT<Elt> E{};
  static_cast<Epilogue&>(E) = base;
  if constexpr (!kF32<Elt>) {
    E.x = x; E.w = w; E.w2 = w2; E.ybuf = ybuf;
  }
  return E;
}

template <int NV, typename Elt>
cudaError_t launch_ffn(const Elt* x, const Elt* w1, const float* b1,
                       const Elt* w2, const Epilogue& base, int K, int F,
                       int act, int approximate, cudaStream_t stream) {
  const EpiT<Elt> E = epi_t<Elt>(base, x, w1, w2, nullptr);
  CUtensorMap tx{}, tw1{}, tw2{};
  cudaError_t err = cudaSuccess;
  if constexpr (kF32<Elt>) {
    err = tensor_map(&tx, x, E.M, K, kRows, kBK1);
    if (err == cudaSuccess) err = tensor_map(&tw1, w1, K, F, kBK1, 128);
    if (err == cudaSuccess) err = tensor_map(&tw2, w2, F, E.N, kBK2, 128);
    if (err != cudaSuccess) return err;
  }
  const size_t bytes = ffn_smem_bytes(NV);
  err = cudaFuncSetAttribute(ffn_chain_kernel<NV, Elt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * (unsigned)(((long long)E.M + kRows - 1) / kRows));
  ffn_chain_kernel<NV, Elt><<<grid, kThreads, bytes, stream>>>(
      tx, tw1, tw2, b1, E, K, F, act, approximate);
  return cudaGetLastError();
}

// w boxes a CTA's columns span (32 NB of a cluster chunk of 64 NB): with a
// norm and N <= 768, the fewest that hold a row in one chunk (the norm then
// runs in registers); else the NB in {12, 8, 4} that pads N least (the
// larger on a tie)
int pick_nb(int N, bool norm) {
  if (norm && N <= 64 * 12) return N <= 64 * 4 ? 4 : N <= 64 * 8 ? 8 : 12;
  int best = 12;
  long long best_w = 1LL << 40;
  for (int nb = 12; nb >= 4; nb -= 4) {
    const long long w = (long long)((N + 64 * nb - 1) / (64 * nb)) * 64 * nb;
    if (w < best_w) { best_w = w; best = nb; }
  }
  return best;
}

size_t gemm_smem_bytes(int NB) {
  // the ring, 2 passes of row sums, the mbarriers, and the slack that puts
  // the ring on a 1024-byte boundary
  return (size_t)(kGStages * gemm_stage_floats(NB) + 32 * kGRows) * 4 +
         kGStages * sizeof(uint64_t) + 1024;
}

template <int NB, bool DROP, typename Elt>
cudaError_t launch_gemm_tc(const Elt* x, const Elt* w, const Epilogue& base,
                           float* ybuf, int K, cudaStream_t stream) {
  const EpiT<Elt> E = epi_t<Elt>(base, x, w, nullptr, ybuf);
  CUtensorMap tx{}, tw{};
  cudaError_t err = cudaSuccess;
  if constexpr (kF32<Elt>) {
    err = tensor_map(&tx, x, E.M, K, kGRows, kGK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = tensor_map(&tw, w, K, E.N, kGK, kGBox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const size_t bytes = gemm_smem_bytes(NB);
  err = cudaFuncSetAttribute(gemm_tc_kernel<NB, DROP, Elt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const int chunks = (E.N + 64 * NB - 1) / (64 * NB);
  const dim3 grid(2 * (unsigned)(((long long)E.M + kGRows - 1) / kGRows),
                  E.norm ? 1 : chunks);
  gemm_tc_kernel<NB, DROP, Elt><<<grid, kThreads, bytes, stream>>>(tx, tw, E,
                                                                  K);
  return cudaGetLastError();
}

template <int NB, typename Elt>
cudaError_t launch_gemm(const Elt* x, const Elt* w, const Epilogue& E,
                        float* ybuf, int K, cudaStream_t stream) {
  return E.dropout
             ? launch_gemm_tc<NB, true>(x, w, E, ybuf, K, stream)
             : launch_gemm_tc<NB, false>(x, w, E, ybuf, K, stream);
}

// the entries over the element type Elt (float32: ybuf unused)
template <typename Elt>
int gemm_entry(const Elt* x, const Elt* w, const float* bias,
               const Elt* residual, const float* gamma, const float* beta,
               Elt* y, Elt* z0, unsigned char* mask, float* ybuf, int M,
               int K, int N, int act, int approximate, float rate, int norm,
               float eps, unsigned int seed0, unsigned int seed1,
               void* stream) {
  if (M == 0 || N == 0) return 0;
  // K % 8 and N % 4: the wrapper's rule (fused_shapes_ok); the kernel
  // zero-fills the tails of K, M and N itself
  if (K <= 0 || K % 8 || N % 4 || N > 8192 || M < 0 ||
      (M + kGRows - 1) / kGRows > 1073741823)
    return (int)cudaErrorInvalidValue;
  // an Elt kernel parks pre-norm rows wider than one chunk in ybuf
  if (!kF32<Elt> && norm && N > 64 * 12 && ybuf == nullptr)
    return (int)cudaErrorInvalidValue;
  const Epilogue E = make_epilogue(
      bias, (const float*)residual, gamma, beta, (float*)y, (float*)z0, mask,
      M, N, act, approximate, rate, norm, eps, seed0, seed1);
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_nb(N, norm != 0)) {
    case 12: return (int)launch_gemm<12>(x, w, E, ybuf, K, s);
    case 8: return (int)launch_gemm<8>(x, w, E, ybuf, K, s);
    default: return (int)launch_gemm<4>(x, w, E, ybuf, K, s);
  }
}

template <typename Elt>
int ffn_entry(const Elt* x, const Elt* w1, const float* b1, const Elt* w2,
              const float* b2, const Elt* residual, const float* gamma,
              const float* beta, Elt* y, unsigned char* mask, int M, int K,
              int F, int N, int act, int approximate, float rate, int norm,
              float eps, unsigned int seed0, unsigned int seed1,
              void* stream) {
  if (M == 0) return 0;
  const int nv = (N + 255) / 256;
  if (M < 0 || K <= 0 || K % 16 || F <= 0 || F % 128 || N <= 0 || N % 4 ||
      nv > 3)
    return (int)cudaErrorInvalidValue;
  // the output epilogue has no activation: act runs between the GEMMs
  const Epilogue E = make_epilogue(b2, (const float*)residual, gamma, beta,
                                   (float*)y, nullptr, mask, M, N, 0, 0,
                                   rate, norm, eps, seed0, seed1);
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
}  // namespace
