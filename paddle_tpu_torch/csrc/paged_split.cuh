// Split-key paged attention for Hopper (sm_90a): the one design behind
// csrc/ragged_attention.cu (kernel #1) and csrc/paged_decode.cu (kernel
// #2, the same function with block_rows = 1), a template over the pages'
// element type T: float, __nv_bfloat16 or __half (a 16-bit KV cache).
//
// What it computes: R rows, each with ONE query vector q[r] of `hidden` =
// num_heads * head_dim floats (q and the output are float32 whatever T
// is).  Row r attends, per head, over keys
// 0..len-1 of the page list tables[r / block_rows] (len = lens[r], clipped
// to pages_per_seq * page_size), where key j lives at page
// tables[..][j / page_size], slot j % page_size of the pool
// k_pages/v_pages [num_pages, page_size, hidden].  len <= 0 writes exact
// zeros.  A page id outside the pool traps.  Scores, softmax statistics
// and the accumulator are float32.  With 16-bit pages the rounding points
// are the TPU kernel's: K and V are widened to float32 in registers, the
// scores and the softmax denominator l use the unrounded p, and only the
// P.V product takes p rounded to T (float32 sums); the output is not
// rounded to T.
//
// What bounds it: bytes.  Each key costs 2 * head_dim elements of K/V for
// 2 flops per element, a matrix-vector product at 0.5 flop per byte in
// float32 (1 in 16 bits) against the H100's ~20 flop/byte float32 ridge,
// so the least time is the live K/V over the 3.35 TB/s of HBM: a 16-bit
// cache halves it.  One query per row gives the tensor cores
// nothing to tile: they would buy nothing here, so the products are FMA.
//
// Design:
//   * The keys of each (row, head) are cut into spans of `span_pages`
//     whole pages (at most 8 spans).  The wrapper derives the span from
//     pages_per_seq and page_size alone, so the grid (spans, rows, heads)
//     depends only on the engine's fixed shapes, and the host never reads
//     the lengths.  A span past its row's length does no work: its CTA
//     leaves at once.
//   * The spans of one (row, head) are one thread-block cluster, its size
//     set at launch (cudaLaunchKernelEx).  Each live CTA leaves its span's
//     (m, l, acc) in its shared memory; after a cluster barrier (which
//     waits for the threads that have not exited) rank 0 reads its live
//     peers' states through distributed shared memory, in rank order, and
//     writes the row: one launch, no workspace, no atomics, the same bits
//     on every run.  A row whose keys fit in one span skips the barriers.
//   * Inside a span, lane groups of head_dim / E lanes each take one key,
//     16 bytes of its head slice per lane (E = 4 floats or 8 16-bit
//     values; a group reads a key's slice as one coalesced segment).  A
//     stage is kUnroll keys a group; each lane copies its own 16 bytes of
//     those keys' K and V rows into a kStages-deep
//     cp.async ring in shared memory and later reads back only what it
//     copied, so the ring needs no block barrier, and kStages - 1 stages
//     of 16-byte copies stay in flight while a stage is consumed.  The page
//     ids of a stage are loaded one stage before its copies are issued.
//     A stage's scores are summed by shuffles within the group; the online
//     softmax rescales once per stage, not once per key.  The groups'
//     (m, l, acc) merge through shared memory at the end of the span.
//   * The ragged kernel's grid runs rows inner (cta_coords): a step's
//     HBM-bound decode rows and its L2-bound prefill rows overlap.
//
// Tried and dropped (paddle_tpu_torch/tools/paged_split_variants.py and
// PERF.md, section 6): K and V held in registers, 4-16 keys a group in
// flight (the time followed the CTAs an SM could hold, which the
// registers cut, and every such build lost to the ring at the long
// cases); a key's page by integer division where the page size is a
// power of two; CTAs of spans past the length waiting at the cluster
// barriers; for the ragged kernel the grid with heads inner (the long
// case's decode rows ran before its prefill rows), for the decode kernel
// rows inner; spans of 64 keys (a cluster and its merge for a few stages
// of work); for the ragged kernel rings of 2 x 4 and 4 x 2 keys, for the
// decode kernel 3 x 2 and 4 x 2; expf (slower than __expf, no change in
// the error).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace paged_split {

// Build switches, for paddle_tpu_torch/tools/paged_split_variants.py
// (the defaults are the ragged kernel's; the paged decode kernel sets its
// own ring and grid order before including this header): keys a group a
// stage, the ring's depth, expf for __expf, and the grid with heads inner.
#ifndef PAGED_SPLIT_UNROLL
#define PAGED_SPLIT_UNROLL 2
#endif
#ifndef PAGED_SPLIT_STAGES
#define PAGED_SPLIT_STAGES 3
#endif
#ifndef PAGED_SPLIT_PRECISE_EXP
#define PAGED_SPLIT_PRECISE_EXP 0
#endif
#ifndef PAGED_SPLIT_HEADS_INNER
#define PAGED_SPLIT_HEADS_INNER 0
#endif
constexpr int kThreads = 128;
constexpr int kMaxSplit = 8;      // spans of a (row, head): a portable cluster
constexpr int kUnroll = PAGED_SPLIT_UNROLL;  // keys a group a stage
constexpr int kStages = PAGED_SPLIT_STAGES;  // depth of the cp.async ring

// exp of a softmax argument (<= 0; exp(-inf) = 0).  __expf: ex2.approx
// of x * log2(e), a few ulp, well inside the kernels' 1e-5 tolerance
__device__ __forceinline__ float exp_(float x) {
#if PAGED_SPLIT_PRECISE_EXP
  return expf(x);
#else
  return __expf(x);
#endif
}

// the cluster barrier: arrive releases this thread's shared-memory writes,
// wait acquires every peer's
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes global -> shared, L2 only; src_bytes 0 writes zeros and reads
// nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, W);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// One lane's share of a key: the 16 bytes it copies (E elements of T), its
// slice of q and of the accumulator, in float32.  Lane<float> keeps the
// float32 kernel's float4 arithmetic and accesses statement for statement,
// so its ptxas allocation stays comparable across changes.
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int E = 4;
  float4 q, acc;
  __device__ __forceinline__ void load_q(const float* qr) {
    q = make_float4(__ldg(qr), __ldg(qr + 1), __ldg(qr + 2), __ldg(qr + 3));
  }
  __device__ __forceinline__ void zero() {
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float dot(const float4& k) const {
    return dot4(q, k);
  }
  __device__ __forceinline__ void scale(float alpha) {
    acc.x *= alpha;
    acc.y *= alpha;
    acc.z *= alpha;
    acc.w *= alpha;
  }
  __device__ __forceinline__ void add(float p, const float4& v) {
    acc.x += p * v.x;
    acc.y += p * v.y;
    acc.z += p * v.z;
    acc.w += p * v.w;
  }
  // into slot i of the groups' accumulators, read as float4s
  __device__ __forceinline__ void store(float4* slots, int i) const {
    slots[i] = acc;
  }
};

// 16-bit pages: 8 values a lane, widened to float32 in registers
__device__ __forceinline__ float2 widen2(__nv_bfloat162 h) {
  return __bfloat1622float2(h);
}
__device__ __forceinline__ float2 widen2(__half2 h) {
  return __half22float2(h);
}
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const __half*) {
  return __half2float(__float2half_rn(x));
}

template <typename T, typename T2>
struct Lane16 {
  static constexpr int E = 8;
  float q[E], acc[E];
  __device__ __forceinline__ void load_q(const float* qr) {
#pragma unroll
    for (int e = 0; e < E; ++e) q[e] = __ldg(qr + e);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
  }
  static __device__ __forceinline__ void widen(const float4& raw,
                                               float (&f)[E]) {
    const T2* h = reinterpret_cast<const T2*>(&raw);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 w = widen2(h[i]);
      f[2 * i] = w.x;
      f[2 * i + 1] = w.y;
    }
  }
  __device__ __forceinline__ float dot(const float4& raw) const {
    float k[E];
    widen(raw, k);
    float s = q[0] * k[0];
#pragma unroll
    for (int e = 1; e < E; ++e) s += q[e] * k[e];
    return s;
  }
  __device__ __forceinline__ void scale(float alpha) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
  }
  // P.V takes p rounded to T (the TPU kernel's p.astype(v.dtype)); the
  // caller's softmax denominator sums the unrounded p
  __device__ __forceinline__ void add(float p, const float4& raw) {
    const float pt = round_to(p, static_cast<const T*>(nullptr));
    float v[E];
    widen(raw, v);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += pt * v[e];
  }
  __device__ __forceinline__ void store(float4* slots, int i) const {
    slots[2 * i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    slots[2 * i + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
};

template <>
struct Lane<__nv_bfloat16> : Lane16<__nv_bfloat16, __nv_bfloat162> {};
template <>
struct Lane<__half> : Lane16<__half, __half2> {};

// (head, row) of this CTA.  With rows inner, as blocks are dispatched in
// grid order, a ragged step's decode rows (HBM-bound) and its prefill
// chunk's rows (which re-read one sequence's pages from L2) overlap in
// time instead of running one after the other.
__device__ __forceinline__ void cta_coords(int& head, int& row) {
#if PAGED_SPLIT_HEADS_INNER
  head = blockIdx.y;
  row = blockIdx.z;
#else
  row = blockIdx.y;
  head = blockIdx.z;
#endif
}

// A CTA's shared memory: the ring (each thread's own 16-byte slots,
// [stage][K or V][key][thread], so a warp's accesses are conflict-free),
// the lane groups' states, and the span's state its cluster's rank 0
// reads.  E: elements of a 16-byte slot.
template <int W, int E>
struct Smem {
  static constexpr int D = E * W;
  static constexpr int G = kThreads / W;
  float4 ring[kStages][2][kUnroll][kThreads];
  float m[G], l[G];
  __align__(16) float acc[G * D];
  float span_m, span_l;
  float span_acc[D];
};

// One CTA: span `split` of (row, head).  T: the pages' element type; W =
// head_dim / E lanes per key; POW2: page_size is a power of two (a key's
// page and slot by shift and mask, not by division).
template <typename T, int W, bool POW2>
__device__ __forceinline__ void split_span(
    Smem<W, Lane<T>::E>& sm, const float* __restrict__ q,
    long long q_row_stride, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ out, int hidden,
    int page_size, int num_pages, int pages_per_seq, int block_rows,
    int span_pages, float sm_scale) {
  constexpr int E = Lane<T>::E;
  constexpr int D = E * W;
  constexpr int G = kThreads / W;  // lane groups
  constexpr int kStageKeys = G * kUnroll;
  const int split = blockIdx.x;
  int head, row;
  cta_coords(head, row);
  const int t = threadIdx.x;
  const int sub = t % W, group = t / W;
  const int shift = __ffs(page_size) - 1, mask = page_size - 1;
  auto page_of = [&](int j) { return POW2 ? j >> shift : j / page_size; };
  auto slot_of = [&](int j) { return POW2 ? (j & mask) : j % page_size; };
  const int span_keys = span_pages * page_size;
  const int* table = tables + (size_t)(row / block_rows) * pages_per_seq +
                     (size_t)split * span_pages;
  const size_t col = (size_t)head * D + E * sub;

  // page ids of stage c, one per key of this lane's group below `bound`
  auto load_pages = [&](int c, int(&page)[kUnroll], int bound) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c * kStageKeys + u * G + group;
      page[u] = j < bound ? __ldg(table + page_of(j)) : 0;
    }
  };
  // The first stages' page ids (every key of the span's table entries) and
  // q are loaded while the row's length is on its way: one dependent
  // round trip fewer before the first copies
  int first[kStages][kUnroll];
  const int table_keys =
      min(span_keys, (pages_per_seq - split * span_pages) * page_size);
#pragma unroll
  for (int c = 0; c < kStages; ++c) load_pages(c, first[c], table_keys);
  Lane<T> lane;
  lane.load_q(q + row * q_row_stride + col);

  const int cap = pages_per_seq * page_size;
  int len = __ldg(lens + row);
  len = len < cap ? len : cap;
  float* o = out + (size_t)row * hidden + (size_t)head * D;
  if (len <= 0) {  // inactive row / empty slot: exact zeros, never NaN
    if (split == 0 && t < D) o[t] = 0.f;
    return;
  }
  // a span past the row's length leaves at once: the cluster barriers
  // wait for the threads that have not exited, and rank 0 reads the live
  // spans only (a row within one span has no barrier at all)
  if (split * span_keys >= len) return;
  const int live_spans = (len + span_keys - 1) / span_keys;
  int n = len - split * span_keys;  // this span's keys
  n = n < span_keys ? n : span_keys;
  const int stages = (n + kStageKeys - 1) / kStageKeys;
  // this lane's 16 bytes of stage c's K and V rows into ring slot
  // c % kStages
  // (zeros past the span), then one commit group, empty or not
  auto issue = [&](int c, const int(&page)[kUnroll]) {
    const int st = c % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c * kStageKeys + u * G + group;
      const bool live = j < n;
      if (live && (unsigned)page[u] >= (unsigned)num_pages)
        __trap();  // a corrupt page table
      const size_t at =
          live ? ((size_t)page[u] * page_size + slot_of(j)) * hidden + col
               : 0;
      cp_async16(&sm.ring[st][0][u][t], k_pages + at, live ? 16 : 0);
      cp_async16(&sm.ring[st][1][u][t], v_pages + at, live ? 16 : 0);
    }
    cp_async_commit();
  };

  // the first kStages - 1 stages in flight, and the next stage's ids
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c, first[c]);
  int next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) next[u] = first[kStages - 1][u];

  float m = -CUDART_INF_F, l = 0.f;
  lane.zero();
  // every thread runs the same stages (n is the CTA's), so the shuffles of
  // a warp always find all 32 lanes
  for (int c = 0; c < stages; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage c landed
    issue(c + kStages - 1, next);  // into the slot stage c - 1 freed
    load_pages(c + kStages, next, n);
    const int st = c % kStages;
    float s[kUnroll];
    float cmax = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = group_sum<W>(lane.dot(sm.ring[st][0][u][t])) * sm_scale;
      if (c * kStageKeys + u * G + group >= n) s[u] = -CUDART_INF_F;
      cmax = fmaxf(cmax, s[u]);
    }
    if (cmax == -CUDART_INF_F) continue;  // this group has no key here
    const float m_new = fmaxf(m, cmax);
    const float alpha = exp_(m - m_new);  // 0 on the group's first stage
    float psum = 0.f;
    lane.scale(alpha);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = exp_(s[u] - m_new);  // 0 for a key past the span
      psum += p;
      lane.add(p, sm.ring[st][1][u][t]);
    }
    l = l * alpha + psum;
    m = m_new;
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // the groups' states -> the span's (a group that saw no key has l = 0)
  if (sub == 0) {
    sm.m[group] = m;
    sm.l[group] = l;
  }
  lane.store(reinterpret_cast<float4*>(sm.acc), group * W + sub);
  __syncthreads();
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int g = 0; g < G; ++g) mx = fmaxf(mx, sm.m[g]);
  float span_l = 0.f, a = 0.f;  // thread t < D owns dimension t
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float wg = sm.l[g] > 0.f ? exp_(sm.m[g] - mx) : 0.f;
    span_l += sm.l[g] * wg;
    if (t < D) a += sm.acc[g * D + t] * wg;
  }
  if (live_spans == 1) {  // rank 0, the row's only span
    if (t < D) o[t] = a / span_l;
    return;
  }
  if (t < D) sm.span_acc[t] = a;
  if (t == 0) {
    sm.span_m = mx;
    sm.span_l = span_l;
  }
  __syncwarp();

  // the spans' states -> the row, by rank 0, in rank order
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster_sync();  // every live span's state is in its CTA's shared memory
  if (split == 0) {  // the cluster's rank 0 (gridDim.x is the cluster)
    float pm[kMaxSplit], pl[kMaxSplit];
    float gm = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      pm[r] = -CUDART_INF_F;
      pl[r] = 0.f;
      if (r < live_spans) {
        pm[r] = *cluster.map_shared_rank(&sm.span_m, r);
        pl[r] = *cluster.map_shared_rank(&sm.span_l, r);
        gm = fmaxf(gm, pm[r]);
      }
    }
    float denom = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      pm[r] = pl[r] > 0.f ? exp_(pm[r] - gm) : 0.f;  // the span's weight
      denom += pl[r] * pm[r];
    }
    if (t < D) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < live_spans)
          sum += *cluster.map_shared_rank(&sm.span_acc[t], r) * pm[r];
      o[t] = sum / denom;
    }
  }
  __syncwarp();
  cluster_sync();  // no live CTA leaves while rank 0 still reads its state
}

template <typename T, int W>
__device__ __forceinline__ void split_body(
    const float* __restrict__ q, long long q_row_stride,
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ tables, const int* __restrict__ lens,
    float* __restrict__ out, int hidden, int page_size, int num_pages,
    int pages_per_seq, int block_rows, int span_pages, float sm_scale) {
  __shared__ __align__(16) Smem<W, Lane<T>::E> sm;
  if ((page_size & (page_size - 1)) == 0)
    split_span<T, W, true>(sm, q, q_row_stride, k_pages, v_pages, tables,
                           lens, out, hidden, page_size, num_pages,
                           pages_per_seq, block_rows, span_pages, sm_scale);
  else
    split_span<T, W, false>(sm, q, q_row_stride, k_pages, v_pages, tables,
                            lens, out, hidden, page_size, num_pages,
                            pages_per_seq, block_rows, span_pages, sm_scale);
}

// The launch of head_dim `d` for element type T: `go` is called with
// std::integral_constant<int, W> (W = d / E lanes a key) for each head_dim
// the kernels take (4..128 for float, 8..128 for 16 bits); any other d is
// cudaErrorInvalidValue.
template <typename T, typename Go>
int by_head_dim(int d, Go go) {
  constexpr int E = Lane<T>::E;
  switch (d) {
    case 4:
      if constexpr (E == 4) return go(std::integral_constant<int, 1>());
      break;
    case 8:
      return go(std::integral_constant<int, 8 / E>());
    case 16:
      return go(std::integral_constant<int, 16 / E>());
    case 32:
      return go(std::integral_constant<int, 32 / E>());
    case 64:
      return go(std::integral_constant<int, 64 / E>());
    case 128:
      return go(std::integral_constant<int, 128 / E>());
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// Launch `kernel` over (spans, heads, rows) with the spans of a (row, head)
// as one cluster; returns the launch's error (0 = launched).
template <typename Kernel, typename... Args>
int launch_split(Kernel kernel, int rows, int num_heads, int pages_per_seq,
                 int span_pages, cudaStream_t stream, Args... args) {
  if (rows == 0) return 0;
  if (span_pages < 1) return (int)cudaErrorInvalidValue;
  const int nsplit = (pages_per_seq + span_pages - 1) / span_pages;
  if (nsplit < 1 || nsplit > kMaxSplit) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
#if PAGED_SPLIT_HEADS_INNER
  cfg.gridDim = dim3(nsplit, num_heads, rows);
#else
  cfg.gridDim = dim3(nsplit, rows, num_heads);
#endif
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;  // one span: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace paged_split
