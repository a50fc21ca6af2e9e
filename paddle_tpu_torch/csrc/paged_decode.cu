// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel paddle_tpu/generation/attention.py
// `_paged_decode_kernel` (launched by `paged_flash_decode_attention`), the
// attention of the legacy scheduler's decode step.
//
// What it computes: S sequence slots, each with ONE query vector q[s] of
// `hidden` = num_heads * head_dim floats.  Slot s attends, per head, over
// keys 0..len-1 of its page list page_table[s] (len = eff_lens[s], clipped
// to pages_per_seq * page_size), where key j lives at page
// page_table[s][j / page_size], slot j % page_size of the pool
// k_pages/v_pages [num_pages, page_size, hidden].  len == 0 is an empty
// slot and writes exact zeros.  Scores, softmax and the weighted sum are
// float32, as in the TPU kernel.
//
// What bounds it on this card: bytes.  Each (slot, head) reads len * 2 *
// head_dim floats of K/V once and does 4 flops per float read, far below
// the H100's ~20 flop/byte float32 ridge, so the least time is the K/V of
// the live keys over the 3.35 TB/s of HBM.
//
// Design: the TPU grid walked (sequence, page) in order over EVERY page of
// the table row, carrying the online-softmax state in VMEM and masking
// pages past the length.  Here one CTA owns one (slot, head) and reads
// only the cdiv(len, page_size) live pages.  One query per slot gives
// nothing for tensor cores to tile, and 8 slots x 12 heads is only 96
// CTAs, so the kernel is bound by the latency of its dependent loads,
// and the design keeps many independent loads in flight:
//   0. the slot's live page ids and its q slice go to shared memory (one
//      dependent global load per key is gone from the key loops);
//   1. scores: the CTA's 256 threads form groups of head_dim/4 lanes, one
//      key per group; each lane reads a float4 of the key's head slice (a
//      group reads the slice as one coalesced segment).  Each group loads
//      kUnroll keys before it reduces any (kUnroll independent loads in
//      flight per lane), then sums each dot product by shuffles.  Scores
//      go to shared memory (len floats);
//   2. softmax: a block-wide max, exp(s - max) in place, a block-wide sum
//      (all scores are known, so no running rescale);
//   3. weighted sum: the same lane groups walk the keys again, kUnroll V
//      rows in flight, each lane accumulating p * V over its float4 of
//      dimensions; the groups' partial sums merge through shared memory
//      and divide by the sum.
// Splitting one (slot, head)'s keys across CTAs (split-K) to fill all 132
// SMs is later work.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// groups of head_dim / 4 lanes x float4 cover one head slice; the partial
// weighted sums of all groups fill kThreads float4 = 4 * kThreads floats
constexpr int kPartials = 4 * kThreads;

__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    v = is_max ? fmaxf(v, scratch[w]) : v + scratch[w];
  return v;
}

__device__ __forceinline__ const float4* key_row(const float* pages,
                                                 const int* s_tab, int j,
                                                 int page_size, int hidden,
                                                 int head_off) {
  const size_t row = (size_t)s_tab[j / page_size] * page_size + j % page_size;
  return reinterpret_cast<const float4*>(pages + row * hidden + head_off);
}

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, long long q_row_stride,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ eff_lens,
                    float* __restrict__ out, int hidden, int head_dim,
                    int page_size, int num_pages, int pages_per_seq,
                    float sm_scale) {
  // [pages_per_seq * page_size] scores, then [pages_per_seq] page ids
  extern __shared__ float s_p[];
  int* s_tab = reinterpret_cast<int*>(s_p + pages_per_seq * page_size);
  __shared__ __align__(16) float s_q[128];
  __shared__ __align__(16) float s_part[kPartials];
  __shared__ float s_red[kWarps];

  const int head = blockIdx.x;
  const int seq = blockIdx.y;
  const int head_off = head * head_dim;
  float* o = out + (size_t)seq * hidden + head_off;
  const int cap = pages_per_seq * page_size;
  int len = eff_lens[seq];
  len = len < cap ? len : cap;
  if (len <= 0) {  // empty slot: exact zeros, never NaN
    for (int d = threadIdx.x; d < head_dim; d += kThreads) o[d] = 0.f;
    return;
  }

  // 0. the live page ids and the q slice
  const int live_pages = (len + page_size - 1) / page_size;
  for (int i = threadIdx.x; i < live_pages; i += kThreads) {
    const int page = page_table[(size_t)seq * pages_per_seq + i];
    if ((unsigned)page >= (unsigned)num_pages) __trap();  // corrupt table
    s_tab[i] = page;
  }
  const float* qr = q + seq * q_row_stride + head_off;
  for (int d = threadIdx.x; d < head_dim; d += kThreads) s_q[d] = qr[d];
  __syncthreads();

  const int width = head_dim / 4;           // lanes per key
  const int sub = threadIdx.x % width;      // this lane's float4 of the slice
  const int group = threadIdx.x / width;
  const int groups = kThreads / width;
  const float4 qv = reinterpret_cast<const float4*>(s_q)[sub];

  // 1. scores of the live keys.  Every thread runs the same number of
  // iterations (a group past the end idles), so the shuffles of a warp
  // always find all 32 lanes.
  for (int j0 = 0; j0 < len; j0 += groups * kUnroll) {
    float4 kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * groups + group;
      kv[u] = j < len ? __ldg(key_row(k_pages, s_tab, j, page_size, hidden,
                                      head_off) + sub)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * groups + group;
      float s = qv.x * kv[u].x + qv.y * kv[u].y + qv.z * kv[u].z +
                qv.w * kv[u].w;
      s = group_sum(s, width);
      if (j < len && sub == 0) s_p[j] = s * sm_scale;
    }
  }
  __syncthreads();

  // 2. softmax numerators and their sum
  float m = -CUDART_INF_F;
  for (int j = threadIdx.x; j < len; j += kThreads) m = fmaxf(m, s_p[j]);
  m = block_reduce(m, true, s_red);
  float l = 0.f;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const float p = expf(s_p[j] - m);
    s_p[j] = p;
    l += p;
  }
  l = block_reduce(l, false, s_red);  // its barriers publish s_p

  // 3. weighted sum of V over the live keys
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = group; j0 < len; j0 += groups * kUnroll) {
    float4 vv[kUnroll];
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * groups;
      const bool live = j < len;
      vv[u] = live ? __ldg(key_row(v_pages, s_tab, j, page_size, hidden,
                                   head_off) + sub)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      p[u] = live ? s_p[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc.x += p[u] * vv[u].x;
      acc.y += p[u] * vv[u].y;
      acc.z += p[u] * vv[u].z;
      acc.w += p[u] * vv[u].w;
    }
  }
  reinterpret_cast<float4*>(s_part)[group * width + sub] = acc;
  __syncthreads();
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += s_part[g * head_dim + d];
    o[d] = a / l;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// wrapper guarantees head_dim in {4, 8, 16, 32, 64, 128}, 16-byte aligned
// K/V rows, and a table whose scores and page ids fit 43 KB of dynamic
// shared memory (with the kernel's 4.5 KB of static buffers, within the
// 48 KB a launch gets without opting in).
int paged_decode_attention_f32(const float* q, long long q_row_stride,
                               const float* k_pages, const float* v_pages,
                               const int* page_table, const int* eff_lens,
                               float* out, int seqs, int hidden,
                               int num_heads, int page_size, int num_pages,
                               int pages_per_seq, float sm_scale,
                               void* stream) {
  if (seqs == 0) return 0;
  const dim3 grid(num_heads, seqs);
  const size_t smem =
      (size_t)pages_per_seq * (page_size * sizeof(float) + sizeof(int));
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, q_row_stride, k_pages, v_pages, page_table, eff_lens, out, hidden,
      hidden / num_heads, page_size, num_pages, pages_per_seq, sm_scale);
  return (int)cudaGetLastError();
}

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
