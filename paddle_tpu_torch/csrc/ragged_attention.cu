// Unified ragged paged attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel paddle_tpu/generation/ragged_attention.py
// `_ragged_attention_kernel` (launched by `ragged_flash_attention`).
//
// What it computes: R token rows, each with ONE query vector q[r] of
// `hidden` = num_heads * head_dim floats.  Row r attends, per head, over
// keys 0..len-1 of the page list tables[r / block_rows] (len =
// row_lens[r], clipped to pages_per_seq * page_size), where key j lives at
// page tables[..][j / page_size], slot j % page_size of the pool
// k_pages/v_pages [num_pages, page_size, hidden].  len == 0 is an inactive
// row and writes exact zeros.  Softmax statistics and the accumulator are
// float32, as in the TPU kernel.
//
// What bounds it on this card: bytes.  Each (row, head) reads len * 2 *
// head_dim floats of K/V and does ~4 flops per float read, far below the
// H100's ~20 flop/byte float32 ridge, so the least time is the K/V bytes
// the rows need over the 3.35 TB/s of HBM (rows of one sequence share
// pages, which L2 serves after the first read).
//
// Design: the TPU grid walked (row block, page) in order and carried the
// online-softmax state in VMEM scratch from one page step to the next,
// masking pages past a row's length.  Hopper runs blocks in parallel and
// in no order, so here one CTA owns one (head, row) and loops over only
// the keys that row needs — no masked pages are read.  Its 4 warps take
// interleaved keys; each lane holds head_dim/32 dimensions of q, of the
// running accumulator, and of each K/V vector it reads, so a warp reads a
// key's head slice as one coalesced 256-byte segment (head_dim 64).  Each
// warp keeps its own running max / denominator / accumulator in
// registers; the four partial states merge through shared memory at the
// end.  K and V of a key are loaded together before the dot-product
// reduction so their latencies overlap.  No tensor cores: one query per
// row gives nothing to tile.  Multi-row tiles, wgmma and TMA are later
// work.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxHeadDim = 128;
constexpr int kPerLane = kMaxHeadDim / 32;

__global__ void __launch_bounds__(kWarps * 32)
ragged_attention_kernel(const float* __restrict__ q, long long q_row_stride,
                        const float* __restrict__ k_pages,
                        const float* __restrict__ v_pages,
                        const int* __restrict__ tables,
                        const int* __restrict__ row_lens,
                        float* __restrict__ out, int hidden, int head_dim,
                        int page_size, int num_pages, int pages_per_seq,
                        int block_rows, float sm_scale) {
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxHeadDim];

  float* o = out + (size_t)row * hidden + (size_t)head * head_dim;
  const int cap = pages_per_seq * page_size;
  int len = row_lens[row];
  len = len < cap ? len : cap;
  if (len <= 0) {  // inactive row: exact zeros, never NaN
    for (int d = threadIdx.x; d < head_dim; d += blockDim.x) o[d] = 0.f;
    return;
  }

  const float* qr = q + row * q_row_stride + (size_t)head * head_dim;
  float qv[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < head_dim ? qr[d] : 0.f;
  }
  const int* table = tables + (size_t)(row / block_rows) * pages_per_seq;

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  for (int j = warp; j < len; j += kWarps) {
    const int page = __ldg(table + j / page_size);
    if ((unsigned)page >= (unsigned)num_pages) __trap();  // corrupt table
    const size_t base = ((size_t)page * page_size + j % page_size) * hidden +
                        (size_t)head * head_dim;
    float kv[kPerLane], vv[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < head_dim ? __ldg(k_pages + base + d) : 0.f;
      vv[i] = d < head_dim ? __ldg(v_pages + base + d) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s += qv[i] * kv[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    s *= sm_scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);  // 0 on this warp's first key
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = acc[i] * alpha + p * vv[i];
    m = m_new;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < head_dim) s_acc[warp][d] = acc[i];
  }
  __syncthreads();

  // merge the warps' partial softmax states; a warp that saw no key has
  // l == 0 and contributes nothing
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
  float scale[kWarps];
  float denom = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    scale[w] = s_l[w] > 0.f ? expf(s_m[w] - mx) : 0.f;
    denom += s_l[w] * scale[w];
  }
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][d] * scale[w];
    o[d] = denom > 0.f ? a / denom : 0.f;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int ragged_paged_attention_f32(const float* q, long long q_row_stride,
                               const float* k_pages, const float* v_pages,
                               const int* tables, const int* row_lens,
                               float* out, int rows, int hidden,
                               int num_heads, int page_size, int num_pages,
                               int pages_per_seq, int block_rows,
                               float sm_scale, void* stream) {
  if (rows == 0) return 0;
  const dim3 grid(num_heads, rows);
  ragged_attention_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      q, q_row_stride, k_pages, v_pages, tables, row_lens, out, hidden,
      hidden / num_heads, page_size, num_pages, pages_per_seq, block_rows,
      sm_scale);
  return (int)cudaGetLastError();
}

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
