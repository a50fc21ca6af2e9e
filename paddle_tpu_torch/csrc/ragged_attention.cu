// Unified ragged paged attention for Hopper (sm_90a): float32 pages, and
// bfloat16 and float16 pages (a 16-bit KV cache; q and the output stay
// float32).
//
// Replaces the Pallas TPU kernel paddle_tpu/generation/ragged_attention.py
// `_ragged_attention_kernel` (launched by `ragged_flash_attention`).
//
// What it computes: R token rows, each with ONE query vector q[r] of
// `hidden` = num_heads * head_dim floats.  Row r attends, per head, over
// keys 0..len-1 of the page list tables[r / block_rows] (len =
// row_lens[r], clipped to pages_per_seq * page_size) — the one rule that is
// causal masking inside a prefill chunk and ragged decode masking.
// len == 0 is an inactive row and writes exact zeros.  Softmax statistics
// and the accumulator are float32, as in the TPU kernel; 16-bit pages are
// widened in registers and p is rounded to the pages' type for P.V only,
// as the TPU kernel's p.astype(v.dtype) (paged_split.cuh).
//
// What bounds it on this card: bytes.  Each (row, head) reads len * 2 *
// head_dim elements of K/V and does 0.5 flop per byte read (1 in 16
// bits), far below the
// H100's ~20 flop/byte float32 ridge, so the least time is the K/V bytes
// the rows need over the 3.35 TB/s of HBM (rows of one sequence share
// pages, which L2 serves after the first read).
//
// Design (paged_split.cuh, shared with csrc/paged_decode.cu): the TPU grid
// walked (row block, page) in order and carried the online-softmax state
// in VMEM scratch from one page step to the next.  Hopper runs blocks in
// parallel and in no order, so here each (row, head)'s keys are cut into
// up to 8 spans of whole pages, one CTA a span, the spans of a (row, head)
// one thread-block cluster whose rank 0 merges their softmax states
// through distributed shared memory, in rank order (one launch, no
// workspace, no atomics).  Within a span, lane groups of head_dim / 4
// lanes take one key each, and each lane streams its float4s of the K/V
// rows through a cp.async ring in shared memory, rescaling the running
// softmax once per stage of keys.  FMA, not the tensor cores: one query
// per row is a matrix-vector product.
//
// Tried and dropped: the first design, one CTA per (head, row) whose 4
// warps walked the keys one at a time (page id, K/V load, a 5-step
// shuffle reduction and two exps per key, all dependent), so the longest
// row set the kernel's time: 0.014 ms at the serving step and 0.41 ms at
// the 2048-key long case, 3.6x its byte bound there (PERF.md, section 6);
// the variants of the split design are listed in paged_split.cuh.
#include "paged_split.cuh"

namespace {

template <typename T, int W>
__global__ void __launch_bounds__(paged_split::kThreads)
ragged_attention_kernel(const float* __restrict__ q, long long q_row_stride,
                        const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ tables,
                        const int* __restrict__ row_lens,
                        float* __restrict__ out, int hidden, int page_size,
                        int num_pages, int pages_per_seq, int block_rows,
                        int span_pages, float sm_scale) {
  paged_split::split_body<T, W>(q, q_row_stride, k_pages, v_pages, tables,
                                row_lens, out, hidden, page_size, num_pages,
                                pages_per_seq, block_rows, span_pages,
                                sm_scale);
}

template <typename T>
int launch(const float* q, long long q_row_stride, const void* k_pages,
           const void* v_pages, const int* tables, const int* row_lens,
           float* out, int rows, int hidden, int num_heads, int page_size,
           int num_pages, int pages_per_seq, int block_rows, int span_pages,
           float sm_scale, void* stream) {
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  return paged_split::by_head_dim<T>(hidden / num_heads, [&](auto w) {
    return paged_split::launch_split(
        ragged_attention_kernel<T, decltype(w)::value>, rows, num_heads,
        pages_per_seq, span_pages, (cudaStream_t)stream, q, q_row_stride,
        kp, vp, tables, row_lens, out, hidden, page_size, num_pages,
        pages_per_seq, block_rows, span_pages, sm_scale);
  });
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the launch's CUDA error (0 = launched).  The
// wrapper guarantees head_dim in {4, 8, 16, 32, 64, 128} (16-bit pages:
// from 8), 16-byte aligned K/V rows, and span_pages from the span rule (at
// most 8 spans).  k_pages/v_pages hold float, __nv_bfloat16 or __half as
// the entry's suffix says.
#define RAGGED_ENTRY(SUFFIX, T)                                             \
  int ragged_paged_attention_##SUFFIX(                                      \
      const float* q, long long q_row_stride, const void* k_pages,          \
      const void* v_pages, const int* tables, const int* row_lens,          \
      float* out, int rows, int hidden, int num_heads, int page_size,       \
      int num_pages, int pages_per_seq, int block_rows, int span_pages,     \
      float sm_scale, void* stream) {                                       \
    return launch<T>(q, q_row_stride, k_pages, v_pages, tables, row_lens,   \
                     out, rows, hidden, num_heads, page_size, num_pages,    \
                     pages_per_seq, block_rows, span_pages, sm_scale,       \
                     stream);                                               \
  }
RAGGED_ENTRY(f32, float)
RAGGED_ENTRY(bf16, __nv_bfloat16)
RAGGED_ENTRY(f16, __half)
#undef RAGGED_ENTRY

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
