// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel paddle_tpu/generation/attention.py
// `_paged_decode_kernel` (launched by `paged_flash_decode_attention`), the
// attention of the legacy scheduler's decode step.
//
// What it computes: S sequence slots, each with ONE query vector q[s] of
// `hidden` = num_heads * head_dim floats.  Slot s attends, per head, over
// keys 0..len-1 of its page list page_table[s] (len = eff_lens[s], clipped
// to pages_per_seq * page_size).  len == 0 is an empty slot and writes
// exact zeros.  Scores, softmax and the weighted sum are float32, as in
// the TPU kernel.
//
// What bounds it on this card: bytes.  Each (slot, head) reads len * 2 *
// head_dim floats of K/V once and does 0.5 flop per byte read, far below
// the H100's ~20 flop/byte float32 ridge, so the least time is the K/V of
// the live keys over the 3.35 TB/s of HBM.
//
// Design: the ragged kernel's (csrc/ragged_attention.cu) with one row and
// one table row per slot (block_rows = 1), from paged_split.cuh: each
// (slot, head)'s keys cut into up to 8 spans of whole pages, one CTA a
// span and one cluster a (slot, head), the spans merged by rank 0 through
// distributed shared memory; lane groups of head_dim / 4 lanes stream
// each key's head slice as 16-byte cp.async copies through a ring in
// shared memory.  The TPU grid walked every page of the table row and
// masked the dead ones; here a span past the slot's length does no work.
// FMA, not the tensor cores: one query per slot is a matrix-vector
// product.
//
// Tried and dropped: the first design, one CTA per (slot, head) that kept
// every score of the table in shared memory (which capped pages_per_seq)
// and made two passes over the keys (scores, then V) with block-wide
// reductions between them: 96 CTAs for 132 SMs at the serving step
// (0.0078 ms there, 0.154 ms at the 2048-key long case; PERF.md, section
// 6); the variants of the split design are listed in paged_split.cuh.
//
// Two settings differ from the ragged kernel's, each measured on both
// (paddle_tpu_torch/tools/paged_split_variants.py): the ring is 2 stages
// of 4 keys a lane group (ragged: 3 of 2), so a decode step's slot of 128
// keys waits on 4 stages, not 8 (the serving step's decode ~10% faster;
// the ragged kernel's long case ~19% slower with it); and the grid runs
// heads inner (ragged: rows), since no two slots share pages and the
// heads of one key row sit side by side in memory (2-9% faster here; the
// ragged long case ~30% slower).
#ifndef PAGED_SPLIT_STAGES
#define PAGED_SPLIT_STAGES 2
#endif
#ifndef PAGED_SPLIT_UNROLL
#define PAGED_SPLIT_UNROLL 4
#endif
#ifndef PAGED_SPLIT_HEADS_INNER
#define PAGED_SPLIT_HEADS_INNER 1
#endif
#include "paged_split.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(paged_split::kThreads)
paged_decode_kernel(const float* __restrict__ q, long long q_row_stride,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ eff_lens,
                    float* __restrict__ out, int hidden, int page_size,
                    int num_pages, int pages_per_seq, int span_pages,
                    float sm_scale) {
  paged_split::split_body<W>(q, q_row_stride, k_pages, v_pages, page_table,
                             eff_lens, out, hidden, page_size, num_pages,
                             pages_per_seq, 1, span_pages, sm_scale);
}

template <int W>
int launch(const float* q, long long q_row_stride, const float* k_pages,
           const float* v_pages, const int* page_table, const int* eff_lens,
           float* out, int seqs, int hidden, int num_heads, int page_size,
           int num_pages, int pages_per_seq, int span_pages, float sm_scale,
           cudaStream_t stream) {
  return paged_split::launch_split(
      paged_decode_kernel<W>, seqs, num_heads, pages_per_seq, span_pages,
      stream, q, q_row_stride, k_pages, v_pages, page_table, eff_lens, out,
      hidden, page_size, num_pages, pages_per_seq, span_pages, sm_scale);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the launch's CUDA error (0 = launched).  The
// wrapper guarantees head_dim in {4, 8, 16, 32, 64, 128}, 16-byte aligned
// K/V rows, and span_pages from the span rule (at most 8 spans).
int paged_decode_attention_f32(const float* q, long long q_row_stride,
                               const float* k_pages, const float* v_pages,
                               const int* page_table, const int* eff_lens,
                               float* out, int seqs, int hidden,
                               int num_heads, int page_size, int num_pages,
                               int pages_per_seq, int span_pages,
                               float sm_scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hidden / num_heads) {
#define PAGED_SPLIT_CASE(D)                                                 \
  case D:                                                                   \
    return launch<D / 4>(q, q_row_stride, k_pages, v_pages, page_table,    \
                         eff_lens, out, seqs, hidden, num_heads, page_size, \
                         num_pages, pages_per_seq, span_pages, sm_scale,   \
                         st);
    PAGED_SPLIT_CASE(4)
    PAGED_SPLIT_CASE(8)
    PAGED_SPLIT_CASE(16)
    PAGED_SPLIT_CASE(32)
    PAGED_SPLIT_CASE(64)
    PAGED_SPLIT_CASE(128)
#undef PAGED_SPLIT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
