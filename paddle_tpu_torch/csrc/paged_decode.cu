// Paged decode attention for Hopper (sm_90a): float32 pages, and bfloat16
// and float16 pages (a 16-bit KV cache; q and the output stay float32).
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
// the TPU kernel; 16-bit pages are widened in registers and p is rounded
// to the pages' type for P.V only, as the TPU kernel's p.astype(v.dtype)
// (paged_split.cuh).
//
// What bounds it on this card: bytes.  Each (slot, head) reads len * 2 *
// head_dim elements of K/V once and does 0.5 flop per byte read (1 in 16
// bits), far below
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

template <typename T, int W>
__global__ void __launch_bounds__(paged_split::kThreads)
paged_decode_kernel(const float* __restrict__ q, long long q_row_stride,
                    const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ eff_lens,
                    float* __restrict__ out, int hidden, int page_size,
                    int num_pages, int pages_per_seq, int span_pages,
                    float sm_scale) {
  paged_split::split_body<T, W>(q, q_row_stride, k_pages, v_pages,
                                page_table, eff_lens, out, hidden,
                                page_size, num_pages, pages_per_seq, 1,
                                span_pages, sm_scale);
}

template <typename T>
int launch(const float* q, long long q_row_stride, const void* k_pages,
           const void* v_pages, const int* page_table, const int* eff_lens,
           float* out, int seqs, int hidden, int num_heads, int page_size,
           int num_pages, int pages_per_seq, int span_pages, float sm_scale,
           void* stream) {
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  return paged_split::by_head_dim<T>(hidden / num_heads, [&](auto w) {
    return paged_split::launch_split(
        paged_decode_kernel<T, decltype(w)::value>, seqs, num_heads,
        pages_per_seq, span_pages, (cudaStream_t)stream, q, q_row_stride,
        kp, vp, page_table, eff_lens, out, hidden, page_size, num_pages,
        pages_per_seq, span_pages, sm_scale);
  });
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the launch's CUDA error (0 = launched).  The
// wrapper guarantees head_dim in {4, 8, 16, 32, 64, 128} (16-bit pages:
// from 8), 16-byte aligned K/V rows, and span_pages from the span rule (at
// most 8 spans).  k_pages/v_pages hold float, __nv_bfloat16 or __half as
// the entry's suffix says.
#define PAGED_DECODE_ENTRY(SUFFIX, T)                                       \
  int paged_decode_attention_##SUFFIX(                                      \
      const float* q, long long q_row_stride, const void* k_pages,          \
      const void* v_pages, const int* page_table, const int* eff_lens,      \
      float* out, int seqs, int hidden, int num_heads, int page_size,       \
      int num_pages, int pages_per_seq, int span_pages, float sm_scale,     \
      void* stream) {                                                       \
    return launch<T>(q, q_row_stride, k_pages, v_pages, page_table,         \
                     eff_lens, out, seqs, hidden, num_heads, page_size,     \
                     num_pages, pages_per_seq, span_pages, sm_scale,        \
                     stream);                                               \
  }
PAGED_DECODE_ENTRY(f32, float)
PAGED_DECODE_ENTRY(bf16, __nv_bfloat16)
PAGED_DECODE_ENTRY(f16, __half)
#undef PAGED_DECODE_ENTRY

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
