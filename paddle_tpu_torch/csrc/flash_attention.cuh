#pragma once
// Flash attention for Hopper (sm_90a) on the tensor cores: three forwards
// and the backward pair they share, over packed heads and over the flat
// [B, H, T, D] layout, in float32 (flash_attention.cu's entries) and, on
// the packed layout, in bfloat16 and float16 (flash_attention_amp.cu's).
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
// Three device functions carry them (notes further down): the forward
// flash_fwd_tc_kernel, whose layout template argument sets its CTA's shape,
// and the backward pair flash_bwd_dq_tc_kernel and flash_bwd_dkv_tc_kernel,
// one shape for both layouts (the dk/dv kernel's PACKED argument picks its
// store).  The strides each entry passes set the layout.  The packed layout
// [B, T, nh*D] puts head h at column h*D of its row (so the three column
// slices of one [B, T, 3H] qkv projection are read in place, row stride 3H),
// its key bias is one [Tk] row per batch, and its dk and dv are written in
// [B, Tk, nh*D] or into the column slices of one [B, T, 3H] dqkv.  The flat
// layout puts a head `*_sh` elements (T*D) into its batch, its key bias is
// one row per (batch, head) (bias_sb, bias_sh: 0 broadcasts), and its dk and
// dv are written in [B, H, Tk, D].  dbias is per (batch, head), as the JAX
// custom VJP returns it; the packed caller sums it over heads.  The lse
// cotangent of flash_attention_lse is folded into delta by the caller
// (delta = rowsum(do*o) - dlse), so the backward kernels are unchanged by
// it.  flash_fwd_qkv reads q, k and v at column offsets 0, H and 2H of the
// PRE-bias [B, T, 3H] qkv projection and adds the matching slice of the qkv
// bias [3H] as each tile lands, so neither the biased qkv nor its slices
// are ever written; its dropout stream and lse layout are
// flash_fwd_packed's, so the packed backward pair differentiates it (on
// strided views of the re-biased qkv).
//
// What they compute, per batch b and head h:
//   s[i][j] = (q_i . k_j) * sm_scale + bias[b][(h)][j]  (float32)
//   s[i][j] = -1e30 where causal and j > i + Tk - Tq    (end-aligned; a
//             finite mask value, so a fully masked row stays finite)
//   p = softmax_j(s); o_i = sum_j drop(p)[i][j] v_j; lse_i = logsumexp_j s
// where drop(p) = p / (1 - rate) if the key-query pair is kept, else 0.
// Backward, from lse (p = exp(s - lse)) and delta_i = do_i . o_i:
//   dp = do . v^T (dropped like p), ds = p * (dp - delta)
//   dq = sm_scale * ds k, dk = sm_scale * ds^T q, dv = drop(p)^T do,
//   dbias[b][h][j] = sum_i ds[i][j].
// The dropout mask is never stored: bit (b, h, i, j) is Philox-4x32-10 of
// counter (j, i, b*nh + h, 0) under the 64-bit seed, kept when it exceeds
// rate * 2^32, so every kernel (and the debug mask entry) regenerates the
// same mask.
//
// What bounds them on this card.  The reference computes in float32.  One
// TF32 product keeps 11 bits of each operand, too few for the tolerances;
// "3xTF32" keeps float32's accuracy on the tensor cores: each operand x is
// split into big = tf32(x) and small = tf32(x - big), and a.b is summed as
// big.small + small.big + big.big in float32, three TF32 products per
// float32 one (495 TFLOP/s TF32: 165 effective).  The forward does 4 flops
// per visible (query, key, dim), dq 6 and dk/dv 8.  At BERT-base's training
// layer (B=32, T=128, nh=12, D=64) that is 1.6, 2.4 and 3.2 GFLOP over 50,
// 63 and 76 MB of inputs and outputs, so bytes bound all three there (at
// 3.35 TB/s); at the 4-D op's step (B=8, H=12, T=512, D=64: 6.4 GFLOP of
// forward over ~50 MB) and on a causal ring chunk at T=4096 (about half the
// tiles skipped) operations do.
//
// What they share: the TPU kernels walked a sequential grid, carrying the
// accumulators in VMEM scratch from one grid step to the next, and sliced
// 128-lane head groups out of the packed layout with BlockSpec index maps.
// Hopper runs blocks in parallel and in no order, so each CTA owns one
// (row tile, head, batch) and loops over the other sequence axis itself:
// the forward and the dq kernel over key tiles for a query tile, the dk/dv
// kernel over query tiles for a key tile, so no reduction crosses CTAs and
// no atomics are needed.  Ragged tails (any T) are masked: keys past Tk get
// p = 0 and rows past Tq are not written.  Causal tiles entirely above the
// diagonal are skipped where that is exact.
//
// Element types (AMP).  flash_fwd_packed, flash_fwd_qkv and the packed
// backward pair also run in bfloat16 and float16 (entries *_bf16, *_f16;
// the three device functions take the element type T as a template
// argument, the flat entries are float32 only): q, k, v, dout and the
// outputs o, dq, dk and dv are in T; lse, delta, the key bias, the qkv
// bias and dbias stay float32.  A T value is exact in TF32 (bfloat16
// keeps 7 stored mantissa bits, float16 10, TF32 10, and both exponent
// ranges lie inside float32's), so a T tile is widened to float32 as it
// lands and each product runs as ONE TF32 mma.sync of the big parts (the
// 3xTF32 split's small parts are exactly zero): exact products summed in
// float32, what the JAX kernels' dots with preferred_element_type=float32
// compute.  The JAX kernels' rounding points are kept: the dropped p is
// rounded to T before P~ V (pallas_ops.py `p.astype(v.dtype)`), ds before
// dS K and dS^T Q, the dropped p before P~^T dO; o, dq, dk and dv are
// stored in T; m, l, lse, delta and the dbias sums stay float32; the qkv
// entry adds its bias in float32 and rounds q, k and v to T.  A T tile is
// loaded with plain 8-byte loads (4 elements a thread) widened into the
// float32 tile that the float32 kernel's cp.async lands, so the shared
// memory, the fragments and the ring are the float32 kernel's; the copies
// are not asynchronous (the ring still alternates its two stages).  Native
// bfloat16 mma.sync.m16n8k16, wgmma and 2-byte stages are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value

// Strides are in elements: the [T, D] rows of (batch b, head h) start at
// b*_sb + h*_sh and lie _st apart; the head dimension is contiguous.
struct FlashParams {
  const float* q;
  long long q_sb, q_sh, q_st;
  const float* k;
  long long k_sb, k_sh, k_st;
  const float* v;
  long long v_sb, v_sh, v_st;
  const float* bias;  // the key-bias row of (b, h) at b*bias_sb + h*bias_sh,
                      // or nullptr
  long long bias_sb, bias_sh;
  const float* qkv_bias;  // flash_fwd_qkv: [3H], added to q | k | v on load
  const float* dout;      // backward: the output cotangent
  long long do_sb, do_sh, do_st;
  const float* lse;    // backward: [B, nh, Tq]
  const float* delta;  // backward: [B, nh, Tq]
  float* out;          // forward: o; dq kernel: dq
  long long out_sb, out_sh, out_st;
  float* lse_out;  // forward: [B, nh, Tq]
  float* dk;       // dk/dv kernel: [B, H, Tk, D], or (packed) rows of
  long long dk_sb, dk_st;  // [B, Tk, nh*D] at these strides
  float* dv;
  long long dv_sb, dv_st;
  float* dbias;  // dk/dv kernel: [B, nh, Tk]
  int B, nh, Tq, Tk, D;
  float scale;
  int causal;
  int dropout;
  uint32_t drop_threshold;  // keep when bits > threshold
  float drop_scale;         // 1 / (1 - rate)
  uint32_t seed0, seed1;
  int vec;  // q, k, v, dout load as 16-byte copies
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

// key tiles a query tile of `rows` rows must visit: under the causal mask,
// tiles right of the diagonal hold only masked keys, whose p is exactly 0
// when the row sees key 0 (a row with no visible key attends uniformly to
// all keys, as the reference's softmax over -1e30 does, so then nothing is
// skipped)
__device__ __forceinline__ int key_end(const FlashParams& P, int q0,
                                       int rows) {
  const int off = P.Tk - P.Tq;
  if (P.causal && q0 + off >= 0) return min(P.Tk, q0 + rows + off);
  return P.Tk;
}

// ---------------------------------------------------------------------------
// The backward pair: flash_bwd_dq_flat and flash_bwd_dkv_flat,
// flash_bwd_dq_packed and flash_bwd_dkv_packed.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_ops.py
// `_bwd_dq_kernel` and `_bwd_dq_kernel_packed` (dq), `_bwd_dkv_kernel` and
// `_bwd_dkv_kernel_packed` (dk, dv, dbias), launched by `_flash_bwd` and
// `_flash_bwd_packed`.  The function is the backward in the header, on
// either layout.
//
// Bound: operations at the 4-D op's step and the ring's chunks, bytes at a
// training layer (see the header).  The dq kernel's three products
// (S = Q K^T, dP = dO V^T, dQ += dS K) and the dk/dv kernel's four
// (S^T = K Q^T, dP^T = V dO^T, dV += P~^T dO, dK += dS^T Q) run as TF32
// mma.sync.m16n8k8 with the 3xTF32 split, three TF32 products per float32
// one on tensor cores rated 495 TFLOP/s: 3 * flops / 495e12, about 2.5x
// under the float32 FMA bound.  What the design does:
// - 3xTF32: big = tf32(x), small = tf32(x - big), tf32 being
//   cvt.rna.tf32.f32 done with integer operations (tf32_rna);
//   c += big.small, then small.big, then big.big (small.small dropped),
//   accumulated in float32 by the MMA: about 2^-22 relative a product,
//   float32's own rounding, where big.big alone (2^-11) would not hold the
//   gradients' 1e-4.  Each MMA rounds its sum toward zero; dQ, dK and dV
//   run over the whole sequence in one accumulator each, which a CPU model
//   of that rounding (tests/test_torch_flash_tf32x3.py) shows to hold the
//   gradient tolerance more than 20 times over at T 128 to 256, and the
//   qkv projection's gradients that a training step sums over 4096 rows
//   hundreds of times over, so no tile is folded into an IEEE sum here
//   (the forward folds each key tile, the GEMM #10 each k8 step).
// - Each operand is split once.  The streamed tiles (K and V for dq, Q
//   and dO for dk/dv) are the B operands all warps read: each thread
//   splits the elements it copied itself as soon as its copies land (so
//   no barrier comes first), big in place, small in a plane beside.  The
//   A operands (the CTA's own rows, and ds and p~ from the accumulators)
//   belong to one warp and are split in registers as their fragment is
//   read.  Planes for the CTA's own rows too would leave one 4-warp CTA
//   an SM at D 64; as it is two fit (104,704 and 104,960 bytes; one at
//   D 128).
// - One warp per 16 rows of the CTA's (query rows for dq, key rows for
//   dk/dv) across the whole streamed tile: S and dP land in the same
//   accumulator layout, so p = exp(s - lse), the keep bit, ds =
//   p (dp - delta) and the dbias sums are computed in registers, element
//   for element.  The accumulator (C) layout is carried into the next
//   product's A operand with no data movement: a lane holds columns 2t and
//   2t + 1 of its rows, A wants columns t and t + 4, and a sum over k does
//   not care which k is which, so A's column t is read as key (or query)
//   2t and its column t + 4 as 2t + 1, and the B fragment is read from
//   shared memory under the same permutation (rows 2t and 2t + 1).  That
//   needs neither a shared-memory strip (a store, a barrier and a load a
//   tile) nor quad shuffles (four a fragment).
// - The CTA's shape (kBwdWarps): 4 warps, 64 rows, two CTAs an SM, for
//   both layouts.  A training layer's T is 128, so a 64-row CTA streams
//   only four tiles and each head's K and V (or Q and dO) is read and split
//   by two CTAs; an 8-warp CTA at D <= 64 (128 rows, one an SM, 139,520 and
//   139,776 bytes) reads and splits them once, for the same warps an SM.
//   Timed against each other on the packed layout at the training layer
//   (python3 -m paddle_tpu_torch.tools.flash_breakdown), the 4-warp shape
//   was faster in all of six turns: one CTA an SM leaves each CTA's first
//   copies and its stores unhidden.
// - Streamed tiles of 32 rows (16 query rows for dk/dv at D 128, whose dk
//   and dv take 128 registers) land by cp.async in a 2-stage ring: tile
//   j + 1 is issued right after the barrier that opens tile j, so it lands
//   while j is multiplied.  Rows are padded to D + 4 floats, which puts
//   both fragment reads (row g, column t; and row 2t, column g) on 32
//   distinct banks.  The packed layout's q, k, v views of one [B, T, 3H]
//   projection have row stride 3H, a multiple of 4, so they land as 16-byte
//   copies too.
// - The Philox keep bits are the other kernels' (same counter, same
//   seed), drawn element for element beside ds.  Dropout is a template
//   flag, so the path without it carries none of the Philox code and
//   its registers.
// - Grid (B*H, tiles), the tile slowest and the heaviest causal tiles
//   first (the last query tiles for dq, the first key tiles for dk/dv), so
//   the triangle's long tiles do not trail the launch.  The causal tile
//   skips are the exact ones above (key_end, q_begin).  Each output element
//   is written by one CTA: no atomics, the same bits on every launch.
// - dq is written through its strides in both layouts.  dk and dv are too
//   in the packed instantiations of the dk/dv kernel (PACKED), so the
//   fused backward hands it the column slices of one dqkv; the flat ones
//   keep their contiguous index: one store loop through strides for both
//   moved ptxas's allocation of the flat kernels and cost the ring's
//   causal T 4096 dk/dv 2% (PERF.md).
constexpr int kTcStream = 32;  // rows of a streamed tile

// warps of a backward CTA at D <= 64 (16 rows each; 4 at D 128, where 8
// would not fit the dq kernel's tiles in shared memory): 4, measured faster
// than 8 (see the note above)
constexpr int kBwdWarps = 4;

// the backward's CTA shape: warps and CTAs an SM
__host__ __device__ constexpr int tc_bwd_warps(int dm) {
  return dm <= 64 ? kBwdWarps : 4;
}

__host__ __device__ constexpr int tc_bwd_ctas(int dm) {
  return tc_bwd_warps(dm) > 4 ? 1 : 2;
}

// query rows of the dk/dv kernel's streamed tile: 16 at D 128, where dk
// and dv alone hold 128 accumulators a thread
__host__ __device__ constexpr int tc_dkv_rows(int dm) {
  return dm > 64 ? 16 : kTcStream;
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, 10 mantissa
// bits kept), bit for bit on finite values and infinities: half a unit of
// the last kept place added to the magnitude bits, the 13 dropped bits
// cleared.  Two integer operations, where the PTX instruction compiles to
// a longer sequence with range checks and selects.  Not on a NaN: the add
// carries the canonical NaN 0x7fffffff through the exponent into a zero
// (split_tf32 keeps the NaN)
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

__device__ __forceinline__ Frag<4> frag_a(float a0, float a1, float a2,
                                          float a3) {
  Frag<4> f;
  split_tf32(a0, f.big[0], f.small[0]);
  split_tf32(a1, f.big[1], f.small[1]);
  split_tf32(a2, f.big[2], f.small[2]);
  split_tf32(a3, f.big[3], f.small[3]);
  return f;
}

// a B fragment split as its tile landed: big parts at b and b + o1 (rows
// t and t + 4 of the fragment), small parts `small` floats on
__device__ __forceinline__ Frag<2> frag_b_split(const float* b, int small,
                                                int o1) {
  Frag<2> f;
  f.big[0] = __float_as_uint(b[0]);
  f.big[1] = __float_as_uint(b[o1]);
  f.small[0] = __float_as_uint(b[small]);
  f.small[1] = __float_as_uint(b[small + o1]);
  return f;
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows [r0, r0 + ROWS) x dims [0, DM) of a [T, D] head slice (row stride
// st) into shared memory (leading dimension DM + 4) by cp.async, zeros
// past `rows` and D; vec: 16-byte copies (D, st and g 16-byte aligned); NT
// threads copy
template <int DM, int ROWS, int NT>
__device__ __forceinline__ void tile_async(float* s, const float* g,
                                           long long st, int r0, int rows,
                                           int D, bool vec) {
  constexpr int LD = DM + 4;
  if (vec) {
    constexpr int C = DM / 4;
    for (int idx = threadIdx.x; idx < ROWS * C; idx += NT) {
      const int r = idx / C, d = idx % C * 4, row = r0 + r;
      const bool ok = row < rows && d < D;
      cp_async16(s + r * LD + d, ok ? g + (long long)row * st + d : g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DM; idx += NT) {
      const int r = idx / DM, d = idx % DM, row = r0 + r;
      const bool ok = row < rows && d < D;
      cp_async4(s + r * LD + d, ok ? g + (long long)row * st + d : g, ok);
    }
  }
}

// after cp.async.wait_group: split the elements of a tile that this thread
// copied with tile_async<DM, ROWS, NT> (so no barrier is needed first), big
// in place, small `small` floats on; with ADD, first add add[d] (shared
// memory, DM floats) to every element of column d
template <int DM, int ROWS, int NT, bool ADD = false>
__device__ __forceinline__ void split_landed(float* s, int small, bool vec,
                                             const float* add = nullptr) {
  constexpr int LD = DM + 4;
  if (vec) {
    constexpr int C = DM / 4;
    for (int idx = threadIdx.x; idx < ROWS * C; idx += NT) {
      float4* x = reinterpret_cast<float4*>(s + idx / C * LD + idx % C * 4);
      float4 big = *x, sm;
      if (ADD) {
        const float4 a = *reinterpret_cast<const float4*>(add + idx % C * 4);
        big.x += a.x; big.y += a.y; big.z += a.z; big.w += a.w;
      }
      uint32_t b, m;
      split_tf32(big.x, b, m); big.x = __uint_as_float(b); sm.x = __uint_as_float(m);
      split_tf32(big.y, b, m); big.y = __uint_as_float(b); sm.y = __uint_as_float(m);
      split_tf32(big.z, b, m); big.z = __uint_as_float(b); sm.z = __uint_as_float(m);
      split_tf32(big.w, b, m); big.w = __uint_as_float(b); sm.w = __uint_as_float(m);
      *x = big;
      x[small / 4] = sm;
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DM; idx += NT) {
      float* x = s + idx / DM * LD + idx % DM;
      uint32_t b, m;
      split_tf32(ADD ? *x + add[idx % DM] : *x, b, m);
      *x = __uint_as_float(b);
      x[small] = __uint_as_float(m);
    }
  }
}

// g[c0 .. c0 + N) into s, zeros past n; NT threads copy
template <int N, int NT>
__device__ __forceinline__ void row_async(float* s, const float* g, int c0,
                                          int n) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const bool ok = c0 + i < n;
    cp_async4(s + i, ok ? g + c0 + i : g, ok);
  }
}

// ---- element types (see the header): float32, bfloat16, float16

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
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

// x rounded to T (float32: x itself), a rounding point of the JAX kernels
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

// the entries' float pointers as the element type's
template <typename T>
__device__ __forceinline__ const T* elem(const float* p) {
  return reinterpret_cast<const T*>(p);
}
template <typename T>
__device__ __forceinline__ T* elem(float* p) {
  return reinterpret_cast<T*>(p);
}

// c += a b: float32 as 3xTF32; T as one TF32 product (its small parts
// are 0, so the loads and splits that feed them are dead code)
template <typename T>
__device__ __forceinline__ void mma_t(float (&c)[4], const Frag<4>& a,
                                      const Frag<2>& b) {
  if constexpr (kF32<T>) mma_3xtf32(c, a, b);
  else mma_tf32(c, a.big, b.big);
}

// 4 consecutive T at p (8-byte aligned), widened
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 widen4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// tile_async's tile of T: float32 by cp.async (tile_async); a T tile by
// plain loads, widened into the same float32 layout by the same threads
// in the same order (vec: 4 elements, 8 bytes, a load)
template <int DM, int ROWS, int NT, typename T>
__device__ __forceinline__ void tile_load(float* s, const T* g, long long st,
                                          int r0, int rows, int D, bool vec) {
  if constexpr (kF32<T>) {
    tile_async<DM, ROWS, NT>(s, g, st, r0, rows, D, vec);
  } else {
    constexpr int LD = DM + 4;
    if (vec) {
      constexpr int C = DM / 4;
      for (int idx = threadIdx.x; idx < ROWS * C; idx += NT) {
        const int r = idx / C, d = idx % C * 4, row = r0 + r;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < rows && d < D) x = widen4(g + (long long)row * st + d);
        *reinterpret_cast<float4*>(s + r * LD + d) = x;
      }
    } else {
      for (int idx = threadIdx.x; idx < ROWS * DM; idx += NT) {
        const int r = idx / DM, d = idx % DM, row = r0 + r;
        s[r * LD + d] =
            row < rows && d < D ? widen(g[(long long)row * st + d]) : 0.f;
      }
    }
  }
}

// split_landed for a tile of T: float32 splits (split_landed); a T tile
// has nothing to split (its small parts are 0), and with ADD this thread's
// elements (tile_load's) get add[d] in float32, rounded back to T
template <int DM, int ROWS, int NT, typename T, bool ADD = false>
__device__ __forceinline__ void land(float* s, int small, bool vec,
                                     const float* add = nullptr) {
  if constexpr (kF32<T>) {
    split_landed<DM, ROWS, NT, ADD>(s, small, vec, add);
  } else if constexpr (ADD) {
    constexpr int LD = DM + 4;
    if (vec) {
      constexpr int C = DM / 4;
      for (int idx = threadIdx.x; idx < ROWS * C; idx += NT) {
        float4* x = reinterpret_cast<float4*>(s + idx / C * LD + idx % C * 4);
        const float4 a = *reinterpret_cast<const float4*>(add + idx % C * 4);
        float4 v = *x;
        v.x = round_to<T>(v.x + a.x);
        v.y = round_to<T>(v.y + a.y);
        v.z = round_to<T>(v.z + a.z);
        v.w = round_to<T>(v.w + a.w);
        *x = v;
      }
    } else {
      for (int idx = threadIdx.x; idx < ROWS * DM; idx += NT) {
        float* x = s + idx / DM * LD + idx % DM;
        *x = round_to<T>(*x + add[idx % DM]);
      }
    }
  }
}

// the keep bit of the attention kernels: keep_pair's, bit for bit (a
// function of its own so that tools/flash_breakdown.py can compile
// Philox out of them and not out of the mask entry)
__device__ __forceinline__ bool tc_keep(const FlashParams& P, int key,
                                        int query, int bh) {
  return keep_pair(P, key, query, bh);
}

template <int DM, bool DROP, typename T = float>
__global__ void __launch_bounds__(32 * tc_bwd_warps(DM), tc_bwd_ctas(DM))
flash_bwd_dq_tc_kernel(const FlashParams P) {
  constexpr int NT = 32 * tc_bwd_warps(DM), ROWS = NT / 2,  // 16 a warp
                BK = kTcStream, LD = DM + 4, TILE = ROWS * LD, KT = BK * LD,
                NJ = BK / 8, ND = DM / 8;
  extern __shared__ __align__(16) float tc_smem[];
  float* sQ = tc_smem;
  float* sdO = sQ + TILE;
  float* sKV = sdO + TILE;      // 2 stages x (K, V, then their small parts)
  float* sBias = sKV + 8 * KT;  // 2 stages x BK
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / P.nh, h = bh - b * P.nh;
  const int tile = P.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * ROWS, D = P.D, off = P.Tk - P.Tq;
  const bool vec = P.vec;
  const T* kb = elem<T>(P.k) + b * P.k_sb + h * P.k_sh;
  const T* vb = elem<T>(P.v) + b * P.v_sb + h * P.v_sh;
  const float* biasb =
      P.bias ? P.bias + b * P.bias_sb + h * P.bias_sh : nullptr;

  tile_load<DM, ROWS, NT>(sQ, elem<T>(P.q) + b * P.q_sb + h * P.q_sh,
                          P.q_st, q0, P.Tq, D, vec);
  tile_load<DM, ROWS, NT>(sdO, elem<T>(P.dout) + b * P.do_sb + h * P.do_sh,
                          P.do_st, q0, P.Tq, D, vec);
  auto issue = [&](int k0, int s) {  // stage s <- the key tile at k0
    float* sk = sKV + s * 4 * KT;
    tile_load<DM, BK, NT>(sk, kb, P.k_st, k0, P.Tk, D, vec);
    tile_load<DM, BK, NT>(sk + KT, vb, P.v_st, k0, P.Tk, D, vec);
    if (biasb) row_async<BK, NT>(sBias + s * BK, biasb, k0, P.Tk);
    cp_async_commit();
  };
  issue(0, 0);

  // this lane's rows: g and g + 8 of the warp's 16
  const int qlo = q0 + 16 * warp + g, qhi = qlo + 8;
  const long long rows = (long long)bh * P.Tq;
  const float lse_lo = qlo < P.Tq ? P.lse[rows + qlo] : 0.f;
  const float lse_hi = qhi < P.Tq ? P.lse[rows + qhi] : 0.f;
  const float dl_lo = qlo < P.Tq ? P.delta[rows + qlo] : 0.f;
  const float dl_hi = qhi < P.Tq ? P.delta[rows + qhi] : 0.f;
  const float* aQ = sQ + (16 * warp + g) * LD + t;
  const float* aO = sdO + (16 * warp + g) * LD + t;

  float acc[ND][4] = {};
  const int k_end = key_end(P, q0, ROWS);
  for (int it = 0, k0 = 0; k0 < k_end; ++it, k0 += BK) {
    float* sK = sKV + (it & 1) * 4 * KT;
    const float* sV = sK + KT;
    cp_async_wait_all();
    land<DM, BK, NT, T>(sK, 2 * KT, vec);
    land<DM, BK, NT, T>(sK + KT, 2 * KT, vec);
    __syncthreads();  // tile `it` landed for all; tile it - 1's stage is free
    if (k0 + BK < k_end) issue(k0 + BK, (it + 1) & 1);
    const float* sB = sBias + (it & 1) * BK;

    float s[NJ][4] = {}, dp[NJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int c = 8 * kk;
      const Frag<4> qa = frag_a(aQ[c], aQ[8 * LD + c], aQ[c + 4],
                                aQ[8 * LD + c + 4]);
      const Frag<4> oa = frag_a(aO[c], aO[8 * LD + c], aO[c + 4],
                                aO[8 * LD + c + 4]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kr = sK + (8 * j + g) * LD + c + t;
        const float* vr = sV + (8 * j + g) * LD + c + t;
        mma_t<T>(s[j], qa, frag_b_split(kr, 2 * KT, 4));
        mma_t<T>(dp[j], oa, frag_b_split(vr, 2 * KT, 4));
      }
    }

    // element (row g + 8 (e / 2), key 8j + 2t + e % 2): ds in place of s
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? qlo : qhi;
        const int kl = 8 * j + 2 * t + (e & 1), kj = k0 + kl;
        float p = 0.f;
        if (kj < P.Tk) {
          float x = s[j][e] * P.scale + (biasb ? sB[kl] : 0.f);
          if (P.causal && kj > qi + off) x = kNegInf;
          p = expf(x - (e < 2 ? lse_lo : lse_hi));
        }
        float dpv = dp[j][e];
        if (DROP) dpv = tc_keep(P, kj, qi, bh) ? dpv * P.drop_scale : 0.f;
        s[j][e] = round_to<T>(p * (dpv - (e < 2 ? dl_lo : dl_hi)));
      }

    // dQ += dS K, A's column t read as key 2t and t + 4 as key 2t + 1
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      const Frag<4> da = frag_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* kr = sK + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma_t<T>(acc[n], da, frag_b_split(kr + 8 * n, 2 * KT, LD));
    }
  }

  T* dq = elem<T>(P.out) + b * P.out_sb + h * P.out_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = e < 2 ? qlo : qhi, d = 8 * n + 2 * t + (e & 1);
      if (qi < P.Tq && d < D)
        dq[(long long)qi * P.out_st + d] = narrow<T>(acc[n][e] * P.scale);
    }
}

// PACKED: dk and dv are written as the packed entries take them, head h
// at column h*D of rows dk_st (dv_st) apart; else contiguous [B, H, Tk, D]
template <int DM, bool PACKED, bool DROP, typename T = float>
__global__ void __launch_bounds__(32 * tc_bwd_warps(DM), tc_bwd_ctas(DM))
flash_bwd_dkv_tc_kernel(const FlashParams P) {
  constexpr int NT = 32 * tc_bwd_warps(DM), ROWS = NT / 2,  // 16 a warp
                BN = tc_dkv_rows(DM), LD = DM + 4, KT = ROWS * LD,
                QT = BN * LD, NJ = BN / 8, ND = DM / 8;
  extern __shared__ __align__(16) float tc_smem[];
  float* sK = tc_smem;         // key rows of this CTA
  float* sV = sK + KT;
  float* sQdO = sV + KT;       // 2 stages x (Q, dO, then their small parts)
  float* sLD = sQdO + 8 * QT;  // 2 stages x (lse, delta)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / P.nh, h = bh - b * P.nh;
  const int k0 = blockIdx.y * ROWS, D = P.D, off = P.Tk - P.Tq;
  const bool vec = P.vec;
  const T* qb = elem<T>(P.q) + b * P.q_sb + h * P.q_sh;
  const T* dob = elem<T>(P.dout) + b * P.do_sb + h * P.do_sh;
  const long long rows = (long long)bh * P.Tq;

  tile_load<DM, ROWS, NT>(sK, elem<T>(P.k) + b * P.k_sb + h * P.k_sh,
                          P.k_st, k0, P.Tk, D, vec);
  tile_load<DM, ROWS, NT>(sV, elem<T>(P.v) + b * P.v_sb + h * P.v_sh,
                          P.v_st, k0, P.Tk, D, vec);
  auto issue = [&](int q0, int s) {  // stage s <- the query tile at q0
    float* sq = sQdO + s * 4 * QT;
    tile_load<DM, BN, NT>(sq, qb, P.q_st, q0, P.Tq, D, vec);
    tile_load<DM, BN, NT>(sq + QT, dob, P.do_st, q0, P.Tq, D, vec);
    row_async<BN, NT>(sLD + s * 2 * BN, P.lse + rows, q0, P.Tq);
    row_async<BN, NT>(sLD + s * 2 * BN + BN, P.delta + rows, q0, P.Tq);
    cp_async_commit();
  };
  // under the causal mask, query tiles wholly before the first query that
  // sees key k0 contribute exactly 0, unless some row sees no key at all
  // (Tq > Tk), which attends uniformly and so reaches every key
  int q_begin = 0;
  if (P.causal && P.Tq <= P.Tk) q_begin = max(0, k0 - off) / BN * BN;
  issue(q_begin, 0);

  // this lane's key rows: g and g + 8 of the warp's 16
  const int klo = k0 + 16 * warp + g, khi = klo + 8;
  const float* biasb =
      P.bias ? P.bias + b * P.bias_sb + h * P.bias_sh : nullptr;
  const float bias_lo = biasb && klo < P.Tk ? __ldg(biasb + klo) : 0.f;
  const float bias_hi = biasb && khi < P.Tk ? __ldg(biasb + khi) : 0.f;
  const float* aK = sK + (16 * warp + g) * LD + t;
  const float* aV = sV + (16 * warp + g) * LD + t;

  float dk[ND][4] = {}, dv[ND][4] = {};
  float db_lo = 0.f, db_hi = 0.f;
  for (int it = 0, q0 = q_begin; q0 < P.Tq; ++it, q0 += BN) {
    float* sQ = sQdO + (it & 1) * 4 * QT;
    const float* sdO = sQ + QT;
    cp_async_wait_all();
    land<DM, BN, NT, T>(sQ, 2 * QT, vec);
    land<DM, BN, NT, T>(sQ + QT, 2 * QT, vec);
    __syncthreads();  // tile `it` landed for all; tile it - 1's stage is free
    if (q0 + BN < P.Tq) issue(q0 + BN, (it + 1) & 1);
    const float* sL = sLD + (it & 1) * 2 * BN;
    const float* sDl = sL + BN;

    float s[NJ][4] = {}, dp[NJ][4] = {};  // [key][query]
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int c = 8 * kk;
      const Frag<4> ka = frag_a(aK[c], aK[8 * LD + c], aK[c + 4],
                                aK[8 * LD + c + 4]);
      const Frag<4> va = frag_a(aV[c], aV[8 * LD + c], aV[c + 4],
                                aV[8 * LD + c + 4]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* qr = sQ + (8 * j + g) * LD + c + t;
        const float* gr = sdO + (8 * j + g) * LD + c + t;
        mma_t<T>(s[j], ka, frag_b_split(qr, 2 * QT, 4));
        mma_t<T>(dp[j], va, frag_b_split(gr, 2 * QT, 4));
      }
    }

    // element (key g + 8 (e / 2), query 8j + 2t + e % 2): the dropped p in
    // place of s, ds in place of dp
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = e < 2 ? klo : khi;
        const int ql = 8 * j + 2 * t + (e & 1), qi = q0 + ql;
        float p = 0.f;
        if (kj < P.Tk && qi < P.Tq) {
          float x = s[j][e] * P.scale + (e < 2 ? bias_lo : bias_hi);
          if (P.causal && kj > qi + off) x = kNegInf;
          p = expf(x - sL[ql]);
        }
        float pd = p, dpv = dp[j][e];
        if (DROP) {
          const bool kept = tc_keep(P, kj, qi, bh);
          pd = kept ? p * P.drop_scale : 0.f;
          dpv = kept ? dpv * P.drop_scale : 0.f;
        }
        const float ds = p * (dpv - sDl[ql]);
        if (e < 2) db_lo += ds;
        else db_hi += ds;
        s[j][e] = round_to<T>(pd);
        dp[j][e] = round_to<T>(ds);
      }

    // dV += P~^T dO and dK += dS^T Q, A's column t read as query 2t and
    // t + 4 as query 2t + 1
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      const Frag<4> pa = frag_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const Frag<4> da = frag_a(dp[kk][0], dp[kk][2], dp[kk][1], dp[kk][3]);
      const float* gr = sdO + (8 * kk + 2 * t) * LD + g;
      const float* qr = sQ + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        mma_t<T>(dv[n], pa, frag_b_split(gr + 8 * n, 2 * QT, LD));
        mma_t<T>(dk[n], da, frag_b_split(qr + 8 * n, 2 * QT, LD));
      }
    }
  }

  // dbias: a key row's sum, over the quad's columns
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    db_lo += __shfl_xor_sync(0xffffffffu, db_lo, o);
    db_hi += __shfl_xor_sync(0xffffffffu, db_hi, o);
  }
  const long long krow = (long long)bh * P.Tk;
  T* dkb = elem<T>(P.dk) + (PACKED ? b * P.dk_sb + (long long)h * D : 0);
  T* dvb = elem<T>(P.dv) + (PACKED ? b * P.dv_sb + (long long)h * D : 0);
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = e < 2 ? klo : khi, d = 8 * n + 2 * t + (e & 1);
      if (kj < P.Tk && d < D) {
        if constexpr (PACKED) {
          dkb[(long long)kj * P.dk_st + d] = narrow<T>(dk[n][e] * P.scale);
          dvb[(long long)kj * P.dv_st + d] = narrow<T>(dv[n][e]);
        } else {  // contiguous: one index for both
          const long long i = (krow + kj) * D + d;
          elem<T>(P.dk)[i] = narrow<T>(dk[n][e] * P.scale);
          elem<T>(P.dv)[i] = narrow<T>(dv[n][e]);
        }
      }
    }
  if (t == 0) {
    if (klo < P.Tk) P.dbias[krow + klo] = db_lo;
    if (khi < P.Tk) P.dbias[krow + khi] = db_hi;
  }
}

// ---------------------------------------------------------------------------
// The forwards on the tensor cores: flash_fwd_flat, flash_fwd_qkv and
// flash_fwd_packed.
//
// Replace the Pallas TPU kernels `_fwd_kernel` and `_fwd_kernel_packed`
// (paddle_tpu/ops/pallas_ops.py, launched by `_flash_fwd` and
// `_flash_fwd_packed`) and `_qkv_fwd_kernel` (paddle_tpu/ops/
// attention_epilogue.py, launched by `_qkv_attn_fwd`).  The function is the
// forward in the header: o and lse, over the flat layout's strided heads
// and per-(batch, head) bias rows, or over the packed layout (its head
// stride D, its bias [B, Tk]): flash_fwd_packed's q, k, v, or
// flash_fwd_qkv's packed qkv projection, biased as it lands.
//
// Bound: operations at the 4-D op's step and the ring's chunks, bytes at a
// training layer (see the header).  S = Q K^T and O += P~ V run as TF32
// mma.sync.m16n8k8 with the 3xTF32 split of the backward pair above:
// 4 flops per visible (query, key, dim), three TF32 products per float32
// one, 495 TFLOP/s.  What the design does:
// - One warp per 16 query rows, across the whole streamed key tile: S
//   lands in the accumulator layout, where the scale, the key bias, the
//   masks, the online maximum (two quad shuffles a row), expf, the row
//   sums and the keep bit are worked element for element.  P~ then becomes
//   the A operand of P~ V with no data movement, by the backward pair's
//   column permutation (V's B fragment read from rows 2t and 2t + 1): no
//   probability tile in shared memory and no third barrier a tile.
// - Q is the A operand of every key tile, so it is split once.  The flat
//   forward at D <= 64 keeps its big and small fragments in registers (64
//   a thread at D 64), read from a Q tile that lands in the second stage
//   of the K/V ring before that stage is first used: 4 warps and 69,888
//   bytes of shared memory.  With dropout it runs three CTAs an SM (168
//   registers, a small spill), whose warps hide the Philox work; without,
//   two (no spill), which measured faster than three with the spill that
//   ptxas makes there.  Where
//   registers do not hold them beside the output (D 128) or beside
//   flash_fwd_qkv's bias work (it spilled there), Q is split into big and
//   small planes in shared memory, with the q slice of the qkv bias added
//   first.  flash_fwd_qkv's CTA is 8 warps (128 query rows) at D <= 64, so
//   the T 128 of a training step streams its K and V once a head, not
//   twice (one CTA an SM, 140,288 bytes); at D 128, 4 warps and one CTA.
//   flash_fwd_packed takes that shape without the bias work (its own
//   layout): at a training layer's T 128 it measured faster than the flat
//   forward's 4 warps with Q in registers, in all of six turns.
// - K and V stream in 32-key tiles through a 2-stage cp.async ring: tile
//   j + 1 is issued right after the barrier that opens tile j, and each
//   thread splits the elements it copied as they land (flash_fwd_qkv adds
//   the k or v bias slice first, from a copy of the head's slices in
//   shared memory).  The key-bias row of a tile lands beside it.  Rows are
//   padded to D + 4 floats: both fragment reads hit 32 banks.  A third
//   stage (two CTAs an SM) was slower.
// - Each key tile's P~ V is summed from zero on the tensor cores, then
//   added to the running output as o = o * alpha + tile in IEEE float32
//   FFMA, so the tensor cores' own accumulation never spans more than one
//   tile of 32 keys, however long the row.  The loop runs over the output
//   columns outside and the tile's keys inside, so a tile sum takes four
//   registers and P~'s fragments (32) stay live across it.
// - Dropout is a template flag: the path without it (the ring, the parity
//   gates) carries none of the Philox code.  The keep bits are every other
//   kernel's (same counter, same seed).
// - Grid (B*H, query tiles), causal tiles heaviest first; key tiles past
//   key_end are skipped exactly.
constexpr int kTcKeys = 32;  // keys of a streamed K/V tile

// the forward's layouts: flash_fwd_flat's [B, H, T, D]; flash_fwd_qkv's
// pre-bias qkv projection, biased as it lands; flash_fwd_packed's
// [B, T, nh D]
enum FwdLayout { kFlatFwd, kQkvFwd, kPackedFwd };

// The forward's shape at D (see the note above): Q split into registers,
// else into shared-memory planes; warps of a CTA, 16 query rows each; CTAs
// an SM (the launch bound: three leave 168 registers a thread)
__host__ __device__ constexpr bool tc_fwd_qreg(int dm, int layout) {
  return dm <= 64 && layout == kFlatFwd;
}

__host__ __device__ constexpr int tc_fwd_warps(int dm, int layout) {
  return layout != kFlatFwd && dm <= 64 ? 8 : 4;
}

__host__ __device__ constexpr int tc_fwd_ctas(int dm, int layout, bool drop) {
  return tc_fwd_qreg(dm, layout) ? (drop ? 3 : 2) : 1;
}

// shared memory of the forward: 2 stages of K, V (+ small parts) and the
// bias row; kQkvFwd: the head's q, k, v bias slices; Q's planes
__host__ __device__ constexpr int tc_fwd_smem_floats(int dm, int layout) {
  return 2 * (4 * kTcKeys * (dm + 4) + kTcKeys) +
         (layout == kQkvFwd ? 3 * dm : 0) +
         (tc_fwd_qreg(dm, layout)
              ? 0
              : 2 * 16 * tc_fwd_warps(dm, layout) * (dm + 4));
}

// an A fragment whose big and small parts sit in planes `small` floats
// apart: rows g and g + 8 (8 * LD on), columns t and t + 4
template <int LD>
__device__ __forceinline__ Frag<4> frag_a_split(const float* a, int small) {
  Frag<4> f;
  f.big[0] = __float_as_uint(a[0]);
  f.big[1] = __float_as_uint(a[8 * LD]);
  f.big[2] = __float_as_uint(a[4]);
  f.big[3] = __float_as_uint(a[8 * LD + 4]);
  f.small[0] = __float_as_uint(a[small]);
  f.small[1] = __float_as_uint(a[small + 8 * LD]);
  f.small[2] = __float_as_uint(a[small + 4]);
  f.small[3] = __float_as_uint(a[small + 8 * LD + 4]);
  return f;
}

// LAYOUT: a FwdLayout (kQkvFwd: q, k, v biased as they land by
// P.qkv_bias)
template <int DM, int LAYOUT, bool DROP, typename T = float>
__global__ void __launch_bounds__(32 * tc_fwd_warps(DM, LAYOUT),
                                  tc_fwd_ctas(DM, LAYOUT, DROP))
flash_fwd_tc_kernel(const FlashParams P) {
  constexpr bool QKV = LAYOUT == kQkvFwd;
  constexpr int NT = 32 * tc_fwd_warps(DM, LAYOUT), ROWS = NT / 2,  // 16 a warp
                BK = kTcKeys, LD = DM + 4, KT = BK * LD, QT = ROWS * LD,
                NJ = BK / 8, ND = DM / 8;
  constexpr bool QREG = tc_fwd_qreg(DM, LAYOUT);
  static_assert(!QREG || (ROWS <= 4 * BK && !QKV),
                "Q lands in one stage of the ring, unbiased");
  extern __shared__ __align__(16) float tc_smem[];
  float* sKV = tc_smem;         // 2 stages x (K, V, then their small parts)
  float* sBias = sKV + 8 * KT;  // 2 stages x BK
  float* sAdd = sBias + 2 * BK;  // QKV: the q, k and v bias slices, DM each
  // the Q tile: in stage 1 of the ring (QREG), else big and small planes
  float* sQ = QREG ? sKV + 4 * KT : sAdd + (QKV ? 3 * DM : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / P.nh, h = bh - b * P.nh;
  const int tile = P.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * ROWS, D = P.D, off = P.Tk - P.Tq;
  const bool vec = P.vec;
  const T* kb = elem<T>(P.k) + b * P.k_sb + h * P.k_sh;
  const T* vb = elem<T>(P.v) + b * P.v_sb + h * P.v_sh;
  const float* biasb =
      P.bias ? P.bias + b * P.bias_sb + h * P.bias_sh : nullptr;

  tile_load<DM, ROWS, NT>(sQ, elem<T>(P.q) + b * P.q_sb + h * P.q_sh,
                          P.q_st, q0, P.Tq, D, vec);
  auto issue = [&](int k0, int s) {  // stage s <- the key tile at k0
    float* sk = sKV + s * 4 * KT;
    tile_load<DM, BK, NT>(sk, kb, P.k_st, k0, P.Tk, D, vec);
    tile_load<DM, BK, NT>(sk + KT, vb, P.v_st, k0, P.Tk, D, vec);
    if (biasb) row_async<BK, NT>(sBias + s * BK, biasb, k0, P.Tk);
    cp_async_commit();
  };
  issue(0, 0);
  if constexpr (QKV) {
    // this head's slices of the qkv bias [3H] (zeros past D)
    const long long H = (long long)P.nh * D;
    for (int i = threadIdx.x; i < 3 * DM; i += NT) {
      const int part = i / DM, d = i - part * DM;
      sAdd[i] = d < D ? __ldg(P.qkv_bias + part * H + (long long)h * D + d)
                      : 0.f;
    }
  }

  // this lane's rows: g and g + 8 of the warp's 16
  const int qlo = q0 + 16 * warp + g, qhi = qlo + 8;
  const float* aQ = sQ + (16 * warp + g) * LD + t;
  Frag<4> qf[QREG ? ND : 1];
  cp_async_wait_all();
  if constexpr (QREG) {
    __syncthreads();  // the Q tile landed for all
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int c = 8 * kk;
      qf[kk] = frag_a(aQ[c], aQ[8 * LD + c], aQ[c + 4], aQ[8 * LD + c + 4]);
    }
  } else {
    if constexpr (QKV) __syncthreads();  // the bias slices landed for all
    // Q's planes, published by the first tile's barrier
    land<DM, ROWS, NT, T, QKV>(sQ, QT, vec, sAdd);
  }

  float o[ND][4] = {};
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  const int k_end = key_end(P, q0, ROWS);
  for (int it = 0, k0 = 0; k0 < k_end; ++it, k0 += BK) {
    float* sK = sKV + (it & 1) * 4 * KT;
    const float* sV = sK + KT;
    cp_async_wait_all();
    land<DM, BK, NT, T, QKV>(sK, 2 * KT, vec, sAdd + DM);
    land<DM, BK, NT, T, QKV>(sK + KT, 2 * KT, vec, sAdd + 2 * DM);
    __syncthreads();  // tile `it` landed for all; tile it - 1's stage is free
    if (k0 + BK < k_end) issue(k0 + BK, (it + 1) & 1);
    const float* sB = sBias + (it & 1) * BK;

    // S = Q K^T
    float s[NJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int c = 8 * kk;
      Frag<4> qa;
      if constexpr (QREG) qa = qf[kk];
      else qa = frag_a_split<LD>(aQ + c, QT);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_t<T>(s[j], qa,
                 frag_b_split(sK + (8 * j + g) * LD + c + t, 2 * KT, 4));
    }

    // element (row g + 8 (e / 2), key 8j + 2t + e % 2): the masked score,
    // then the row's new maximum
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? qlo : qhi;
        const int kl = 8 * j + 2 * t + (e & 1), kj = k0 + kl;
        float x = -CUDART_INF_F;  // past the keys: p = 0
        if (kj < P.Tk) {
          x = s[j][e] * P.scale + (biasb ? sB[kl] : 0.f);
          if (P.causal && kj > qi + off) x = kNegInf;
        }
        s[j][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
#pragma unroll
    for (int o1 = 1; o1 < 4; o1 <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o1));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // p, the row sums (every key, dropped or not), then the dropped p~
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - (e < 2 ? mn_lo : mn_hi));
        if (e < 2) rs_lo += p;
        else rs_hi += p;
        if (DROP) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          p = tc_keep(P, kj, e < 2 ? qlo : qhi, bh) ? p * P.drop_scale : 0.f;
        }
        s[j][e] = round_to<T>(p);
      }
    l_lo = l_lo * al_lo + rs_lo;
    l_hi = l_hi * al_hi + rs_hi;

    // O = O * alpha + P~ V, the tile's sum from zero; A's column t read as
    // key 2t and t + 4 as key 2t + 1
    Frag<4> pa[NJ];
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk)
      pa[kk] = frag_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float pv[4] = {};
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk)
        mma_t<T>(pv, pa[kk],
                 frag_b_split(sV + (8 * kk + 2 * t) * LD + 8 * n + g,
                              2 * KT, LD));
      o[n][0] = fmaf(o[n][0], al_lo, pv[0]);
      o[n][1] = fmaf(o[n][1], al_lo, pv[1]);
      o[n][2] = fmaf(o[n][2], al_hi, pv[2]);
      o[n][3] = fmaf(o[n][3], al_hi, pv[3]);
    }
  }

  // a row's sum over the quad's columns
#pragma unroll
  for (int o1 = 1; o1 < 4; o1 <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o1);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  T* ob = elem<T>(P.out) + b * P.out_sb + h * P.out_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = e < 2 ? qlo : qhi, d = 8 * n + 2 * t + (e & 1);
      if (qi < P.Tq && d < D)
        ob[(long long)qi * P.out_st + d] =
            narrow<T>(o[n][e] * (e < 2 ? inv_lo : inv_hi));
    }
  if (t == 0) {
    const long long rows = (long long)bh * P.Tq;
    if (qlo < P.Tq) P.lse_out[rows + qlo] = m_lo + logf(l_lo);
    if (qhi < P.Tq) P.lse_out[rows + qhi] = m_hi + logf(l_hi);
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

enum Which { kFwdFlat, kFwdQkv, kFwdPacked, kDq, kDkvFlat, kDkvPacked };

// the forwards; grid (B*H, query tiles)
template <int DM, int LAYOUT, typename T>
cudaError_t launch_fwd(const FlashParams& P, cudaStream_t stream) {
  void (*kernel)(const FlashParams) =
      P.dropout ? flash_fwd_tc_kernel<DM, LAYOUT, true, T>
                : flash_fwd_tc_kernel<DM, LAYOUT, false, T>;
  const size_t bytes = tc_fwd_smem_floats(DM, LAYOUT) * sizeof(float);
  const int rows = 16 * tc_fwd_warps(DM, LAYOUT);
  const int tiles = (P.Tq + rows - 1) / rows;
  if (tiles > 65535 || (long long)P.B * P.nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(P.B * P.nh, tiles), 2 * rows, bytes, stream>>>(P);
  return cudaGetLastError();
}

// the backward pair, either layout (a T other than float: the packed
// one); grid (B*H, tiles)
template <int DM, typename T>
cudaError_t launch_bwd(Which w, const FlashParams& P, cudaStream_t stream) {
  constexpr int LD = DM + 4, ROWS = 16 * tc_bwd_warps(DM);
  const bool dq = w == kDq;
  void (*kernel)(const FlashParams) = nullptr;
  if (dq) {
    kernel = P.dropout ? flash_bwd_dq_tc_kernel<DM, true, T>
                       : flash_bwd_dq_tc_kernel<DM, false, T>;
  } else if (w == kDkvPacked) {
    kernel = P.dropout ? flash_bwd_dkv_tc_kernel<DM, true, true, T>
                       : flash_bwd_dkv_tc_kernel<DM, true, false, T>;
  } else if constexpr (kF32<T>) {
    kernel = P.dropout ? flash_bwd_dkv_tc_kernel<DM, false, true>
                       : flash_bwd_dkv_tc_kernel<DM, false, false>;
  } else {
    return cudaErrorInvalidValue;
  }
  // dq: Q, dO and 2 stages of K, V (+ small parts) and the bias row;
  // dk/dv: K, V and 2 stages of Q, dO (+ small parts), lse and delta
  const int rows = dq ? kTcStream : tc_dkv_rows(DM);
  const size_t bytes =
      (2 * ROWS * LD + 8 * rows * LD + (dq ? 2 : 4) * rows) * sizeof(float);
  const int tiles = ((dq ? P.Tq : P.Tk) + ROWS - 1) / ROWS;
  if (tiles > 65535 || (long long)P.B * P.nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(P.B * P.nh, tiles), 2 * ROWS, bytes, stream>>>(P);
  return cudaGetLastError();
}

// T: the element type; the flat layout runs float32 only
template <int DM, typename T>
cudaError_t launch_dm(Which w, const FlashParams& P, cudaStream_t stream) {
  if (w == kDq || w == kDkvFlat || w == kDkvPacked)
    return launch_bwd<DM, T>(w, P, stream);
  if (w == kFwdQkv) return launch_fwd<DM, kQkvFwd, T>(P, stream);
  if (w == kFwdPacked) return launch_fwd<DM, kPackedFwd, T>(P, stream);
  if constexpr (kF32<T>) return launch_fwd<DM, kFlatFwd, T>(P, stream);
  return cudaErrorInvalidValue;
}

// the kernel shape for D: 32, 64 or 128 dims (a T other than float: 64
// or 128, a narrower head zero-padded, which keeps its build short)
template <typename T = float>
int launch(Which w, const FlashParams& P, void* stream) {
  if (P.B == 0 || P.nh == 0 || P.Tq == 0 || P.Tk == 0) return 0;
  if (P.D <= 0 || P.D > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (kF32<T>) {
    if (P.D <= 32) return (int)launch_dm<32, T>(w, P, s);
  }
  if (P.D <= 64) return (int)launch_dm<64, T>(w, P, s);
  return (int)launch_dm<128, T>(w, P, s);
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

// the packed layout in the kernels' terms: heads D apart in every tensor,
// the key bias one [Tk] row per batch
void set_packed(FlashParams& P) {
  P.q_sh = P.k_sh = P.v_sh = P.do_sh = P.out_sh = P.D;
  P.bias_sb = P.Tk;
  P.bias_sh = 0;
}

// the kernels may load q, k, v and dout as 16-byte copies: D, every stride
// and every base a multiple of 4 floats
bool vec_loads(const FlashParams& P) {
  const float* base[] = {P.q, P.k, P.v, P.dout};
  const long long strides[] = {P.q_sb, P.q_sh, P.q_st, P.k_sb, P.k_sh,
                               P.k_st, P.v_sb, P.v_sh, P.v_st, P.do_sb,
                               P.do_sh, P.do_st};
  bool ok = P.D % 4 == 0;
  for (const float* p : base) ok = ok && (uintptr_t)p % 16 == 0;
  for (long long st : strides) ok = ok && st % 4 == 0;
  return ok;
}

// The packed entries over the element type T: q, k, v, dout and the
// outputs o, dq, dk, dv in T (carried in FlashParams' float pointers),
// bias, lse, delta and dbias float32.  Strides are in elements.
template <typename T>
int fwd_packed(const T* q, long long q_sb, long long q_st, const T* k,
               long long k_sb, long long k_st, const T* v, long long v_sb,
               long long v_st, const float* bias, T* o, long long o_sb,
               long long o_st, float* lse, int B, int nh, int Tq, int Tk,
               int D, float scale, int causal, float rate,
               unsigned int seed0, unsigned int seed1, void* stream) {
  FlashParams P = make_params((const float*)q, q_sb, q_st, (const float*)k,
                              k_sb, k_st, (const float*)v, v_sb, v_st, bias,
                              B, nh, Tq, Tk, D, scale, causal, rate, seed0,
                              seed1);
  P.out = (float*)o; P.out_sb = o_sb; P.out_st = o_st;
  P.lse_out = lse;
  set_packed(P);
  P.vec = vec_loads(P);
  return launch<T>(kFwdPacked, P, stream);
}

template <typename T>
int bwd_dq_packed(const T* q, long long q_sb, long long q_st, const T* k,
                  long long k_sb, long long k_st, const T* v, long long v_sb,
                  long long v_st, const float* bias, const T* dout,
                  long long do_sb, long long do_st, const float* lse,
                  const float* delta, T* dq, long long dq_sb,
                  long long dq_st, int B, int nh, int Tq, int Tk, int D,
                  float scale, int causal, float rate, unsigned int seed0,
                  unsigned int seed1, void* stream) {
  FlashParams P = make_params((const float*)q, q_sb, q_st, (const float*)k,
                              k_sb, k_st, (const float*)v, v_sb, v_st, bias,
                              B, nh, Tq, Tk, D, scale, causal, rate, seed0,
                              seed1);
  P.dout = (const float*)dout; P.do_sb = do_sb; P.do_st = do_st;
  P.lse = lse; P.delta = delta;
  P.out = (float*)dq; P.out_sb = dq_sb; P.out_st = dq_st;
  set_packed(P);
  P.vec = vec_loads(P);
  return launch<T>(kDq, P, stream);
}

template <typename T>
int bwd_dkv_packed(const T* q, long long q_sb, long long q_st, const T* k,
                   long long k_sb, long long k_st, const T* v,
                   long long v_sb, long long v_st, const float* bias,
                   const T* dout, long long do_sb, long long do_st,
                   const float* lse, const float* delta, T* dk,
                   long long dk_sb, long long dk_st, T* dv, long long dv_sb,
                   long long dv_st, float* dbias, int B, int nh, int Tq,
                   int Tk, int D, float scale, int causal, float rate,
                   unsigned int seed0, unsigned int seed1, void* stream) {
  FlashParams P = make_params((const float*)q, q_sb, q_st, (const float*)k,
                              k_sb, k_st, (const float*)v, v_sb, v_st, bias,
                              B, nh, Tq, Tk, D, scale, causal, rate, seed0,
                              seed1);
  P.dout = (const float*)dout; P.do_sb = do_sb; P.do_st = do_st;
  P.lse = lse; P.delta = delta;
  P.dk = (float*)dk; P.dk_sb = dk_sb; P.dk_st = dk_st;
  P.dv = (float*)dv; P.dv_sb = dv_sb; P.dv_st = dv_st;
  P.dbias = dbias;
  set_packed(P);
  P.vec = vec_loads(P);
  return launch<T>(kDkvPacked, P, stream);
}

template <typename T>
int fwd_qkv(const T* qkv, long long qkv_sb, long long qkv_st,
            const float* b_qkv, const float* bias, T* o, long long o_sb,
            long long o_st, float* lse, int B, int nh, int Tq, int Tk, int D,
            float scale, int causal, float rate, unsigned int seed0,
            unsigned int seed1, void* stream) {
  if (Tq != Tk || b_qkv == nullptr) return (int)cudaErrorInvalidValue;
  const long long H = (long long)nh * D;
  FlashParams P = make_params(
      (const float*)qkv, qkv_sb, qkv_st, (const float*)(qkv + H), qkv_sb,
      qkv_st, (const float*)(qkv + 2 * H), qkv_sb, qkv_st, bias, B, nh, Tq,
      Tk, D, scale, causal, rate, seed0, seed1);
  P.qkv_bias = b_qkv;
  P.out = (float*)o; P.out_sb = o_sb; P.out_st = o_st;
  P.lse_out = lse;
  set_packed(P);
  P.vec = vec_loads(P);
  return launch<T>(kFwdQkv, P, stream);
}

}  // namespace
