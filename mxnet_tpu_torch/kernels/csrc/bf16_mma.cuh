// bf16 tensor-core helpers shared by the bf16 flash-attention bodies
// (flash_fwd_bf16.cuh, flash_bwd_bf16.cuh), for Hopper (sm_90a): the
// mma.sync.m16n8k16 product with bf16 operands and float32 accumulators,
// its fragment loaders, the round to bf16 (also the split passes' bf16
// stores, store4), and cp.async staging of bf16 tiles into XOR-swizzled
// shared memory.
//
// - Products: one mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 for each
//   16 x 8 x 16 step. A bf16 product is exact in float32, so there is no
//   split as in 3xTF32 (tf32_mma.cuh): the operands are the reference's
//   own bf16 values, and only the sums round.
// - Fragments (g = lane / 4, t = lane % 4; two bf16 a 32-bit register,
//   the lower column or row in the low half): A (16 x 16, row major) holds
//   (g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9);
//   B (16 x 8) holds (2t..2t+1, g) and (2t+8..2t+9, g); C (16 x 8, float32)
//   holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). So the C tiles of
//   two adjacent 8-column groups are, rounded to bf16 pairwise, the A
//   fragment of one 16-deep step (acc_to_a_bf): P and dS never leave the
//   registers.
// - Loads: an A fragment of a row-major tile, and a B fragment whose
//   contracted axis runs along a tile's rows of the transposed operand
//   (S = Q K^T: B(k, n) = K(n, k)), read two adjacent bf16 as one 32-bit
//   word (load_a_bf, load_b_rows). A B fragment whose contracted axis runs
//   down a tile's columns (O = P V: B(k, n) = V(k, n)) reads its two bf16
//   from two rows (load_b_cols).
// - Staging: 16-byte cp.async copies of 8 bf16, zero-filled past the valid
//   rows (src-size 0). A row's 16-byte chunks are XOR-swizzled so that both
//   load patterns fall in distinct banks: chunk ^ (row & 7), and at D = 32,
//   whose 64-byte rows put two rows on one 128-byte line, chunk ^ ((row >>
//   1) & 3).
// - Rounding: pack_bf16x2 rounds to nearest even (cvt.rn.bf16x2.f32), as
//   torch's and XLA's casts to bf16 do; fold2 is the reference's folded q,
//   (q * sm_scale) rounded to bf16.
//
// Everything here has internal linkage, as in tf32_mma.cuh.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"   // kThreads, kRows, tile_rows, cp.async

namespace mx_bf {
namespace {

using namespace mx_tc;

// a bf16 value as its bits
typedef uint16_t bf16;

// element (r, c) of a [rows][D] bf16 shared tile: 16-byte chunks of 8
// elements XOR-swizzled by the row
template <int D>
__device__ __forceinline__ int swb(int r, int c) {
  constexpr int kChunks = D / 8;
  const int x = kChunks >= 8 ? (r & 7) : ((r >> 1) & (kChunks - 1));
  return r * D + ((((c >> 3) ^ x) << 3) | (c & 7));
}

// --- PTX: mma.sync and cvt ---------------------------------------------------

// c += a b for one m16n8k16 bf16 tile, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (lo, hi) rounded to bf16, to nearest even, lo in the low half
__device__ __forceinline__ void pack_bf16x2(uint32_t& d, float lo, float hi) {
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
}

// --- end of PTX -------------------------------------------------------------

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// both halves of w times s, each rounded to bf16: the reference's
// (q.astype(float32) * sm_scale).astype(bfloat16)
__device__ __forceinline__ uint32_t fold2(uint32_t w, float s) {
  uint32_t d;
  pack_bf16x2(d, bf_lo(w) * s, bf_hi(w) * s);
  return d;
}

template <int D>
__device__ __forceinline__ uint32_t word(const bf16* s, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(s + swb<D>(r, c));
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile
template <int D>
__device__ __forceinline__ void load_a_bf(const bf16* s, int r0, int c0,
                                          int g, int t, uint32_t (&a)[4]) {
  a[0] = word<D>(s, r0 + g, c0 + 2 * t);
  a[1] = word<D>(s, r0 + g + 8, c0 + 2 * t);
  a[2] = word<D>(s, r0 + g, c0 + 2 * t + 8);
  a[3] = word<D>(s, r0 + g + 8, c0 + 2 * t + 8);
}

// B fragment of the transposed tile: k = column c0 + (2t.., 2t + 8..),
// n = row r0 + g (S = A B^T)
template <int D>
__device__ __forceinline__ void load_b_rows(const bf16* s, int r0, int c0,
                                            int g, int t, uint32_t (&b)[2]) {
  b[0] = word<D>(s, r0 + g, c0 + 2 * t);
  b[1] = word<D>(s, r0 + g, c0 + 2 * t + 8);
}

// B fragment of the tile itself: k = row r0 + (2t.., 2t + 8..), n = column
// c0 + g (O += P B)
template <int D>
__device__ __forceinline__ void load_b_cols(const bf16* s, int r0, int c0,
                                            int g, int t, uint32_t (&b)[2]) {
  const int c = c0 + g;
  b[0] = s[swb<D>(r0 + 2 * t, c)] |
         (static_cast<uint32_t>(s[swb<D>(r0 + 2 * t + 1, c)]) << 16);
  b[1] = s[swb<D>(r0 + 2 * t + 8, c)] |
         (static_cast<uint32_t>(s[swb<D>(r0 + 2 * t + 9, c)]) << 16);
}

// the C tiles of columns [0, 8) and [8, 16) of a 16-deep step, rounded to
// bf16, as that step's A fragment
__device__ __forceinline__ void acc_to_a_bf(const float (&c0)[4],
                                            const float (&c1)[4],
                                            uint32_t (&a)[4]) {
  pack_bf16x2(a[0], c0[0], c0[1]);
  pack_bf16x2(a[1], c0[2], c0[3]);
  pack_bf16x2(a[2], c1[0], c1[1]);
  pack_bf16x2(a[3], c1[2], c1[3]);
}

// cp.async rows [r0, r0 + R) of a [n, D] bf16 matrix into a swizzled
// shared tile, zeros from row r_end on
template <int D, int R>
__device__ __forceinline__ void stage_bf(bf16* dst, const bf16* src, int r0,
                                         int r_end) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < R * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r0 + r < r_end;
    cp_async16(reinterpret_cast<float*>(dst + swb<D>(r, c)),
               reinterpret_cast<const float*>(
                   src + static_cast<size_t>(ok ? r0 + r : 0) * D + c),
               ok);
  }
}

// fold sm_scale into a staged [R][D] tile in place (the caller
// synchronizes before and after)
template <int D, int R>
__device__ __forceinline__ void fold_tile(bf16* s, float sm_scale) {
  uint32_t* w = reinterpret_cast<uint32_t*>(s);
  for (int i = threadIdx.x; i < R * D / 2; i += kThreads)
    w[i] = fold2(w[i], sm_scale);
}

// out[0..1] = (x0, x1) rounded to bf16, one 32-bit store
__device__ __forceinline__ void store2(bf16* out, float x0, float x1) {
  uint32_t d;
  pack_bf16x2(d, x0, x1);
  *reinterpret_cast<uint32_t*>(out) = d;
}

// out[0..3] = (a, b, c, d): one float4 store, or rounded to bf16 in one
// 8-byte store (the split passes' float32 or bf16 outputs)
__device__ __forceinline__ void store4(float* out, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(bf16* out, float a, float b, float c,
                                       float d) {
  uint32_t lo, hi;
  pack_bf16x2(lo, a, b);
  pack_bf16x2(hi, c, d);
  *reinterpret_cast<uint2*>(out) = make_uint2(lo, hi);
}

}  // namespace
}  // namespace mx_bf
