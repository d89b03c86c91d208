// Tensor-core helpers shared by the flash-attention bodies (flash_fwd.cuh,
// flash_bwd.cuh), for Hopper (sm_90a): float32-accurate products on the
// TF32 tensor cores, their fragment loaders, and cp.async staging into
// XOR-swizzled shared tiles.
//
// - Products: mma.sync.m16n8k8 with TF32 operands and float32
//   accumulators, each float32 product as three (3xTF32): x = hi + lo with
//   hi = rna(x) and lo = rna(x - hi), rounded to TF32 as cvt.rna.tf32.f32
//   rounds but on the bit pattern (two integer operations; cvt runs on
//   the slower conversion pipe), a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
//   (the lo.lo term is below float32's last bit). That keeps ~21 mantissa
//   bits, where one TF32 product keeps ~10 and would miss the 1e-4 gate.
//   The MMAs go term-major over kGroup independent accumulator tiles, so no
//   MMA waits on the one before it. The tensor cores round their float32
//   sums toward zero: a caller sums a long contraction a tile at a time
//   from zero and adds the tiles with an ordinary float32 add.
// - Accumulators to A fragments without shared memory or shuffles: an
//   m16n8k8 accumulator gives a thread columns 2t and 2t + 1 of its rows,
//   while the A fragment wants columns t and t + 4. The sum over the
//   contracted axis does not care about its order, so the second product
//   contracts over the permuted order (2t, 2t + 1) in place of (t, t + 4):
//   a = {c0, c2, c1, c3} (acc_to_a), and the B fragment reads rows 2t and
//   2t + 1 of the walked tile to match (load_bp).
// - Staging: 16-byte cp.async copies, zero-filled past the valid rows
//   (src-size 0), so padding rows hold zeros and never NaN. Rows are
//   XOR-swizzled by 16-byte chunk (chunk ^ (row & 7)), so both fragment
//   patterns, (row g, column t) and (row 2t, column g), fall in 32 distinct
//   banks.
//
// Everything here has internal linkage (an anonymous namespace): several
// libraries of one process instantiate these templates, and nothing of one
// may resolve to another's.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace mx_tc {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // rows a block owns: 64

// rows of a walked tile: 64, or 32 at D = 128, where the 16 x 128
// accumulators a warp holds leave no registers for a wider tile
template <int D>
__host__ __device__ constexpr int tile_rows() { return D == 128 ? 32 : 64; }

// element (r, c) of a [rows][D] shared tile: 16-byte chunks XOR-swizzled
// by the row's low three bits
template <int D>
__device__ __forceinline__ int sw(int r, int c) {
  return r * D + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// --- PTX: cp.async and mma.sync ----------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c += a b for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- end of PTX -------------------------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the same bits for every finite x), on the bit pattern: two
// integer operations at full rate, where cvt takes the slower conversion
// pipe
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each rounded to TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// accumulator tiles a product step updates together
constexpr int kGroup = 4;

// 3xTF32: c[u] += a b[u] for kGroup independent tiles in float32 accuracy,
// the small terms first; term-major, so consecutive MMAs never wait on one
// another's accumulator
__device__ __forceinline__ void mma3_group(float (*c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[kGroup][2],
                                           const uint32_t (&bl)[kGroup][2]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) mma_tf32(c[u], al, bh[u]);
#pragma unroll
  for (int u = 0; u < kGroup; ++u) mma_tf32(c[u], ah, bl[u]);
#pragma unroll
  for (int u = 0; u < kGroup; ++u) mma_tf32(c[u], ah, bh[u]);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 8) of a shared tile
template <int D>
__device__ __forceinline__ void load_a(const float* s, int r0, int c0, int g,
                                       int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(s[sw<D>(r0 + g, c0 + t)], hi[0], lo[0]);
  split_tf32(s[sw<D>(r0 + g + 8, c0 + t)], hi[1], lo[1]);
  split_tf32(s[sw<D>(r0 + g, c0 + t + 4)], hi[2], lo[2]);
  split_tf32(s[sw<D>(r0 + g + 8, c0 + t + 4)], hi[3], lo[3]);
}

// B fragment of the transposed tile: k = column c0 + (t, t + 4), n = row
// r0 + g (S = A B^T)
template <int D>
__device__ __forceinline__ void load_bt(const float* s, int r0, int c0, int g,
                                        int t, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split_tf32(s[sw<D>(r0 + g, c0 + t)], hi[0], lo[0]);
  split_tf32(s[sw<D>(r0 + g, c0 + t + 4)], hi[1], lo[1]);
}

// B fragment of the tile in the permuted order: k = row r0 + (2t, 2t + 1),
// n = column c0 + g (O += P B, P from an accumulator via acc_to_a)
template <int D>
__device__ __forceinline__ void load_bp(const float* s, int r0, int c0, int g,
                                        int t, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split_tf32(s[sw<D>(r0 + 2 * t, c0 + g)], hi[0], lo[0]);
  split_tf32(s[sw<D>(r0 + 2 * t + 1, c0 + g)], hi[1], lo[1]);
}

// an accumulator tile as the A fragment of the permuted order
__device__ __forceinline__ void acc_to_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// c[u] += a b_u^T, b_u = rows [r0 + 8u, r0 + 8u + 8), columns [c0, c0 + 8)
// of shared tile s (scores: the contracted axis is the head dim)
template <int D>
__device__ __forceinline__ void mma_rows(float (*c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* s, int r0, int c0,
                                         int g, int t) {
  uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    load_bt<D>(s, r0 + 8 * u, c0, g, t, bh[u], bl[u]);
  mma3_group(c, ah, al, bh, bl);
}

// c[u] += a b_u, b_u = rows [r0, r0 + 8) in the permuted order, columns
// [c0 + 8u, c0 + 8u + 8) of shared tile s (a from acc_to_a)
template <int D>
__device__ __forceinline__ void mma_cols(float (*c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* s, int r0, int c0,
                                         int g, int t) {
  uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    load_bp<D>(s, r0, c0 + 8 * u, g, t, bh[u], bl[u]);
  mma3_group(c, ah, al, bh, bl);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

template <int N>
__device__ __forceinline__ void add(float (&acc)[N][4],
                                    const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// cp.async rows [r0, r0 + R) of a [n, D] matrix into a swizzled shared
// tile, zeros from row r_end on
template <int D, int R>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int r_end) {
  constexpr int kChunks = D / 4;
  static_assert(R * kChunks % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < R * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool ok = r0 + r < r_end;
    cp_async16(dst + sw<D>(r, c),
               src + static_cast<size_t>(ok ? r0 + r : 0) * D + c, ok);
  }
}

}  // namespace
}  // namespace mx_tc

// `return call;` with the constexpr int D bound to the head dim d (32, 64
// or 128); any other d returns cudaErrorInvalidValue
#define MX_DISPATCH_D(call)                                   \
  switch (d) {                                                \
    case 32: { constexpr int D = 32; return call; }           \
    case 64: { constexpr int D = 64; return call; }           \
    case 128: { constexpr int D = 128; return call; }         \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }
