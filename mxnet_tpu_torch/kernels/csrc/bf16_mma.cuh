// bf16 helpers shared by the bf16 flash-attention bodies
// (flash_fwd_bf16.cuh, flash_bwd_bf16.cuh on bf16_wgmma.cuh) and the split
// passes' bf16 stores (flash_fwd_grid.cuh, flash_bwd_grid.cu), for Hopper
// (sm_90a): the staging swizzle of a bf16 tile and the round to bf16.
//
// - Swizzle: a row's 16-byte chunks of 8 bf16 are XOR-swizzled by the row:
//   chunk ^ (row & 7) on 128-byte rows (D = 64), chunk ^ ((row >> 1) & 3)
//   on 64-byte rows (D = 32, two rows a 128-byte line). On a tile whose
//   start is aligned to 1024 (512) bytes these are the 128-byte (64-byte)
//   swizzles the warpgroup products read through a shared-memory
//   descriptor (bf16_wgmma.cuh).
// - Rounding: pack_bf16x2 rounds to nearest even (cvt.rn.bf16x2.f32), as
//   torch's and XLA's casts to bf16 do; fold2 is the reference's folded q,
//   (q * sm_scale) rounded to bf16.
//
// Everything here has internal linkage, as in tf32_mma.cuh.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace mx_bf {
namespace {

// a bf16 value as its bits
typedef uint16_t bf16;

// element (r, c) of a [rows][D] bf16 shared tile (D = 32 or 64): 16-byte
// chunks of 8 elements XOR-swizzled by the row
template <int D>
__device__ __forceinline__ int swb(int r, int c) {
  constexpr int kChunks = D / 8;
  const int x = kChunks >= 8 ? (r & 7) : ((r >> 1) & (kChunks - 1));
  return r * D + ((((c >> 3) ^ x) << 3) | (c & 7));
}

// --- PTX: cvt ----------------------------------------------------------------

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
