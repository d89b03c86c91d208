// 16-bit helpers shared by the 16-bit flash-attention bodies
// (flash_fwd_half.cuh, flash_bwd_half.cuh on half_wgmma.cuh) and the split
// passes' 16-bit stores (flash_fwd_grid.cuh, flash_bwd_grid.cu), for
// Hopper (sm_90a): the two element types, the staging swizzle of a 16-bit
// tile, and the rounds to and from float32.
//
// - Element types: Bf16 and F16 are the bodies' template arguments; either
//   is carried as its bits (h16, uint16_t), so the swizzle, the staging,
//   the descriptors and the tile layout are one code for both. Only the
//   rounds below and the warpgroup products' type (half_wgmma.cuh) look at
//   which it is. F32 names a float32 output of the split passes.
// - Swizzle: a row's 16-byte chunks of 8 elements are XOR-swizzled by the
//   row: chunk ^ (row & 7) on 128-byte rows (D = 64), chunk ^ ((row >> 1)
//   & 3) on 64-byte rows (D = 32, two rows a 128-byte line). On a tile
//   whose start is aligned to 1024 (512) bytes these are the 128-byte
//   (64-byte) swizzles the warpgroup products read through a shared-memory
//   descriptor (half_wgmma.cuh).
// - Rounding: pack2 rounds a pair to nearest even (cvt.rn.bf16x2.f32 or
//   cvt.rn.f16x2.f32), as torch's and XLA's casts do: float16 keeps its
//   subnormals and rounds past 65504 to inf. fold2 is the reference's
//   folded q, (q * sm_scale) rounded to the element type. Widening is a
//   shift for bf16 and cvt.f32.f16 for float16.
//
// Everything here has internal linkage, as in tf32_mma.cuh.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace mx_half {
namespace {

// a 16-bit element (bf16 or float16) as its bits
typedef uint16_t h16;

// the element types of the bodies and the split passes' outputs
struct Bf16 {
  typedef h16 elem;
  static constexpr bool kF16 = false;
};
struct F16 {
  typedef h16 elem;
  static constexpr bool kF16 = true;
};
struct F32 {
  typedef float elem;
};

// element (r, c) of a [rows][D] 16-bit shared tile (D = 32 or 64): 16-byte
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

// (lo, hi) rounded to float16, to nearest even, lo in the low half
__device__ __forceinline__ void pack_f16x2(uint32_t& d, float lo, float hi) {
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
}

// the float16 of bits h, widened (exactly)
__device__ __forceinline__ void widen_f16(float& d, uint16_t h) {
  asm("cvt.f32.f16 %0, %1;\n" : "=f"(d) : "h"(h));
}

// --- end of PTX -------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void pack2(uint32_t& d, float lo, float hi) {
  if constexpr (T::kF16)
    pack_f16x2(d, lo, hi);
  else
    pack_bf16x2(d, lo, hi);
}

// the element in the low (kHi false) or high half of w, as float32
template <typename T, bool kHi>
__device__ __forceinline__ float half_of(uint32_t w) {
  if constexpr (T::kF16) {
    float x;
    widen_f16(x, static_cast<uint16_t>(kHi ? w >> 16 : w & 0xFFFFu));
    return x;
  } else {
    return __uint_as_float(kHi ? w & 0xFFFF0000u : w << 16);
  }
}

// both halves of w times s, each rounded to T: the reference's
// (q.astype(float32) * sm_scale).astype(q.dtype)
template <typename T>
__device__ __forceinline__ uint32_t fold2(uint32_t w, float s) {
  uint32_t d;
  pack2<T>(d, half_of<T, false>(w) * s, half_of<T, true>(w) * s);
  return d;
}

// out[0..1] = (x0, x1) rounded to T, one 32-bit store
template <typename T>
__device__ __forceinline__ void store2(h16* out, float x0, float x1) {
  uint32_t d;
  pack2<T>(d, x0, x1);
  *reinterpret_cast<uint32_t*>(out) = d;
}

// out[0..3] = (a, b, c, d): one float4 store (T = F32), or rounded to the
// 16-bit T in one 8-byte store (the split passes' outputs)
template <typename T>
__device__ __forceinline__ void store4(typename T::elem* out, float a,
                                       float b, float c, float d) {
  if constexpr (sizeof(typename T::elem) == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
  } else {
    uint32_t lo, hi;
    pack2<T>(lo, a, b);
    pack2<T>(hi, c, d);
    *reinterpret_cast<uint2*>(out) = make_uint2(lo, hi);
  }
}

}  // namespace
}  // namespace mx_half
