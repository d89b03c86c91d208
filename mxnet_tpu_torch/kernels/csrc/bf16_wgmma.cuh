// Warpgroup tensor-core products for the bf16 flash-attention bodies
// (flash_fwd_bf16.cuh, flash_bwd_bf16.cuh), for Hopper (sm_90a): Hopper's
// wgmma.mma_async with bf16 operands and float32 accumulators, the
// shared-memory matrix descriptors of the staged tiles, and the staging
// itself (cp.async into tiles aligned to their swizzle atom).
//
// - Products: wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16, issued
//   by the 128 threads of a warpgroup for 64 rows, N = 32, 64 or 128.
//   B is always read from shared memory through a descriptor; A from
//   shared memory too (wgmma_ss: q, dO, K, V of the block) or from
//   registers (wgmma_rs: P and dS, rounded to bf16 straight from the
//   accumulators). A bf16 product is exact in float32: only the sums round.
// - Register layouts: warp w of the warpgroup holds rows 16w..16w + 15.
//   The accumulator of columns 8n..8n + 7 is d[4n..4n + 3], the mma.sync
//   m16n8 C layout of the warp's rows ((g, 2t), (g, 2t + 1), (g + 8, 2t),
//   (g + 8, 2t + 1); g = lane / 4, t = lane % 4), and the A fragment of a
//   16-deep step is the mma.sync m16n8k16 one. So the C tiles of two
//   adjacent 8-column groups, rounded to bf16 pairwise, are the A fragment
//   of one step of the next product (pack_a): P and dS never leave the
//   registers.
// - Shared tiles: [rows][D] bf16 with 128-byte rows (D = 64) or 64-byte rows
//   (D = 32), swizzled as bf16_mma.cuh's swb, which on a tile aligned to
//   1024 (512) bytes is the hardware's 128-byte (64-byte) swizzle; at
//   D = 128 a tile is two [rows][64] halves, each a column of 128-byte
//   atoms. Every tile starts on a 1024-byte boundary (the dynamic shared
//   memory is declared so aligned, smem_base checks it, and tile sizes are
//   multiples of 1024 bytes).
// - Descriptors (make_desc): start address >> 4, leading and stride byte
//   offsets >> 4, the swizzle mode in bits 62-63 (1: 128-byte, 2: 64-byte).
//   K-major (desc_k: the contracted axis along a tile's rows, as K in
//   S = Q K^T): stride byte offset = 8 rows; a 16-deep step starts 32
//   bytes further along the swizzled row. MN-major (desc_mn, transposed,
//   as V in O = P V): the k rows of a step are 16 tile rows, 8 rows apart
//   by the stride byte offset; N never exceeds one atom column (64 at
//   D = 128 is one half, issued as its own product), so the offset between
//   atom columns is never read, and both offsets carry the 8-row stride.
// - Ordering: wgmma_fence before the products that follow register writes
//   (the accumulators rescaled, the A fragments packed), commit, then
//   wgmma_wait<0> before the accumulators are read; fence_regs keeps the
//   compiler from touching them between. Tiles written by cp.async or by
//   ordinary stores (the q fold) are published to the products, which read
//   through the async proxy, by fence_proxy_async before the block barrier.
//
// Everything here has internal linkage, as in tf32_mma.cuh.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"   // bf16, swb, pack_bf16x2, fold2
#include "tf32_mma.cuh"   // cp.async

namespace mx_wg {
namespace {

using namespace mx_bf;
using mx_tc::cp_async16;
using mx_tc::cp_async4;
using mx_tc::cp_async_commit;

constexpr int kWGThreads = 128;   // threads of a warpgroup
constexpr int kWGRows = 64;       // rows a warpgroup owns
constexpr int kSmemAlign = 1024;  // the 128-byte swizzle's atom

// bytes of a swizzled row, and of an 8-row atom
template <int D>
__host__ __device__ constexpr int row_bytes() { return D == 32 ? 64 : 128; }

// element (r, c) of an [R][D] staged tile; at D = 128 two [R][64] halves
template <int D, int R>
__device__ __forceinline__ int tile_off(int r, int c) {
  if constexpr (D == 128)
    return (c >> 6) * R * 64 + swb<64>(r, c & 63);
  else
    return swb<D>(r, c);
}

// the dynamic shared memory, declared __align__(kSmemAlign): the tiles'
// swizzle is the hardware's only from an aligned start, so a start that is
// not aligned traps rather than compute wrong products
__device__ __forceinline__ bf16* smem_base(unsigned char* raw) {
  if (static_cast<unsigned>(__cvta_generic_to_shared(raw)) % kSmemAlign)
    __trap();
  return reinterpret_cast<bf16*>(raw);
}

__device__ __forceinline__ uint64_t make_desc(const bf16* p, int lbo, int sbo,
                                              int row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(row == 128 ? 1 : 2) << 62;
}

// K-major operand: rows [r0, r0 + M or N) of an [R][D] tile, contracted
// over columns [c0, c0 + 16) (r0 a multiple of 8, c0 of 16)
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int c0) {
  constexpr int kRow = row_bytes<D>();
  const bf16* p = tile + tile_off<D, R>(r0, c0 & ~(kRow / 2 - 1)) +
                  (c0 & (kRow / 2 - 1));
  return make_desc(p, 16, 8 * kRow, kRow);
}

// MN-major operand: contracted over rows [r0, r0 + 16) of an [R][D] tile,
// columns [c0, c0 + N) with N within one atom column (r0 a multiple of
// 16, c0 of 64)
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int r0,
                                            int c0) {
  constexpr int kRow = row_bytes<D>();
  return make_desc(tile + tile_off<D, R>(r0, c0), 8 * kRow, 8 * kRow, kRow);
}

// --- PTX: wgmma, fences, cp.async waits --------------------------------------

#define MX_WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MX_WG_D16(i) MX_WG_D4(i), MX_WG_D4(i + 4), MX_WG_D4(i + 8), \
    MX_WG_D4(i + 12)

// d = a b (scale_d == 0) or d += a b, m64nNk16: a from registers, b from
// shared memory (kTransB: 0 K-major, 1 MN-major)
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : MX_WG_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : MX_WG_D16(0), MX_WG_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : MX_WG_D16(0), MX_WG_D16(16), MX_WG_D16(32), MX_WG_D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d), "n"(kTransB));
  }
}

// as wgmma_rs with a from shared memory (K-major)
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : MX_WG_D16(0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : MX_WG_D16(0), MX_WG_D16(16)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : MX_WG_D16(0), MX_WG_D16(16), MX_WG_D16(32), MX_WG_D16(48)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
}

#undef MX_WG_D16
#undef MX_WG_D4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// registers an asynchronous product reads or writes stay where they are
// until here (after wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]),
                 "+r"(r[i][3]) :: "memory");
}

// this thread's writes to shared memory, visible to the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// until at most N committed cp.async groups of the thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// --- end of PTX -------------------------------------------------------------

// the C tiles of columns [8k, 8k + 16) of a step (c = &d[8k]), rounded to
// bf16, as that step's A fragment
__device__ __forceinline__ void pack_a(const float* c, uint32_t (&a)[4]) {
  pack_bf16x2(a[0], c[0], c[1]);
  pack_bf16x2(a[1], c[2], c[3]);
  pack_bf16x2(a[2], c[4], c[5]);
  pack_bf16x2(a[3], c[6], c[7]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// cp.async rows [r0, r0 + R) of a [n, D] bf16 matrix into an [R][D] tile,
// zeros from row r_end on, by the block's kTh threads
template <int D, int R, int kTh>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int r0,
                                           int r_end) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % kTh == 0, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < R * kChunks / kTh; ++it) {
    const int i = threadIdx.x + it * kTh;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r0 + r < r_end;
    cp_async16(reinterpret_cast<float*>(dst + tile_off<D, R>(r, c)),
               reinterpret_cast<const float*>(
                   src + static_cast<size_t>(ok ? r0 + r : 0) * D + c),
               ok);
  }
}

// fold sm_scale into the chunks of a tile this thread staged with
// stage_tile, once they have landed: no barrier of its own
template <int D, int R, int kTh>
__device__ __forceinline__ void fold_own(bf16* tile, float sm_scale) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < R * kChunks / kTh; ++it) {
    const int i = threadIdx.x + it * kTh;
    uint4* p = reinterpret_cast<uint4*>(
        tile + tile_off<D, R>(i / kChunks, (i % kChunks) * 8));
    uint4 w = *p;
    w.x = fold2(w.x, sm_scale);
    w.y = fold2(w.y, sm_scale);
    w.z = fold2(w.z, sm_scale);
    w.w = fold2(w.w, sm_scale);
    *p = w;
  }
}

}  // namespace
}  // namespace mx_wg
