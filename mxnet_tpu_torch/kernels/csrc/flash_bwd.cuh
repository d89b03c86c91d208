// Helpers of the flash-attention backward kernels, float32, for Hopper
// (sm_90a), shared by flash_bwd_offs.cu (TPU kernels
// _flash_bwd_dq_offs_kernel / _flash_bwd_dkv_offs_kernel) and
// flash_bwd_grid.cu (_flash_bwd_dq_grid_kernel / _flash_bwd_dkv_grid_kernel):
// the block layout (256 threads, eight to a row, 32 owned rows, 32-row
// walked tiles), the shared-memory budgets, the staging of rows into padded
// shared rows and the paired four-row dot products. Each .cu defines its own
// kernels and C entries.
#pragma once
#include <cuda_runtime.h>

namespace mx_flash_bwd {

constexpr int kRowThreads = 8;                  // threads sharing one row
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kRowThreads;   // rows a block owns: 32
constexpr int kTile = 32;                       // rows of a walked tile
constexpr int kPerThread = kTile / kRowThreads;  // scores a thread computes
constexpr int kPStride = kTile + 4;             // padded P/dS row (floats)
constexpr float kNeg = -1e30f;

template <int D>
__host__ __device__ constexpr int stride() { return D + 4; }  // padded row

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kRows * stride<D>() + 2 * kTile * stride<D>() +
                          kRows * kPStride);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kRows * stride<D>() + 2 * kTile * stride<D>() +
                          2 * kRows * kPStride + 2 * kTile);
}

// rows [r0, r0 + kRows) of a [n, D] matrix into shared memory (padded rows),
// multiplied by `scale`, zeros past n
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, float scale) {
  constexpr int kStride = stride<D>();
  for (int i = threadIdx.x; i < kRows * D / 4; i += kThreads) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) {
      t = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * D + c);
      t.x *= scale;
      t.y *= scale;
      t.z *= scale;
      t.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * kStride + c) = t;
  }
}

// two rows of length D dotted against four rows each: s[j] += a . b_j and
// dp[j] += c . d_j, where b_j, d_j are rows lane + 8 j of shared tiles
template <int D>
__device__ __forceinline__ void dot4x2(const float* a, const float* b,
                                       const float* c, const float* dd,
                                       int lane, float* s, float* dp) {
  constexpr int kStride = stride<D>();
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 aa = *reinterpret_cast<const float4*>(a + d);
    const float4 cc = *reinterpret_cast<const float4*>(c + d);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int r = (lane + kRowThreads * j) * kStride + d;
      const float4 bb = *reinterpret_cast<const float4*>(b + r);
      const float4 ee = *reinterpret_cast<const float4*>(dd + r);
      s[j] = fmaf(aa.x, bb.x, s[j]);
      s[j] = fmaf(aa.y, bb.y, s[j]);
      s[j] = fmaf(aa.z, bb.z, s[j]);
      s[j] = fmaf(aa.w, bb.w, s[j]);
      dp[j] = fmaf(cc.x, ee.x, dp[j]);
      dp[j] = fmaf(cc.y, ee.y, dp[j]);
      dp[j] = fmaf(cc.z, ee.z, dp[j]);
      dp[j] = fmaf(cc.w, ee.w, dp[j]);
    }
  }
}

}  // namespace mx_flash_bwd
