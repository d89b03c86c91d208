// The combine pass of the split-KV flash-attention forward, for Hopper
// (sm_90a), shared by flash_fwd_grid.cu (TPU kernel _flash_fwd_grid_kernel,
// no offsets) and flash_fwd_offs_grid.cu (TPU kernel
// _flash_fwd_offs_grid_kernel, global offsets read on the device). It
// reads a float32 workspace and writes out in float32 or, for the bf16
// bodies (flash_fwd_bf16.cuh), rounded to bf16 once (`TOut`); lse is
// float32 in both.
//
// What "grid" means here. On the TPU the grid variant makes the key axis a
// sequential grid dimension with VMEM scratch accumulators. Hopper has no
// sequential grid axis; what carries over is the key axis as a grid axis:
// split-KV (flash-decoding). Pass 1 is the forward body of flash_fwd.cuh
// over n_split = ceil(sk / w) key splits, w = the JAX call's block_k
// rounded up to the 32-key split unit: both depend on shapes and arguments
// only, so the result does not depend on occupancy or timing (serving's
// bit identity needs that). Each block writes its split's normalized
// partial (out_s, lse_s) to a float32 workspace [n_split, bh, sq, D] /
// [n_split, bh, sq] that the caller allocates; a split wholly past the
// causal frontier of the block's last row is dead and loads and writes
// nothing (prefill gathers the whole 4096-key table for every chunk, so
// most splits of an early chunk are dead). This pass merges, for each
// row, the splits that row can see, in split order, with merge_attention's
// maths (port of kernels/flash_attention.py:106):
//   M = max_s lse_s,  w_s = exp(lse_s - M_safe),  out = sum_s w_s out_s / L,
//   lse = M + log L  (L = sum_s w_s; L == 0 gives out 0 and lse -1e30).
// It reads only splits whose first key the row can see (live_kv_splits,
// flash_split.cuh), which every live block has written, so a dead split is
// never read and never yields exp(-1e30 - -1e30). No atomics:
// deterministic. With n_split == 1 pass 1 writes out and lse directly and
// this pass is not run.
//
// Bound on one H100 SXM: bytes, the live partials read once and out and
// lse written once at 3.35 TB/s. It runs on CUDA cores, 32 rows a block,
// eight threads to a row, each owning D/8 columns as float4s.
#pragma once
#include <cuda_runtime.h>

#include "bf16_mma.cuh"      // store4
#include "flash_split.cuh"

namespace mx_flash {
namespace {

constexpr int kRowThreads = 8;                          // threads to a row
constexpr int kCombineThreads = 256;
constexpr int kCombineRows = kCombineThreads / kRowThreads;   // 32

template <int D, bool kOffs, typename TOut>
__global__ void __launch_bounds__(kCombineThreads)
flash_fwd_grid_combine_kernel(const int* __restrict__ offs,
                              const float* __restrict__ out_part,
                              const float* __restrict__ lse_part,
                              TOut* __restrict__ out,
                              float* __restrict__ lse,
                              int sq, int w, int n_split, int causal) {
  constexpr int kChunks = D / (4 * kRowThreads);
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int lane = tid % kRowThreads;
  const int qi = blockIdx.x * kCombineRows + row;
  if (qi >= sq) return;
  const int q_base = kOffs ? offs[0] : 0;
  const int k_base = kOffs ? offs[1] : 0;
  const int n_live = live_kv_splits(q_base + qi, k_base, w, n_split, causal);
  const size_t r = static_cast<size_t>(blockIdx.y) * sq + qi;
  const size_t split_rows = static_cast<size_t>(gridDim.y) * sq;

  float m = kNeg;
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, lse_part[s * split_rows + r]);
  const float m_safe = m > kNeg / 2 ? m : 0.f;   // no live split: no nan
  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float l = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const size_t rs = s * split_rows + r;
    const float ws = expf(lse_part[rs] - m_safe);
    l += ws;
    const float* prow = out_part + rs * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float4 o = *reinterpret_cast<const float4*>(prow + 4 * kRowThreads * c);
      acc[c][0] = fmaf(ws, o.x, acc[c][0]);
      acc[c][1] = fmaf(ws, o.y, acc[c][1]);
      acc[c][2] = fmaf(ws, o.z, acc[c][2]);
      acc[c][3] = fmaf(ws, o.w, acc[c][3]);
    }
  }
  const float denom = l == 0.f ? 1.f : l;
  TOut* orow = out + r * D + 4 * lane;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    mx_bf::store4(orow + 4 * kRowThreads * c, acc[c][0] / denom,
                  acc[c][1] / denom, acc[c][2] / denom, acc[c][3] / denom);
  if (lane == 0) lse[r] = l > 0.f ? m_safe + logf(denom) : kNeg;
}

// Returns cudaGetLastError() of the launch. TOut: float, or mx_bf::bf16.
template <int D, bool kOffs, typename TOut>
int launch_fwd_grid_combine(const int* offs, const float* out_part,
                            const float* lse_part, TOut* out, float* lse,
                            int bh, int sq, int w, int n_split, int causal,
                            cudaStream_t stream) {
  const dim3 grid((sq + kCombineRows - 1) / kCombineRows, bh);
  flash_fwd_grid_combine_kernel<D, kOffs, TOut><<<grid, kCombineThreads, 0,
                                                  stream>>>(
      offs, out_part, lse_part, out, lse, sq, w, n_split, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mx_flash
