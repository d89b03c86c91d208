// The flash-attention forward body in bf16 on Hopper's warpgroup tensor
// cores (sm_90a): one kernel, `template <int D, bool kOffs>`, over splits
// of the key axis (blockIdx.z; w keys each), as the float32 body
// (flash_fwd.cuh). Four libraries instantiate it beside the float32 body,
// each with its own C entries:
// - flash_fwd.cu (TPU kernel _flash_fwd_kernel, #5; no offsets) and
//   flash_fwd_offs.cu (_flash_fwd_offs_kernel, #1; offsets read on the
//   device): one split over the whole key axis, bf16 out;
// - flash_fwd_grid.cu (_flash_fwd_grid_kernel, #6) and
//   flash_fwd_offs_grid.cu (_flash_fwd_offs_grid_kernel, #3): the JAX
//   call's splits, float32 partials into a workspace that the combine pass
//   of flash_fwd_grid.cuh merges and rounds to bf16 once.
//
// Function, with the roundings of the reference kernel
// (mxnet_tpu/kernels/flash_attention.py:205 and :285 on bf16 inputs; query
// row i at global position q0 + i, key j at k0 + j, [q0, k0] = offs[0..1]
// when kOffs, else [0, 0]; under `causal` a key is visible iff its
// position <= the query's):
//   qs_i   = bf16(q_i * sm_scale)                 (_fold_scale)
//   s_ij   = qs_i . k_j, float32 sums of exact bf16 products
//   online softmax over key tiles in float32: m the running row max,
//   p_ij   = exp(s_ij - m), l = sum p (float32, unrounded)
//   O     += bf16(p_ij) v_j, float32 sums            (p.astype(v.dtype))
//   out_i  = bf16(O_i / l_i),  lse_i = m_i + log l_i (float32)
// over the keys of the block's split. Rows with no visible key get out = 0
// and lse = -1e30 exactly. With n_split > 1 the block writes its split's
// normalized partial O_i / l_i unrounded, in float32, and its lse into slot
// `split` of the workspace [n_split, bh, sq, D] / [n_split, bh, sq] (the
// reference carries acc, m and l in float32 scratch across its key blocks
// and rounds once, at the last); a split that no row of the block can see
// is dead and the block returns before loading anything (flash_split.cuh).
//
// Bound on one H100 SXM: operations 4 * B * H * sum_rows(visible keys) * D
// (QK^T and PV) at the 989 TFLOP/s dense bf16 rate; bytes q, k, v and out
// in bf16 and lse in float32, once each, at 3.35 TB/s. At (8, 8, 512, 64)
// causal that is 2.15 GFLOP, 0.0022 ms, against 0.0052 ms of bytes: a
// bytes-bound shape at this size. The serving shapes (q (1, 8, 256, 64)
// on 512 keys) are latency bound: 32 blocks for 132 SMs. At the long
// training shape (4, 8, 4096, 64) causal, 8 splits, 0.069 ms of operations
// (plus the float32 workspace's bytes): operation bound.
//
// What the design does (bf16_wgmma.cuh):
// - Products: wgmma.mma_async m64nNk16, one warpgroup for 64 query rows.
//   S = qs K^T reads both operands from shared memory (K K-major); P is
//   rounded to bf16 straight from S's accumulators into A fragments, and
//   O += P V reads V transposed (MN-major) from shared memory. O is
//   rescaled by the online softmax's alpha in its registers before each
//   tile's product adds to it.
// - Block: one warpgroup and its 64 query rows, so at D = 64 four blocks
//   run on an SM (~120 registers a thread, 56 KB of shared memory), each
//   on its own schedule: one block's softmax overlaps another's products.
//   (Two warpgroups sharing each staged tile measured slower: PERF.md.)
// - Tiles of 64 keys in a ring of kStages = 3 stages: tile it + 2 loads
//   while tile it computes, waited on with cp.async.wait_group 1. q is
//   staged with the first tile and folded (sm_scale, rounded to bf16) in
//   place by the threads that copied it, before the first barrier.
// - Masks as in the float32 body: tiles wholly visible skip the mask, a
//   masked score becomes -1e30, whose exp2 is exactly 0; tiles past the
//   causal frontier of the block's last row are never loaded; a split
//   range that is not a multiple of the tile is masked at its end; causal
//   blocks launch heaviest first. A block owns its rows: no atomics, and
//   two calls give identical bits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"    // wgmma, descriptors, staging
#include "flash_split.cuh"   // the split geometry, kNeg

namespace mx_flash_bf16 {
// Internal linkage, as flash_fwd.cuh's body.
namespace {

using namespace mx_wg;
using mx_flash::kNeg;
using mx_flash::live_kv_splits;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kStages = 3;   // K/V ring

// keys of a walked tile
constexpr int kFwdTile = 64;

// q, and the ring of K and V tiles
template <int D>
constexpr size_t fwd_bf16_smem_bytes() {
  return sizeof(bf16) * (kWGRows * D + kStages * 2 * kFwdTile * D);
}

// One block: 64 query rows of (b, h) = blockIdx.x, key split
// blockIdx.z of width w (n_split == 1: w >= sk, the final bf16 out and lse
// into out and lse; else the float32 partial into out_part and lse).
template <int D, bool kOffs>
__global__ void __launch_bounds__(kWGThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ offs, bf16* __restrict__ out,
                      float* __restrict__ out_part, float* __restrict__ lse,
                      int sq, int sk, int w, int n_split, float sm_scale,
                      int causal) {
  constexpr int kR = kWGRows;   // query rows of the block
  constexpr int kTh = kWGThreads;
  constexpr int kT = kFwdTile;
  constexpr int kNT = kT / 8;    // 8-key groups of a tile
  constexpr int kKT = kT / 16;   // 16-key steps of a tile
  constexpr int kND = D / 8;     // 8-column groups of a row
  constexpr int kKD = D / 16;    // 16-column steps of a row
  extern __shared__ __align__(1024) unsigned char mx_smem[];
  bf16* qs = smem_base(mx_smem);   // [kR][D]
  bf16* kvs = qs + kR * D;         // [kStages][k, v][kT][D]

  const int bh = blockIdx.x;
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int q0 = rb * kR;
  const int q_base = kOffs ? offs[0] : 0;
  const int k_base = kOffs ? offs[1] : 0;
  const int last_q = q_base + min(q0 + kR, sq) - 1;
  if (!direct &&
      split >= live_kv_splits(last_q, k_base, w, n_split, causal))
    return;   // dead: no row of the block sees a key of this split

  // keys [k_lo, k_end) of the split, [k_lo, k_hi) seen by some row
  const int k_lo = split * w;
  const int k_end = min(k_lo + w, sk);
  const int k_hi = causal ? min(k_end, last_q - k_base + 1) : k_end;
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + kT - 1) / kT : 0;

  // the warp's 16 rows from block row wr
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const int q_pos[2] = {q_base + q0 + wr + g, q_base + q0 + wr + g + 8};

  float acc[D / 2];   // O, unnormalized
  zero(acc);
  float m[2] = {kNeg, kNeg};   // row max of the scores (log2 units)
  float l[2] = {0.f, 0.f};     // the thread's share of the row sums

  if (n_t > 0) {
    const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
    const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
    // one cp.async group a tile (empty past the last)
    auto stage_kv = [&](int it) {
      if (it < n_t) {
        bf16* dst = kvs + (it % kStages) * 2 * kT * D;
        stage_tile<D, kT, kTh>(dst, kb, k_lo + it * kT, k_end);
        stage_tile<D, kT, kTh>(dst + kT * D, vb, k_lo + it * kT, k_end);
      }
      cp_async_commit();
    };
    stage_tile<D, kR, kTh>(qs, q + qoff * D, q0, sq);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) stage_kv(st);

    for (int it = 0; it < n_t; ++it) {
      const int kt0 = k_lo + it * kT;
      const bf16* ks = kvs + (it % kStages) * 2 * kT * D;
      const bf16* vs = ks + kT * D;
      cp_async_wait<kStages - 2>();   // this thread's copies of tile it
      if (it == 0) fold_own<D, kR, kTh>(qs, sm_scale);
      fence_proxy_async();
      __syncthreads();   // tile it landed; tile it - 1's products are done
      stage_kv(it + kStages - 1);

      // S = qs K^T
      float s[kT / 2];
      zero(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        wgmma_ss<kT, 0>(s, desc_k<D, kR>(qs, 0, kk * 16),
                        desc_k<D, kT>(ks, 0, kk * 16), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // to log2 units; a tile wholly inside the split and seen by every
      // row of the block needs no mask
      const bool masked = kt0 + kT > k_end ||
                          (causal && k_base + kt0 + kT - 1 > q_base + q0);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[4 * j + e];
          x *= kLog2e;
          if (masked) {
            const int kj = kt0 + j * 8 + 2 * t + (e & 1);
            if (!(kj < k_end && (!causal || q_pos[e >> 1] >= k_base + kj)))
              x = kNeg;
          }
        }

      // online softmax; a row that has seen no key keeps m = -1e30, and
      // the safe maximum 0 makes exp2 of a masked score exactly 0 for it
      float alpha[2], m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_safe[h] = mx > kNeg / 2 ? mx : 0.f;
        alpha[h] = exp2f(m[h] - m_safe[h]);
        m[h] = mx;
        l[h] *= alpha[h];
      }
      uint32_t pa[kKT][4];   // P rounded to bf16, as A fragments
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * j + e] - m_safe[e >> 1]);
          l[e >> 1] += p;
          s[4 * j + e] = p;
        }
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) pack_a(s + 8 * jj, pa[jj]);

      // O = O * alpha + P V
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) {
        if constexpr (D == 128) {
          wgmma_rs<64, 1>(*reinterpret_cast<float(*)[32]>(acc), pa[jj],
                          desc_mn<D, kT>(vs, jj * 16, 0), 1);
          wgmma_rs<64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32), pa[jj],
                          desc_mn<D, kT>(vs, jj * 16, 64), 1);
        } else {
          wgmma_rs<D, 1>(acc, pa[jj], desc_mn<D, kT>(vs, jj * 16, 0), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pa);
    }
  }

  // direct: the final (out, lse); else this split's slot of the workspace
  const size_t base = direct ? 0 : static_cast<size_t>(split) * gridDim.x * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = q0 + wr + g + 8 * h;
    if (i >= sq) continue;
    const float denom = lr > 0.f ? lr : 1.f;
    if (direct) {
      bf16* o = out + (qoff + i) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kND; ++n)
        store2(o + n * 8, acc[4 * n + 2 * h] / denom,
               acc[4 * n + 2 * h + 1] / denom);
    } else {
      float* o = out_part + (base + qoff + i) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kND; ++n)
        *reinterpret_cast<float2*>(o + n * 8) = make_float2(
            acc[4 * n + 2 * h] / denom, acc[4 * n + 2 * h + 1] / denom);
    }
    if (t == 0)
      lse[base + qoff + i] = lr > 0.f ? m[h] * kLn2 + logf(lr) : kNeg;
  }
}

// The kernel with its dynamic shared memory allowed (the attribute set
// once per instantiation, before any graph capture). out: the bf16 output
// (n_split == 1); out_part: the float32 workspace (n_split > 1). Returns
// the CUDA error of the launch.
template <int D, bool kOffs>
int launch_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const int* offs, bf16* out, float* out_part, float* lse,
                    int bh, int sq, int sk, int w, int n_split,
                    float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_bf16_smem_bytes<D>();
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, kOffs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kWGRows - 1) / kWGRows, n_split);
  flash_fwd_bf16_kernel<D, kOffs><<<grid, kWGThreads, smem, stream>>>(
      q, k, v, offs, out, out_part, lse, sq, sk, w, n_split, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mx_flash_bf16
