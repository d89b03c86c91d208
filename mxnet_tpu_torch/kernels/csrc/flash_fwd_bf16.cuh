// The flash-attention forward body in bf16 on the tensor cores, for Hopper
// (sm_90a): one kernel, `template <int D, bool kOffs>`, one block per 64
// query rows of one (b, h) walking the whole key axis. Two libraries
// instantiate it beside the float32 body (flash_fwd.cuh), each with its own
// C entry: flash_fwd.cu (TPU kernel _flash_fwd_kernel, #5; no offsets) and
// flash_fwd_offs.cu (_flash_fwd_offs_kernel, #1; offsets read on the
// device). The split-KV grid kernels (#6, #3) stay float32.
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
// Rows with no visible key get out = 0 and lse = -1e30 exactly.
//
// Bound on one H100 SXM: operations 4 * B * H * sum_rows(visible keys) * D
// (QK^T and PV) at the 989 TFLOP/s dense bf16 rate; bytes q, k, v and out
// in bf16 and lse in float32, once each, at 3.35 TB/s. At (8, 8, 512, 64)
// causal that is 2.15 GFLOP, 0.0022 ms, against 0.0052 ms of bytes: a
// bytes-bound shape at this size. The serving shapes (q (1, 8, 256, 64)
// on 512 keys) are latency bound: 32 blocks for 132 SMs.
//
// What the design does (bf16_mma.cuh):
// - Products: one mma.sync.m16n8k16 bf16 product a 16 x 8 x 16 step; no
//   split, the operands are the reference's bf16 values.
// - Q is staged once, sm_scale folded in place and rounded to bf16 (the
//   reference's folded q), then held as A fragments in registers at D <=
//   64 or read from shared memory each tile at D = 128.
// - Per key tile (64 keys; 32 at D = 128): S = Q K^T, scores to log2
//   units, the online softmax on the accumulator registers (row max over
//   the thread quad by __shfl_xor_sync), then P V with P rounded to bf16
//   straight from the accumulators: two adjacent 8-key C tiles are one
//   16-deep A fragment. Each tile's P V is summed from zero and folded
//   into O as O * alpha + PV_t with one float32 fma.
// - Staging: q once, then K and V double-buffered with 16-byte cp.async
//   into swizzled rows, zero-filled past the valid keys; tile t + 1 loads
//   while tile t computes. 40 KB of dynamic shared memory at D = 64.
// - Masks as in the float32 body: tiles wholly visible skip the mask, a
//   masked score becomes -1e30, whose exp2 is exactly 0; tiles past the
//   causal frontier of the block's last row are never loaded; causal
//   blocks launch heaviest first. A block owns its rows: no atomics, and
//   two calls give identical bits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"      // bf16 mma.sync, fragments, staging
#include "flash_split.cuh"   // kNeg

namespace mx_flash_bf16 {
// Internal linkage, as flash_fwd.cuh's body.
namespace {

using namespace mx_bf;
using mx_flash::kNeg;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Q's A fragments live in registers at D <= 64
template <int D>
__host__ __device__ constexpr bool q_in_regs_bf() { return D <= 64; }

// q, and two stages of K and V
template <int D>
constexpr size_t fwd_bf16_smem_bytes() {
  return sizeof(bf16) * (kRows * D + 4 * tile_rows<D>() * D);
}

template <int D, bool kOffs>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ offs, bf16* __restrict__ out,
                      float* __restrict__ lse, int sq, int sk,
                      float sm_scale, int causal) {
  constexpr int kT = tile_rows<D>();
  constexpr int kNT = kT / 8;    // 8-key groups of a tile
  constexpr int kKT = kT / 16;   // 16-key steps of a tile
  constexpr int kND = D / 8;     // 8-column groups of a row
  constexpr int kKD = D / 16;    // 16-column steps of a row
  constexpr bool kQReg = q_in_regs_bf<D>();
  extern __shared__ __align__(16) float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [kRows][D]
  bf16* kvs = qs + kRows * D;                 // [2][k, v][kT][D]

  const int bh = blockIdx.x;
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = rb * kRows;
  const int q_base = kOffs ? offs[0] : 0;
  const int k_base = kOffs ? offs[1] : 0;
  const int last_q = q_base + min(q0 + kRows, sq) - 1;
  // keys [0, k_hi) are seen by some row of the block
  const int k_hi = causal ? min(sk, last_q - k_base + 1) : sk;
  const int n_t = k_hi > 0 ? (k_hi + kT - 1) / kT : 0;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wr = warp * 16;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const int q_pos[2] = {q_base + q0 + wr + g, q_base + q0 + wr + g + 8};

  float acc[kND][4];   // O, unnormalized
  zero(acc);
  float m[2] = {kNeg, kNeg};   // row max of the scores (log2 units)
  float l[2] = {0.f, 0.f};     // the thread's share of the row sums

  if (n_t > 0) {
    const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
    const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
    stage_bf<D, kRows>(qs, q + qoff * D, q0, sq);
    stage_bf<D, kT>(kvs, kb, 0, sk);
    stage_bf<D, kT>(kvs + kT * D, vb, 0, sk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    fold_tile<D, kRows>(qs, sm_scale);
    __syncthreads();
    uint32_t qa[kQReg ? kKD : 1][4];
    if constexpr (kQReg) {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        load_a_bf<D>(qs, wr, kk * 16, g, t, qa[kk]);
    }

    for (int it = 0; it < n_t; ++it) {
      const int kt0 = it * kT;
      const bf16* ks = kvs + (it & 1) * 2 * kT * D;
      const bf16* vs = ks + kT * D;
      cp_async_wait_all();
      __syncthreads();   // tile it landed; tile it - 1's reads are done
      if (it + 1 < n_t) {
        bf16* nk = kvs + ((it + 1) & 1) * 2 * kT * D;
        stage_bf<D, kT>(nk, kb, kt0 + kT, sk);
        stage_bf<D, kT>(nk + kT * D, vb, kt0 + kT, sk);
        cp_async_commit();
      }

      // S = Q K^T
      float s[kNT][4];
      zero(s);
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        uint32_t a[4];
        if constexpr (kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        } else {
          load_a_bf<D>(qs, wr, kk * 16, g, t, a);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b[2];
          load_b_rows<D>(ks, j * 8, kk * 16, g, t, b);
          mma_bf16(s[j], a, b);
        }
      }

      // to log2 units; a tile wholly inside the keys and seen by every
      // row of the block needs no mask
      const bool masked = kt0 + kT > sk ||
                          (causal && k_base + kt0 + kT - 1 > q_base + q0);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= kLog2e;
          if (masked) {
            const int kj = kt0 + j * 8 + 2 * t + (e & 1);
            if (!(kj < sk && (!causal || q_pos[e >> 1] >= k_base + kj)))
              s[j][e] = kNeg;
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
          mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_safe[h] = mx > kNeg / 2 ? mx : 0.f;
        alpha[h] = exp2f(m[h] - m_safe[h]);
        m[h] = mx;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m_safe[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = p;
        }

      // PV_t with P rounded to bf16, summed from zero; O = O * alpha + PV_t
      float part[kND][4];
      zero(part);
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) {
        uint32_t a[4];
        acc_to_a_bf(s[2 * jj], s[2 * jj + 1], a);
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          uint32_t b[2];
          load_b_cols<D>(vs, jj * 16, n * 8, g, t, b);
          mma_bf16(part[n], a, b);
        }
      }
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], part[n][e]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = q0 + wr + g + 8 * h;
    if (i >= sq) continue;
    const float denom = lr > 0.f ? lr : 1.f;
    bf16* o = out + (qoff + i) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      store2(o + n * 8, acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (t == 0) lse[qoff + i] = lr > 0.f ? m[h] * kLn2 + logf(lr) : kNeg;
  }
}

// The kernel with its dynamic shared memory allowed (the attribute set
// once per instantiation, before any graph capture). Returns the CUDA
// error of the launch.
template <int D, bool kOffs>
int launch_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const int* offs, bf16* out, float* lse, int bh, int sq,
                    int sk, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_bf16_smem_bytes<D>();
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, kOffs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kRows - 1) / kRows);
  flash_fwd_bf16_kernel<D, kOffs><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, out, lse, sq, sk, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mx_flash_bf16
