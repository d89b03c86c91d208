// The flash-attention forward body, float32 on the tensor cores, for Hopper
// (sm_90a): one kernel, `template <int D, bool kOffs>`, over splits of the
// key axis (blockIdx.z; w keys each). Four libraries instantiate it, each
// with its own C entry:
// - flash_fwd.cu (TPU kernel _flash_fwd_kernel, #5): no offsets, one split
//   over the whole key axis;
// - flash_fwd_offs.cu (_flash_fwd_offs_kernel, #1): offsets, one split;
// - flash_fwd_grid.cu (_flash_fwd_grid_kernel, #6) and
//   flash_fwd_offs_grid.cu (_flash_fwd_offs_grid_kernel, #3): the JAX
//   call's splits, partials into a workspace that the combine pass of
//   flash_fwd_grid.cuh merges.
//
// Function (query row i at global position q0 + i and key j at k0 + j,
// [q0, k0] = offs[0..1] when kOffs, else [0, 0]; under `causal` a key is
// visible iff its position <= the query's):
//   out[b,h,i,:] = softmax_j(s_ij) v[b,h,j,:],  s_ij = (q_i * sm_scale) . k_j
//   lse[b,h,i]   = logsumexp_j s_ij
// over the keys of the block's split (all keys with one split). Rows with
// no visible key get out = 0 and lse = -1e30 exactly (the offset kernels'
// contract; without offsets and with one split no row has none). With
// n_split > 1 the block writes its split's normalized partial (out_s,
// lse_s) into slot `split` of the workspace [n_split, bh, sq, D] /
// [n_split, bh, sq]; a split that no row of the block can see is dead and
// the block returns before loading anything (the combine never reads it,
// flash_split.cuh).
//
// Bound on one H100 SXM: float32-accurate products on the tensor cores
// cost three TF32 products each, so operations are 3 * 4 * B * H *
// sum_rows(visible keys) * D (QK^T and PV) at the 495 TFLOP/s dense TF32
// rate; bytes are q, k, v, out and lse once at 3.35 TB/s, plus the
// workspace with splits. At (8, 8, 512, 64) causal that is 0.0130 ms, at
// (4, 8, 4096, 64) causal 0.417 ms: operation bound. The serving shapes
// (q (1, 8, 256, 64) on 512 keys) are latency bound: 32 blocks for 132
// SMs.
//
// What the design does:
// - Products: 3xTF32 mma.sync.m16n8k8 (tf32_mma.cuh). Q is used for every
//   key tile, so it is split into hi and lo once a block, with sm_scale *
//   log2e folded in first (the scores come out in log2 units): in
//   registers at D <= 64, as hi and lo planes in shared memory at D = 128
//   (its 16 x 128 output a warp leaves no registers for Q). K and V are
//   split at their fragment loads, P (in [0, 1]) when it becomes an A
//   fragment: one TF32 rounding of P alone would miss the 1e-4 gate.
// - Blocking: a block of 4 warps owns 64 query rows of one (b, h), 16 a
//   warp, and walks its split's keys in tiles of tile_rows<D>() (64; 32 at
//   D = 128). Per tile: S = Q K^T on the tensor cores; the online softmax
//   on the accumulator registers (the row max over the thread quad by
//   __shfl_xor_sync 1 and 2, p = exp2(s - m), the row sum kept per thread
//   and summed over the quad once at the end); then P V with P straight
//   from the accumulators as A fragments, in the permuted order of the
//   contracted axis (acc_to_a, load_bp).
// - Per-tile sums: the tensor cores round their float32 sums toward zero,
//   so each tile's P V is summed from zero and folded into O as O * alpha
//   + PV_t with one float32 fma; the online softmax needs that rescale
//   anyway.
// - Staging: q once, then K and V double-buffered with 16-byte cp.async
//   into XOR-swizzled rows, zero-filled past the valid keys (no NaN
//   enters an MMA): tile t + 1 loads while tile t computes, one
//   __syncthreads a tile. Dynamic shared memory, 40 KB at D = 32, 80 KB at
//   D = 64 (two blocks an SM), 128 KB at D = 128.
// - Masks: tiles wholly visible skip the mask; in tiles across the
//   diagonal or the split's end a masked score becomes -1e30, whose exp2
//   is exactly 0; tiles past the causal frontier of the block's last row
//   are never loaded. A split range that is not a multiple of the tile is
//   masked at its end. Causal blocks launch heaviest first (the last query
//   rows see the most keys). A block owns its rows: no atomics, and two
//   calls give identical bits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_split.cuh"   // the split geometry, kNeg
#include "tf32_mma.cuh"      // 3xTF32 mma.sync, cp.async staging

namespace mx_flash {
// Internal linkage: four libraries of one process instantiate this body,
// two of them with the same template arguments (flash_fwd.cu and
// flash_fwd_grid.cu), and a launcher's function-local static (the
// shared-memory attribute) must stay each library's own.
namespace {

using namespace mx_tc;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Q split once a block into registers (D <= 64), else into shared planes
template <int D>
__host__ __device__ constexpr bool q_in_regs() { return D <= 64; }

// q (or its hi and lo planes) and two stages of K and V
template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((q_in_regs<D>() ? 1 : 2) * kRows * D +
                          4 * tile_rows<D>() * D);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 8) of a shared tile,
// times c, split into hi and lo
template <int D>
__device__ __forceinline__ void load_a_scaled(const float* s, int r0, int c0,
                                              int g, int t, float c,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_tf32(s[sw<D>(r0 + g, c0 + t)] * c, hi[0], lo[0]);
  split_tf32(s[sw<D>(r0 + g + 8, c0 + t)] * c, hi[1], lo[1]);
  split_tf32(s[sw<D>(r0 + g, c0 + t + 4)] * c, hi[2], lo[2]);
  split_tf32(s[sw<D>(r0 + g + 8, c0 + t + 4)] * c, hi[3], lo[3]);
}

// The same fragment from hi and lo planes split beforehand
template <int D>
__device__ __forceinline__ void load_a_planes(const float* hs, const float* ls,
                                              int r0, int c0, int g, int t,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  const int idx[4] = {sw<D>(r0 + g, c0 + t), sw<D>(r0 + g + 8, c0 + t),
                      sw<D>(r0 + g, c0 + t + 4),
                      sw<D>(r0 + g + 8, c0 + t + 4)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = __float_as_uint(hs[idx[e]]);
    lo[e] = __float_as_uint(ls[idx[e]]);
  }
}

// One block: 64 query rows of (b, h) = blockIdx.x, key split blockIdx.z of
// width w (n_split == 1: w >= sk, the final out and lse).
template <int D, bool kOffs>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ offs,
                 float* __restrict__ out, float* __restrict__ lse, int sq,
                 int sk, int w, int n_split, float sm_scale, int causal) {
  constexpr int kT = tile_rows<D>();
  constexpr int kNT = kT / 8;   // 8-key groups of a tile
  constexpr int kND = D / 8;    // 8-column groups of a row
  constexpr bool kQReg = q_in_regs<D>();
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kRows][D]: q, then its hi plane
  float* qls = qs + kRows * D;      // [kRows][D]: q's lo plane (D = 128)
  float* kvs = smem + (kQReg ? 1 : 2) * kRows * D;   // [2][k, v][kT][D]

  const int bh = blockIdx.x;
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int q0 = rb * kRows;
  // offsets read on the device: a prefill chunk at a new start costs no
  // host round trip
  const int q_base = kOffs ? offs[0] : 0;
  const int k_base = kOffs ? offs[1] : 0;
  const int last_q = q_base + min(q0 + kRows, sq) - 1;
  if (!direct &&
      split >= live_kv_splits(last_q, k_base, w, n_split, causal))
    return;   // dead: no row of the block sees a key of this split

  // keys [k_lo, k_end) of the split, [k_lo, k_hi) seen by some row
  const int k_lo = split * w;
  const int k_end = min(k_lo + w, sk);
  const int k_hi = causal ? min(k_end, last_q - k_base + 1) : k_end;
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + kT - 1) / kT : 0;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wr = warp * 16;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  // the thread's rows wr + g and wr + g + 8
  const int q_pos[2] = {q_base + q0 + wr + g, q_base + q0 + wr + g + 8};

  float acc[kND][4];   // O, unnormalized
  zero(acc);
  float m[2] = {kNeg, kNeg};   // row max of the scores (log2 units)
  float l[2] = {0.f, 0.f};     // the thread's share of the row sums

  if (n_t > 0) {
    const float* kb = k + static_cast<size_t>(bh) * sk * D;
    const float* vb = v + static_cast<size_t>(bh) * sk * D;
    stage<D, kRows>(qs, q + qoff * D, q0, sq);
    stage<D, kT>(kvs, kb, k_lo, k_end);
    stage<D, kT>(kvs + kT * D, vb, k_lo, k_end);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // Q * sm_scale * log2e, split once
    const float qc = sm_scale * kLog2e;
    uint32_t qh[kQReg ? kND : 1][4], ql[kQReg ? kND : 1][4];
    if constexpr (kQReg) {
#pragma unroll
      for (int kk = 0; kk < kND; ++kk)
        load_a_scaled<D>(qs, wr, kk * 8, g, t, qc, qh[kk], ql[kk]);
    } else {
      // in place, element by element: the hi plane over q, the lo plane
      // beside it (the loop's first __syncthreads publishes them)
      for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
        uint32_t hi, lo;
        split_tf32(qs[i] * qc, hi, lo);
        qs[i] = __uint_as_float(hi);
        qls[i] = __uint_as_float(lo);
      }
    }

    for (int it = 0; it < n_t; ++it) {
      const int kt0 = k_lo + it * kT;
      const float* ks = kvs + (it & 1) * 2 * kT * D;
      const float* vs = ks + kT * D;
      cp_async_wait_all();
      __syncthreads();   // tile it landed; tile it - 1's reads are done
      if (it + 1 < n_t) {
        float* nk = kvs + ((it + 1) & 1) * 2 * kT * D;
        stage<D, kT>(nk, kb, kt0 + kT, k_end);
        stage<D, kT>(nk + kT * D, vb, kt0 + kT, k_end);
        cp_async_commit();
      }

      // S = Q K^T, in log2 units
      float s[kNT][4];
      zero(s);
#pragma unroll
      for (int kk = 0; kk < kND; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[kk][e];
            al[e] = ql[kk][e];
          }
        } else {
          load_a_planes<D>(qs, qls, wr, kk * 8, g, t, ah, al);
        }
#pragma unroll
        for (int j = 0; j < kNT; j += kGroup)
          mma_rows<D>(s + j, ah, al, ks, j * 8, kk * 8, g, t);
      }

      // a tile wholly inside the split and seen by every row of the block
      // needs no mask
      const bool masked = kt0 + kT > k_end ||
                          (causal && k_base + kt0 + kT - 1 > q_base + q0);
      if (masked) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = kt0 + j * 8 + 2 * t + (e & 1);
            if (!(kj < k_end && (!causal || q_pos[e >> 1] >= k_base + kj)))
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

      // PV_t summed from zero, then O = O * alpha + PV_t
      float part[kND][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ah[4], al[4];
        acc_to_a(s[j], ah, al);
#pragma unroll
        for (int n = 0; n < kND; n += kGroup)
          mma_cols<D>(part + n, ah, al, vs, j * 8, n * 8, g, t);
      }
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], part[n][e]);
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
    float* o = out + (base + qoff + i) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<float2*>(o + n * 8) =
          make_float2(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (t == 0)
      lse[base + qoff + i] = lr > 0.f ? m[h] * kLn2 + logf(lr) : kNeg;
  }
}

// The kernel with its dynamic shared memory allowed: the attribute is set
// once per instantiation (thread-safe static init), before any graph
// capture the caller may start. Returns the CUDA error of the launch.
template <int D, bool kOffs>
int launch_fwd(const float* q, const float* k, const float* v,
               const int* offs, float* out, float* lse, int bh, int sq,
               int sk, int w, int n_split, float sm_scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kOffs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kRows - 1) / kRows, n_split);
  flash_fwd_kernel<D, kOffs><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, out, lse, sq, sk, w, n_split, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mx_flash
