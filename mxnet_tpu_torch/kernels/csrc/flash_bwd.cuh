// The flash-attention backward body, float32 on the tensor cores, for Hopper
// (sm_90a): one dq kernel and one dk/dv kernel, `template <int D>`, over
// splits of the walked axis (blockIdx.z; w rows each). flash_bwd_grid.cu
// launches them over the JAX call's splits (TPU kernels
// _flash_bwd_dq_grid_kernel / _flash_bwd_dkv_grid_kernel, #4: unscaled dq
// partials or dk/dv partials into a workspace, or the final outputs with
// one split), flash_bwd_offs.cu with one split over the whole axis (TPU
// kernels _flash_bwd_dq_offs_kernel / _flash_bwd_dkv_offs_kernel, #2).
// Each .cu defines its C entries.
//
// Function (folded q = q * sm_scale, query row i at global position
// offs[0] + i, key j at offs[1] + j):
//   s_ij  = (q_i * sm_scale) . k_j        masked to -1e30 where invisible
//   p_ij  = exp(s_ij - lse_safe_i),        lse_safe = lse > -5e29 ? lse : +1e30
//   ds_ij = p_ij * (do_i . v_j - deff_i),  deff = rowsum(do * out) - dlse
//   dq_i  = sm_scale * sum_j ds_ij k_j
//   dk_j  = sum_i ds_ij (q_i * sm_scale),  dv_j = sum_i p_ij do_i
// Rows with no visible key (lse pinned to -1e30) and keys no row sees get
// exactly 0: p is set to 0 where the mask says so, never computed from a
// -1e30 score. deff is computed by the caller.
//
// Bound on one H100 SXM: float32-accurate products on the tensor cores
// cost three TF32 products each (tf32_mma.cuh), so operations are 3 * 6 * B * H *
// sum_rows(visible keys) * D for dq and 3 * 8 * ... * D for dk/dv at the
// 495 TFLOP/s dense TF32 rate; bytes are the inputs read once and the
// outputs written once at 3.35 TB/s. At (8, 8, 512, 64) causal that is
// 0.0196 ms (dq) and 0.0261 ms (dk/dv), at (4, 8, 4096, 64) causal 0.625
// and 0.833 ms: operation bound (dq's bytes at S = 512 take 0.0126 ms).
//
// What the design does:
// - Products: 3xTF32 mma.sync.m16n8k8 (tf32_mma.cuh): every operand is
//   split into hi + lo when its fragment is loaded into registers (five
//   ALU operations an element); shared memory holds plain float32, so
//   splitting costs no shared memory. dQ, dK and dV are summed for each
//   walked tile from zero and added to the running sums with a rounded
//   add (the tensor cores round their float32 sums toward zero).
// - Blocking: a block of 4 warps owns 64 rows (query rows for dq, key rows
//   for dk/dv) of one (b, h), 16 a warp, and walks the other axis in tiles
//   of kTile rows (64 at D = 32 and 64; 32 at D = 128, where two 16 x 128
//   accumulators a warp plus the scores would not fit the registers
//   otherwise). dq: S = q K^T and dP = dO V^T by MMA, P = exp2(S * sm_scale
//   * log2e - lse_safe * log2e) and dS = P (dP - deff) on the accumulator
//   registers, then dQ += dS K. dk/dv: the transposed scores S^T = K q^T
//   and dP^T = V dO^T, so P^T and dS^T belong to the key rows the warp
//   owns, then dV += P^T dO and dK += dS^T q. sm_scale is applied to the
//   scores' accumulators and to dq and dk at the end (same function as
//   folding it into q, another rounding).
// - dS and P reach the A fragments of the second products straight from
//   the accumulator registers, in a permuted order of the contracted axis
//   (acc_to_a with load_bp, tf32_mma.cuh).
// - Staging: 16-byte cp.async copies into XOR-swizzled shared tiles,
//   zero-filled past the valid rows. The walked tile is double-buffered
//   (K and V for dq; q, dO, lse and deff for dk/dv): tile t + 1 loads
//   while tile t computes, with one __syncthreads a tile. 96 KB of shared
//   memory at D = 64 (two blocks an SM), 128 KB at D = 128, as dynamic
//   shared memory.
// - Tiles no row of the block can see under the causal mask are never
//   loaded (the TPU kernels' loop bounds); tiles wholly visible skip the
//   mask. Causal dq blocks launch heaviest first (the last query rows see
//   the most keys); dk/dv blocks are heaviest first in natural order. A
//   block owns its output rows: no atomics, bit-identical from call to
//   call.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_split.cuh"   // the split geometry
#include "tf32_mma.cuh"      // 3xTF32 mma.sync, cp.async staging

namespace mx_flash_bwd {
// Internal linkage: flash_bwd_offs.cu and flash_bwd_grid.cu instantiate the
// same kernels and launchers into two libraries of one process, where a
// launcher's function-local static (its shared-memory attribute) would
// otherwise be one GNU-unique object for both, and the second library's
// kernel would launch without its attribute.
namespace {

using namespace mx_tc;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// owned q and dO (or k and v), and two stages of the walked pair
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kRows * D + 4 * tile_rows<D>() * D);
}

// as dq, plus two stages of the walked tile's lse and deff
template <int D>
constexpr size_t dkv_smem_bytes() {
  return dq_smem_bytes<D>() + sizeof(float) * 4 * tile_rows<D>();
}

// dq. One block: 64 query rows of (b, h) = blockIdx.x, key split
// blockIdx.z of width w (n_split == 1: w >= sk, the final dq).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ offs,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ deff, float* __restrict__ dq,
                    int sq, int sk, int w, int n_split, float sm_scale,
                    int causal) {
  constexpr int kT = tile_rows<D>();
  constexpr int kNT = kT / 8;   // 8-key groups of a tile
  constexpr int kND = D / 8;    // 8-column groups of a row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kRows][D]
  float* dos = qs + kRows * D;      // [kRows][D]
  float* kvs = dos + kRows * D;     // [2 stages][k, v][kT][D]

  const int bh = blockIdx.x;
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int q0 = rb * kRows;
  const int q_base = offs[0];
  const int k_base = offs[1];
  const int last_q = q_base + min(q0 + kRows, sq) - 1;
  if (!direct && split >= mx_flash::live_kv_splits(last_q, k_base, w,
                                                   n_split, causal))
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
  const float scale_l2 = sm_scale * kLog2e;
  // the thread's rows wr + g and wr + g + 8
  float lse_l2[2], deff_r[2];
  int q_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + wr + g + 8 * h;
    const bool ok = i < sq;
    const float l = ok ? lse[qoff + i] : kNeg;
    lse_l2[h] = (l > kNeg / 2 ? l : -kNeg) * kLog2e;
    deff_r[h] = ok ? deff[qoff + i] : 0.f;
    q_pos[h] = q_base + i;
  }

  float acc[kND][4];
  zero(acc);

  if (n_t > 0) {
    const float* kb = k + static_cast<size_t>(bh) * sk * D;
    const float* vb = v + static_cast<size_t>(bh) * sk * D;
    stage<D, kRows>(qs, q + qoff * D, q0, sq);
    stage<D, kRows>(dos, dout + qoff * D, q0, sq);
    stage<D, kT>(kvs, kb, k_lo, k_end);
    stage<D, kT>(kvs + kT * D, vb, k_lo, k_end);
    cp_async_commit();
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

      float s[kNT][4], dp[kNT][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < kND; ++kk) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        load_a<D>(qs, wr, kk * 8, g, t, qh, ql);
        load_a<D>(dos, wr, kk * 8, g, t, oh, ol);
#pragma unroll
        for (int j = 0; j < kNT; j += kGroup) {
          mma_rows<D>(s + j, qh, ql, ks, j * 8, kk * 8, g, t);
          mma_rows<D>(dp + j, oh, ol, vs, j * 8, kk * 8, g, t);
        }
      }

      // ds into s; a tile wholly inside the split and seen by every row
      // of the block needs no mask
      const bool masked = kt0 + kT > k_end ||
                          (causal && k_base + kt0 + kT - 1 > q_base + q0);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kj = kt0 + j * 8 + 2 * t + (e & 1);
          float p = exp2f(fmaf(s[j][e], scale_l2, -lse_l2[h]));
          if (masked && !(kj < k_end && (!causal || q_pos[h] >= k_base + kj)))
            p = 0.f;
          s[j][e] = p * (dp[j][e] - deff_r[h]);
        }
      }

      // dQ += dS K over the tile's keys in the permuted order, summed
      // for the tile first: the tensor cores round their float32 sums
      // toward zero, so a chain over thousands of keys would drift by
      // ~1e-4, and the rounded add per tile keeps it near 1e-6
      float part[kND][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ah[4], al[4];
        acc_to_a(s[j], ah, al);
#pragma unroll
        for (int n = 0; n < kND; n += kGroup)
          mma_cols<D>(part + n, ah, al, ks, j * 8, n * 8, g, t);
      }
      add(acc, part);
    }
  }

  // direct: the final dq; else this split's unscaled slot
  const float scale = direct ? sm_scale : 1.f;
  const size_t base = direct ? 0 : static_cast<size_t>(split) * gridDim.x * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + wr + g + 8 * h;
    if (i >= sq) continue;
    float* o = dq + (base + qoff + i) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<float2*>(o + n * 8) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// dk/dv. One block: 64 keys of (b, h) = blockIdx.x, query split
// blockIdx.z of width w (n_split == 1: w >= sq, the final dk and dv).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ offs,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ deff, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int w,
                     int n_split, float sm_scale, int causal) {
  constexpr int kT = tile_rows<D>();
  constexpr int kNT = kT / 8;   // 8-query groups of a tile
  constexpr int kND = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [kRows][D]
  float* vs = ks + kRows * D;       // [kRows][D]
  float* qds = vs + kRows * D;      // [2 stages][q, do][kT][D]
  float* lds = qds + 4 * kT * D;    // [2 stages][lse, deff][kT]

  const int bh = blockIdx.x;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int k0 = blockIdx.y * kRows;
  const int q_base = offs[0];
  const int k_base = offs[1];
  if (!direct && split < mx_flash::first_live_q_split(k_base + k0, q_base, sq,
                                                      w, n_split, causal))
    return;   // dead: no query of this split sees a key of the block

  // queries [q_lo, q_end) of the split; under the causal mask the first
  // row that sees key k0 is rel, and tiles start at the one holding it
  const int q_lo = split * w;
  const int q_end = min(q_lo + w, sq);
  int first = q_lo;
  int n_t = (q_end - q_lo + kT - 1) / kT;
  if (causal) {
    const int rel = k_base + k0 - q_base;
    if (rel > q_lo) first = q_lo + (rel - q_lo) / kT * kT;
    n_t = rel >= q_end ? 0 : (q_end - first + kT - 1) / kT;
  }

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wr = warp * 16;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const float scale_l2 = sm_scale * kLog2e;
  const int k_pos[2] = {k_base + k0 + wr + g, k_base + k0 + wr + g + 8};

  float acc_k[kND][4], acc_v[kND][4];
  zero(acc_k);
  zero(acc_v);

  if (n_t > 0) {
    const float* qb = q + qoff * D;
    const float* dob = dout + qoff * D;
    // the walked tile at qt0 into stage st
    auto stage_tile = [&](int st, int qt0) {
      float* dst = qds + st * 2 * kT * D;
      stage<D, kT>(dst, qb, qt0, q_end);
      stage<D, kT>(dst + kT * D, dob, qt0, q_end);
      const int tid = threadIdx.x;
      if (tid < 2 * kT) {
        const int i = qt0 + tid % kT;
        const bool ok = i < q_end;
        cp_async4(lds + st * 2 * kT + tid, (tid < kT ? lse : deff) + qoff +
                  (ok ? i : 0), ok);
      }
    };
    stage<D, kRows>(ks, k + koff * D, k0, sk);
    stage<D, kRows>(vs, v + koff * D, k0, sk);
    stage_tile(0, first);
    cp_async_commit();
    for (int it = 0; it < n_t; ++it) {
      const int qt0 = first + it * kT;
      const float* qs = qds + (it & 1) * 2 * kT * D;
      const float* os = qs + kT * D;
      const float* ls = lds + (it & 1) * 2 * kT;
      const float* dfs = ls + kT;
      cp_async_wait_all();
      __syncthreads();   // tile it landed; tile it - 1's reads are done
      if (it + 1 < n_t) {
        stage_tile((it + 1) & 1, qt0 + kT);
        cp_async_commit();
      }

      // S^T = K q^T and dP^T = V dO^T: rows are the warp's keys
      float s[kNT][4], dp[kNT][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < kND; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        load_a<D>(ks, wr, kk * 8, g, t, kh, kl);
        load_a<D>(vs, wr, kk * 8, g, t, vh, vl);
#pragma unroll
        for (int j = 0; j < kNT; j += kGroup) {
          mma_rows<D>(s + j, kh, kl, qs, j * 8, kk * 8, g, t);
          mma_rows<D>(dp + j, vh, vl, os, j * 8, kk * 8, g, t);
        }
      }

      // p into s, ds into dp; a tile wholly inside the split whose first
      // query sees the block's last key needs no mask
      const bool masked = qt0 + kT > q_end ||
                          (causal && q_base + qt0 < k_base + k0 + kRows - 1);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = j * 8 + 2 * t + (e & 1);
          const int qi = qt0 + ci;
          const float l = ls[ci];
          const float l_safe = l > kNeg / 2 ? l : -kNeg;
          float p = exp2f(fmaf(s[j][e], scale_l2, -l_safe * kLog2e));
          if (masked && !(qi < q_end &&
                          (!causal || q_base + qi >= k_pos[e >> 1])))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dfs[ci]);
        }
      }

      // dV += P^T dO, then dK += dS^T q, over the tile's queries in the
      // permuted order, each summed for the tile first (as dQ in the dq
      // kernel)
      float part[kND][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ah[4], al[4];
        acc_to_a(s[j], ah, al);
#pragma unroll
        for (int n = 0; n < kND; n += kGroup)
          mma_cols<D>(part + n, ah, al, os, j * 8, n * 8, g, t);
      }
      add(acc_v, part);
      zero(part);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ah[4], al[4];
        acc_to_a(dp[j], ah, al);
#pragma unroll
        for (int n = 0; n < kND; n += kGroup)
          mma_cols<D>(part + n, ah, al, qs, j * 8, n * 8, g, t);
      }
      add(acc_k, part);
    }
  }

  // direct: the final dk, dv; else this split's slots. dk takes sm_scale
  // here (the folded q of the formula)
  const size_t base = direct ? 0 : static_cast<size_t>(split) * gridDim.x * sk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = k0 + wr + g + 8 * h;
    if (j >= sk) continue;
    const size_t r = (base + koff + j) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      *reinterpret_cast<float2*>(dk + r + n * 8) = make_float2(
          acc_k[n][2 * h] * sm_scale, acc_k[n][2 * h + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + r + n * 8) =
          make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

// --- launchers ---------------------------------------------------------------

// The kernels with their dynamic shared memory allowed: the attribute is
// set once per instantiation (thread-safe static init), before any graph
// capture the caller may start. Return the CUDA error of the launch.
template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const int* offs, const float* dout, const float* lse,
              const float* deff, float* dq, int bh, int sq, int sk, int w,
              int n_split, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kRows - 1) / kRows, n_split);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dq, sq, sk, w, n_split, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const int* offs, const float* dout, const float* lse,
               const float* deff, float* dk, float* dv, int bh, int sq,
               int sk, int w, int n_split, float sm_scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sk + kRows - 1) / kRows, n_split);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dk, dv, sq, sk, w, n_split, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mx_flash_bwd
