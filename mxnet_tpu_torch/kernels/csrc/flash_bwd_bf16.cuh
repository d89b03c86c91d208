// The flash-attention backward body in bf16 on the tensor cores, for
// Hopper (sm_90a): one dq kernel and one dk/dv kernel, `template <int D>`,
// over splits of the walked axis (blockIdx.z; w rows each), as the float32
// body (flash_bwd.cuh). flash_bwd_offs.cu instantiates them beside the
// float32 body with one split over the whole axis, for TPU kernels
// _flash_bwd_dq_offs_kernel / _flash_bwd_dkv_offs_kernel (#2), writing bf16
// dq, dk, dv; flash_bwd_grid.cu over the JAX call's splits, for
// _flash_bwd_dq_grid_kernel / _flash_bwd_dkv_grid_kernel (#4), writing
// float32 partials (unscaled dq over key splits, dk and dv over query
// splits) that its reduce passes sum, in split order, and round once.
//
// Function, with the roundings of the reference kernels
// (mxnet_tpu/kernels/flash_attention.py:402 and :453 on bf16 inputs;
// query row i at global position offs[0] + i, key j at offs[1] + j):
//   qs_i  = bf16(q_i * sm_scale)                   (_fold_scale)
//   s_ij  = qs_i . k_j                              masked to -1e30
//   p_ij  = exp(s_ij - lse_safe_i),  lse_safe = lse > -5e29 ? lse : +1e30
//   ds_ij = p_ij * (do_i . v_j - deff_i),  deff = rowsum(do * out) - dlse
//   dq_i  = bf16(sm_scale * sum_j bf16(ds_ij) k_j)
//   dk_j  = bf16(sum_i bf16(ds_ij) qs_i),  dv_j = bf16(sum_i bf16(p_ij) do_i)
// with every score, p, ds and sum in float32 and every product of two bf16
// exact. Rows with no visible key and keys no row sees get exactly 0.
// deff (float32) is computed by the caller. With splits, the sums run over
// the block's split and stay float32; sm_scale and the rounding come after
// the split sum (the reference's flush, L767-769 and L823-824).
//
// Bound on one H100 SXM: operations 6 * B * H * sum_rows(visible keys) * D
// for dq and 8 * ... * D for dk/dv at the 989 TFLOP/s dense bf16 rate;
// bytes the inputs read once and the outputs written once at 3.35 TB/s.
// At (8, 8, 512, 64) causal: dq 3.2 GFLOP (0.0033 ms) against 0.0067 ms of
// bytes, dk/dv 4.3 GFLOP (0.0043 ms) against 0.0078 ms: bytes bound.
//
// What the design does (bf16_mma.cuh):
// - Products: one mma.sync.m16n8k16 bf16 product a 16 x 8 x 16 step.
//   dS and P are rounded to bf16 straight from the accumulator registers
//   into the A fragments of the second products (acc_to_a_bf).
// - dq: a block owns 64 query rows, q (folded in place once) and dO in
//   shared memory, and walks K and V in tiles of 64 keys (32 at D = 128):
//   S = qs K^T and dP = dO V^T, P and dS on the registers, dQ_t = dS K
//   summed from zero and added to the running sum.
// - dk/dv: a block owns 64 keys, K and V in shared memory, and walks q,
//   dO, lse and deff in tiles; each q tile is folded in place when it
//   lands (one more barrier a tile). S^T = K qs^T and dP^T = V dO^T, so
//   P^T and dS^T belong to the warp's keys; then dV_t = P^T dO and dK_t =
//   dS^T qs.
// - Staging: 16-byte cp.async copies of bf16 into swizzled tiles,
//   zero-filled past the valid rows; the walked tile double-buffered.
// - Tiles no row of the block can see under the causal mask are never
//   loaded; tiles wholly visible skip the mask; a split range that is not a
//   multiple of the tile is masked at its end, and a (block, split) pair no
//   row of the block can see returns at once (flash_split.cuh). A block
//   owns its output rows: no atomics, bit-identical from call to call.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"      // bf16 mma.sync, fragments, staging
#include "flash_split.cuh"   // the split geometry, kNeg

namespace mx_flash_bwd_bf16 {
// Internal linkage, as flash_bwd.cuh's body.
namespace {

using namespace mx_bf;
using mx_flash::first_live_q_split;
using mx_flash::kNeg;
using mx_flash::live_kv_splits;

constexpr float kLog2e = 1.4426950408889634f;

// owned q and dO (or k and v), and two stages of the walked pair
template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return sizeof(bf16) * (2 * kRows * D + 4 * tile_rows<D>() * D);
}

// as dq, plus two stages of the walked tile's lse and deff
template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return dq_bf16_smem_bytes<D>() + sizeof(float) * 4 * tile_rows<D>();
}

// dq. One block: 64 query rows of (b, h) = blockIdx.x, key split
// blockIdx.z of width w (n_split == 1: w >= sk, the final bf16 dq; else
// the split's unscaled float32 partial into dq_part).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ offs,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ deff,
                         bf16* __restrict__ dq, float* __restrict__ dq_part,
                         int sq, int sk, int w, int n_split, float sm_scale,
                         int causal) {
  constexpr int kT = tile_rows<D>();
  constexpr int kNT = kT / 8;
  constexpr int kKT = kT / 16;
  constexpr int kND = D / 8;
  constexpr int kKD = D / 16;
  extern __shared__ __align__(16) float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [kRows][D]
  bf16* dos = qs + kRows * D;                 // [kRows][D]
  bf16* kvs = dos + kRows * D;                // [2 stages][k, v][kT][D]

  const int bh = blockIdx.x;
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int q0 = rb * kRows;
  const int q_base = offs[0];
  const int k_base = offs[1];
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
    const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
    const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
    stage_bf<D, kRows>(qs, q + qoff * D, q0, sq);
    stage_bf<D, kRows>(dos, dout + qoff * D, q0, sq);
    stage_bf<D, kT>(kvs, kb, k_lo, k_end);
    stage_bf<D, kT>(kvs + kT * D, vb, k_lo, k_end);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    fold_tile<D, kRows>(qs, sm_scale);   // the loop's barrier publishes it
    for (int it = 0; it < n_t; ++it) {
      const int kt0 = k_lo + it * kT;
      const bf16* ks = kvs + (it & 1) * 2 * kT * D;
      const bf16* vs = ks + kT * D;
      cp_async_wait_all();
      __syncthreads();   // tile it landed; tile it - 1's reads are done
      if (it + 1 < n_t) {
        bf16* nk = kvs + ((it + 1) & 1) * 2 * kT * D;
        stage_bf<D, kT>(nk, kb, kt0 + kT, k_end);
        stage_bf<D, kT>(nk + kT * D, vb, kt0 + kT, k_end);
        cp_async_commit();
      }

      float s[kNT][4], dp[kNT][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        uint32_t aq[4], ao[4];
        load_a_bf<D>(qs, wr, kk * 16, g, t, aq);
        load_a_bf<D>(dos, wr, kk * 16, g, t, ao);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b[2];
          load_b_rows<D>(ks, j * 8, kk * 16, g, t, b);
          mma_bf16(s[j], aq, b);
          load_b_rows<D>(vs, j * 8, kk * 16, g, t, b);
          mma_bf16(dp[j], ao, b);
        }
      }

      // ds into s; a tile wholly inside the split and seen by every row
      // of the block needs no mask
      const bool masked = kt0 + kT > k_end ||
                          (causal && k_base + kt0 + kT - 1 > q_base + q0);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kj = kt0 + j * 8 + 2 * t + (e & 1);
          float p = exp2f(fmaf(s[j][e], kLog2e, -lse_l2[h]));
          if (masked &&
              !(kj < k_end && (!causal || q_pos[h] >= k_base + kj)))
            p = 0.f;
          s[j][e] = p * (dp[j][e] - deff_r[h]);
        }

      // dQ_t = bf16(dS) K, summed from zero, then added
      float part[kND][4];
      zero(part);
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) {
        uint32_t a[4];
        acc_to_a_bf(s[2 * jj], s[2 * jj + 1], a);
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          uint32_t b[2];
          load_b_cols<D>(ks, jj * 16, n * 8, g, t, b);
          mma_bf16(part[n], a, b);
        }
      }
      add(acc, part);
    }
  }

  // direct: the final dq; else this split's unscaled float32 slot
  const size_t base = direct ? 0 : static_cast<size_t>(split) * gridDim.x * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + wr + g + 8 * h;
    if (i >= sq) continue;
    if (direct) {
      bf16* o = dq + (qoff + i) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kND; ++n)
        store2(o + n * 8, acc[n][2 * h] * sm_scale,
               acc[n][2 * h + 1] * sm_scale);
    } else {
      float* o = dq_part + (base + qoff + i) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kND; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// dk/dv. One block: 64 keys of (b, h) = blockIdx.x, query split
// blockIdx.z of width w (n_split == 1: w >= sq, the final bf16 dk and dv;
// else the split's float32 partials into dk_part and dv_part).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ offs,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ deff,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dk_part,
                          float* __restrict__ dv_part, int sq, int sk, int w,
                          int n_split, float sm_scale, int causal) {
  constexpr int kT = tile_rows<D>();
  constexpr int kNT = kT / 8;    // 8-query groups of a tile
  constexpr int kKT = kT / 16;   // 16-query steps of a tile
  constexpr int kND = D / 8;
  constexpr int kKD = D / 16;
  extern __shared__ __align__(16) float smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [kRows][D]
  bf16* vs = ks + kRows * D;                  // [kRows][D]
  bf16* qds = vs + kRows * D;                 // [2 stages][q, do][kT][D]
  float* lds = reinterpret_cast<float*>(qds + 4 * kT * D);
  // [2 stages][lse, deff][kT]

  const int bh = blockIdx.x;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int k0 = blockIdx.y * kRows;
  const int q_base = offs[0];
  const int k_base = offs[1];
  if (!direct && split < first_live_q_split(k_base + k0, q_base, sq, w,
                                            n_split, causal))
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
  const int k_pos[2] = {k_base + k0 + wr + g, k_base + k0 + wr + g + 8};

  float acc_k[kND][4], acc_v[kND][4];
  zero(acc_k);
  zero(acc_v);

  if (n_t > 0) {
    const bf16* qb = q + qoff * D;
    const bf16* dob = dout + qoff * D;
    auto stage_tile = [&](int st, int qt0) {
      bf16* dst = qds + st * 2 * kT * D;
      stage_bf<D, kT>(dst, qb, qt0, q_end);
      stage_bf<D, kT>(dst + kT * D, dob, qt0, q_end);
      const int tid = threadIdx.x;
      if (tid < 2 * kT) {
        const int i = qt0 + tid % kT;
        const bool ok = i < q_end;
        cp_async4(lds + st * 2 * kT + tid, (tid < kT ? lse : deff) + qoff +
                  (ok ? i : 0), ok);
      }
    };
    stage_bf<D, kRows>(ks, k + koff * D, k0, sk);
    stage_bf<D, kRows>(vs, v + koff * D, k0, sk);
    stage_tile(0, first);
    cp_async_commit();
    for (int it = 0; it < n_t; ++it) {
      const int qt0 = first + it * kT;
      bf16* qs = qds + (it & 1) * 2 * kT * D;
      const bf16* os = qs + kT * D;
      const float* ls = lds + (it & 1) * 2 * kT;
      const float* dfs = ls + kT;
      cp_async_wait_all();
      __syncthreads();   // tile it landed; tile it - 1's reads are done
      if (it + 1 < n_t) {
        stage_tile((it + 1) & 1, qt0 + kT);
        cp_async_commit();
      }
      fold_tile<D, kT>(qs, sm_scale);
      __syncthreads();   // the folded tile is published

      // S^T = K qs^T and dP^T = V dO^T: rows are the warp's keys
      float s[kNT][4], dp[kNT][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        uint32_t ak[4], av[4];
        load_a_bf<D>(ks, wr, kk * 16, g, t, ak);
        load_a_bf<D>(vs, wr, kk * 16, g, t, av);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b[2];
          load_b_rows<D>(qs, j * 8, kk * 16, g, t, b);
          mma_bf16(s[j], ak, b);
          load_b_rows<D>(os, j * 8, kk * 16, g, t, b);
          mma_bf16(dp[j], av, b);
        }
      }

      // p into s, ds into dp; a tile wholly inside the split whose first
      // query sees the block's last key needs no mask
      const bool masked = qt0 + kT > q_end ||
                          (causal && q_base + qt0 < k_base + k0 + kRows - 1);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = j * 8 + 2 * t + (e & 1);
          const int qi = qt0 + ci;
          const float l = ls[ci];
          const float l_safe = l > kNeg / 2 ? l : -kNeg;
          float p = exp2f(fmaf(s[j][e], kLog2e, -l_safe * kLog2e));
          if (masked &&
              !(qi < q_end && (!causal || q_base + qi >= k_pos[e >> 1])))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dfs[ci]);
        }

      // dV_t = bf16(P^T) dO, then dK_t = bf16(dS^T) qs, each summed from
      // zero and added
      float part[kND][4];
      zero(part);
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) {
        uint32_t a[4];
        acc_to_a_bf(s[2 * jj], s[2 * jj + 1], a);
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          uint32_t b[2];
          load_b_cols<D>(os, jj * 16, n * 8, g, t, b);
          mma_bf16(part[n], a, b);
        }
      }
      add(acc_v, part);
      zero(part);
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) {
        uint32_t a[4];
        acc_to_a_bf(dp[2 * jj], dp[2 * jj + 1], a);
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          uint32_t b[2];
          load_b_cols<D>(qs, jj * 16, n * 8, g, t, b);
          mma_bf16(part[n], a, b);
        }
      }
      add(acc_k, part);
    }
  }

  // dk is summed against the folded q: no further sm_scale. direct: the
  // final dk, dv; else this split's float32 slots
  const size_t base = direct ? 0 : static_cast<size_t>(split) * gridDim.x * sk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = k0 + wr + g + 8 * h;
    if (j >= sk) continue;
    const size_t r = (base + koff + j) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      if (direct) {
        store2(dk + r + n * 8, acc_k[n][2 * h], acc_k[n][2 * h + 1]);
        store2(dv + r + n * 8, acc_v[n][2 * h], acc_v[n][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(dk_part + r + n * 8) =
            make_float2(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dv_part + r + n * 8) =
            make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
      }
    }
  }
}

// --- launchers ---------------------------------------------------------------

// dq (n_split == 1) or the float32 dq_part (n_split > 1 key splits of w)
template <int D>
int launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                   const int* offs, const bf16* dout, const float* lse,
                   const float* deff, bf16* dq, float* dq_part, int bh,
                   int sq, int sk, int w, int n_split, float sm_scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_bf16_smem_bytes<D>();
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kRows - 1) / kRows, n_split);
  flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dq, dq_part, sq, sk, w, n_split,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv (n_split == 1) or the float32 dk_part, dv_part (n_split > 1 query
// splits of w)
template <int D>
int launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const int* offs, const bf16* dout, const float* lse,
                    const float* deff, bf16* dk, bf16* dv, float* dk_part,
                    float* dv_part, int bh, int sq, int sk, int w,
                    int n_split, float sm_scale, int causal,
                    cudaStream_t stream) {
  constexpr size_t smem = dkv_bf16_smem_bytes<D>();
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sk + kRows - 1) / kRows, n_split);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dk, dv, dk_part, dv_part, sq, sk, w,
      n_split, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mx_flash_bwd_bf16
