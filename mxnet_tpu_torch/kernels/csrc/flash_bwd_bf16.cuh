// The flash-attention backward body in bf16 on Hopper's warpgroup tensor
// cores (sm_90a): one dq kernel and one dk/dv kernel, `template <int D>`,
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
// What the design does (bf16_wgmma.cuh):
// - Products: wgmma.mma_async m64nNk16, one warpgroup for 64 rows. The
//   first products read both operands from shared memory (K-major); dS and
//   P are rounded to bf16 straight from their accumulators into the A
//   fragments of the second products, whose B (K, dO, qs) is read
//   transposed (MN-major) from shared memory. The sums of dQ, dK and dV
//   stay in the accumulators of the second products across the tiles.
// - dq: a block of one warpgroup owns 64 query rows, q (folded in
//   place once) and dO in shared memory, and walks K and V in tiles of 64
//   keys: S = qs K^T and dP = dO V^T, P and dS on the registers, dQ += dS K.
// - dk/dv: a block of one warpgroup owns 64 keys, K and V in shared
//   memory, and walks q, dO, lse and deff in tiles of 64 queries (32 at
//   D = 128, where dK and dV take 128 registers a thread): S^T = K qs^T and
//   dP^T = V dO^T, so P^T and dS^T belong to the warpgroup's keys; then
//   dV += P^T dO and dK += dS^T qs. Each q tile is folded in place by the
//   threads that copied it, before the barrier that publishes the tile.
//   At D <= 64 its registers are held to 168 a thread, so three blocks run
//   on an SM (dkv_min_blocks), and P^T and dS^T are packed a 16-query step
//   at a time, as each is done, which keeps them within 168 unspilled.
// - Each block runs on its own schedule (two warpgroups sharing each
//   staged tile measured slower: PERF.md). The walked tiles go through a
//   ring of kStages = 3 stages: tile it + 2 loads while tile it computes,
//   waited on with cp.async.wait_group 1.
// - Tiles no row of the block can see under the causal mask are never
//   loaded; tiles wholly visible skip the mask; a split range that is not a
//   multiple of the tile is masked at its end, and a (block, split) pair no
//   row of the block can see returns at once (flash_split.cuh). A block
//   owns its output rows: no atomics, bit-identical from call to call.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"    // wgmma, descriptors, staging
#include "flash_split.cuh"   // the split geometry, kNeg

namespace mx_flash_bwd_bf16 {
// Internal linkage, as flash_bwd.cuh's body.
namespace {

using namespace mx_wg;
using mx_flash::first_live_q_split;
using mx_flash::kNeg;
using mx_flash::live_kv_splits;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 3;   // ring of the walked tiles

// keys of the dq kernel's walked tile, queries of the dk/dv kernel's
constexpr int kDqTile = 64;
template <int D>
__host__ __device__ constexpr int dkv_tile() { return D == 128 ? 32 : 64; }

// dk/dv blocks an SM the registers must leave room for: three at D <= 64
// (168 registers a thread, where the compiler would take ~206 and fit two)
template <int D>
__host__ __device__ constexpr int dkv_min_blocks() {
  return D <= 64 ? 3 : 1;
}

// owned q and dO, and the ring of K and V tiles
template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return sizeof(bf16) * (2 * kWGRows * D + kStages * 2 * kDqTile * D);
}

// owned K and V, the ring of q and dO tiles, then the ring's lse and deff
template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return sizeof(bf16) * (2 * kWGRows * D +
                         kStages * 2 * dkv_tile<D>() * D) +
         sizeof(float) * kStages * 2 * dkv_tile<D>();
}

// D += A B for the MN-major B of rows [r0, r0 + 16) of an [R][D] tile: one
// product, or one a 64-column half at D = 128
template <int D, int R>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            const bf16* tile, int r0) {
  if constexpr (D == 128) {
    wgmma_rs<64, 1>(*reinterpret_cast<float(*)[32]>(d), a,
                    desc_mn<D, R>(tile, r0, 0), 1);
    wgmma_rs<64, 1>(*reinterpret_cast<float(*)[32]>(d + 32), a,
                    desc_mn<D, R>(tile, r0, 64), 1);
  } else {
    wgmma_rs<D, 1>(d, a, desc_mn<D, R>(tile, r0, 0), 1);
  }
}

// dq. One block: 64 query rows of (b, h) = blockIdx.x, key split
// blockIdx.z of width w (n_split == 1: w >= sk, the final bf16 dq; else
// the split's unscaled float32 partial into dq_part).
template <int D>
__global__ void __launch_bounds__(kWGThreads)
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
  constexpr int kR = kWGRows;
  constexpr int kTh = kWGThreads;
  constexpr int kT = kDqTile;
  constexpr int kNT = kT / 8;
  constexpr int kKT = kT / 16;
  constexpr int kND = D / 8;
  constexpr int kKD = D / 16;
  extern __shared__ __align__(1024) unsigned char mx_smem[];
  bf16* qs = smem_base(mx_smem);   // [kR][D]
  bf16* dos = qs + kR * D;         // [kR][D]
  bf16* kvs = dos + kR * D;        // [kStages][k, v][kT][D]

  const int bh = blockIdx.x;
  const int rb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int q0 = rb * kR;
  const int q_base = offs[0];
  const int k_base = offs[1];
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

  float acc[D / 2];
  zero(acc);

  if (n_t > 0) {
    const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
    const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
    auto stage_kv = [&](int it) {
      if (it < n_t) {
        bf16* dst = kvs + (it % kStages) * 2 * kT * D;
        stage_tile<D, kT, kTh>(dst, kb, k_lo + it * kT, k_end);
        stage_tile<D, kT, kTh>(dst + kT * D, vb, k_lo + it * kT, k_end);
      }
      cp_async_commit();
    };
    stage_tile<D, kR, kTh>(qs, q + qoff * D, q0, sq);
    stage_tile<D, kR, kTh>(dos, dout + qoff * D, q0, sq);
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

      // S = qs K^T, dP = dO V^T
      float s[kT / 2], dp[kT / 2];
      zero(s);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        wgmma_ss<kT, 0>(s, desc_k<D, kR>(qs, 0, kk * 16),
                        desc_k<D, kT>(ks, 0, kk * 16), kk);
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        wgmma_ss<kT, 0>(dp, desc_k<D, kR>(dos, 0, kk * 16),
                        desc_k<D, kT>(vs, 0, kk * 16), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

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
          float p = exp2f(fmaf(s[4 * j + e], kLog2e, -lse_l2[h]));
          if (masked &&
              !(kj < k_end && (!causal || q_pos[h] >= k_base + kj)))
            p = 0.f;
          s[4 * j + e] = p * (dp[4 * j + e] - deff_r[h]);
        }

      // dQ += bf16(dS) K
      uint32_t da[kKT][4];
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) pack_a(s + 8 * jj, da[jj]);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj)
        wgmma_rs_mn<D, kT>(acc, da[jj], ks, jj * 16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(da);
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
        store2(o + n * 8, acc[4 * n + 2 * h] * sm_scale,
               acc[4 * n + 2 * h + 1] * sm_scale);
    } else {
      float* o = dq_part + (base + qoff + i) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kND; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    }
  }
}

// dk/dv. One block: 64 keys of (b, h) = blockIdx.x, query split
// blockIdx.z of width w (n_split == 1: w >= sq, the final bf16 dk and dv;
// else the split's float32 partials into dk_part and dv_part).
template <int D>
__global__ void __launch_bounds__(kWGThreads, (dkv_min_blocks<D>()))
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
  constexpr int kR = kWGRows;
  constexpr int kTh = kWGThreads;
  constexpr int kT = dkv_tile<D>();
  constexpr int kNT = kT / 8;    // 8-query groups of a tile
  constexpr int kKT = kT / 16;   // 16-query steps of a tile
  constexpr int kND = D / 8;
  constexpr int kKD = D / 16;
  extern __shared__ __align__(1024) unsigned char mx_smem[];
  bf16* ks = smem_base(mx_smem);   // [kR][D]
  bf16* vs = ks + kR * D;          // [kR][D]
  bf16* qds = vs + kR * D;         // [kStages][q, do][kT][D]
  float* lds = reinterpret_cast<float*>(qds + kStages * 2 * kT * D);
  // [kStages][lse, deff][kT]

  const int bh = blockIdx.x;
  const int split = blockIdx.z;
  const bool direct = n_split == 1;
  const int k0 = blockIdx.y * kR;
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

  // the warp's 16 keys from block row wr
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const int k_pos = k_base + k0 + wr + g;   // the thread's first key

  float acc_k[D / 2], acc_v[D / 2];
  zero(acc_k);
  zero(acc_v);

  if (n_t > 0) {
    const bf16* qb = q + qoff * D;
    const bf16* dob = dout + qoff * D;
    auto stage_qd = [&](int it) {
      if (it < n_t) {
        const int st = it % kStages, qt0 = first + it * kT;
        bf16* dst = qds + st * 2 * kT * D;
        stage_tile<D, kT, kTh>(dst, qb, qt0, q_end);
        stage_tile<D, kT, kTh>(dst + kT * D, dob, qt0, q_end);
        const int tid = threadIdx.x;
        if (tid < 2 * kT) {
          const int i = qt0 + tid % kT;
          const bool ok = i < q_end;
          cp_async4(lds + st * 2 * kT + tid,
                    (tid < kT ? lse : deff) + qoff + (ok ? i : 0), ok);
        }
      }
      cp_async_commit();
    };
    stage_tile<D, kR, kTh>(ks, k + koff * D, k0, sk);
    stage_tile<D, kR, kTh>(vs, v + koff * D, k0, sk);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) stage_qd(st);

    for (int it = 0; it < n_t; ++it) {
      const int qt0 = first + it * kT;
      bf16* qs = qds + (it % kStages) * 2 * kT * D;
      const bf16* os = qs + kT * D;
      const float* ls = lds + (it % kStages) * 2 * kT;
      const float* dfs = ls + kT;
      cp_async_wait<kStages - 2>();   // this thread's copies of tile it
      fold_own<D, kT, kTh>(qs, sm_scale);
      fence_proxy_async();
      __syncthreads();   // tile it landed and folded; it - 1's are done
      stage_qd(it + kStages - 1);

      // S^T = K qs^T and dP^T = V dO^T: rows are the block's keys
      float s[kT / 2], dp[kT / 2];
      zero(s);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        wgmma_ss<kT, 0>(s, desc_k<D, kR>(ks, 0, kk * 16),
                        desc_k<D, kT>(qs, 0, kk * 16), kk);
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        wgmma_ss<kT, 0>(dp, desc_k<D, kR>(vs, 0, kk * 16),
                        desc_k<D, kT>(os, 0, kk * 16), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // p into s, ds into dp; a tile wholly inside the split whose first
      // query sees the block's last key needs no mask
      const bool masked =
          qt0 + kT > q_end || (causal && q_base + qt0 < k_base + k0 + kR - 1);
      // a 16-query step at a time, each packed as soon as it is done
      uint32_t pa[kKT][4], da[kKT][4];
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj) {
#pragma unroll
        for (int j = 2 * jj; j < 2 * jj + 2; ++j) {
          const int c0 = j * 8 + 2 * t;   // the step's two queries
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c0);
          const float2 f2 = *reinterpret_cast<const float2*>(dfs + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qt0 + c0 + (e & 1);
            const float l = e & 1 ? l2.y : l2.x;
            const float l_safe = l > kNeg / 2 ? l : -kNeg;
            float p = exp2f(fmaf(s[4 * j + e], kLog2e, -l_safe * kLog2e));
            if (masked &&
                !(qi < q_end &&
                  (!causal || q_base + qi >= k_pos + 8 * (e >> 1))))
              p = 0.f;
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - (e & 1 ? f2.y : f2.x));
          }
        }
        pack_a(s + 8 * jj, pa[jj]);
        pack_a(dp + 8 * jj, da[jj]);
      }

      // dV += bf16(P^T) dO, dK += bf16(dS^T) qs
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj)
        wgmma_rs_mn<D, kT>(acc_v, pa[jj], os, jj * 16);
#pragma unroll
      for (int jj = 0; jj < kKT; ++jj)
        wgmma_rs_mn<D, kT>(acc_k, da[jj], qs, jj * 16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_frags(pa);
      fence_frags(da);
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
      const float* ck = acc_k + 4 * n + 2 * h;
      const float* cv = acc_v + 4 * n + 2 * h;
      if (direct) {
        store2(dk + r + n * 8, ck[0], ck[1]);
        store2(dv + r + n * 8, cv[0], cv[1]);
      } else {
        *reinterpret_cast<float2*>(dk_part + r + n * 8) =
            make_float2(ck[0], ck[1]);
        *reinterpret_cast<float2*>(dv_part + r + n * 8) =
            make_float2(cv[0], cv[1]);
      }
    }
  }
}

// --- launchers ---------------------------------------------------------------

// The kernels with their dynamic shared memory allowed (once per
// instantiation). Return the CUDA error of the launch.

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
  const dim3 grid(bh, (sq + kWGRows - 1) / kWGRows, n_split);
  flash_bwd_dq_bf16_kernel<D><<<grid, kWGThreads, smem, stream>>>(
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
  const dim3 grid(bh, (sk + kWGRows - 1) / kWGRows, n_split);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kWGThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dk, dv, dk_part, dv_part, sq, sk, w,
      n_split, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mx_flash_bwd_bf16
