// Split-KV flash-attention forward body shared by flash_fwd_grid.cu (TPU
// kernel _flash_fwd_grid_kernel, no offsets) and flash_fwd_offs_grid.cu
// (TPU kernel _flash_fwd_offs_grid_kernel, global offsets read on the
// device), float32, for Hopper (sm_90a). Each .cu includes this header and
// defines its own C entries, so the two are separate libraries with
// separate launch counters. The split geometry (which splits a row or a key
// can see) is defined here once and also used by flash_bwd_grid.cu.
//
// Function: that of flash_fwd.cuh,
//   out[b,h,i,:] = softmax_j(s_ij) v[b,h,j,:],  s_ij = (q_i * sm_scale) . k_j
// with query row i at global position q0 + i and key j at k0 + j ([q0, k0]
// = offs[0..1] when kOffs, else [0, 0]); under `causal` a key is visible
// iff its position <= the query's. Rows with no visible key get out = 0 and
// lse = -1e30 exactly (the offset kernel's contract, L645-651 of the TPU
// kernel); without offsets lse = m + log(l_safe) (L1070-1072), and no row
// is fully masked.
//
// What "grid" means here. On the TPU the grid variant makes the key axis a
// sequential grid dimension with VMEM scratch accumulators. Hopper has no
// sequential grid axis and no VMEM ceiling to stay under; what carries over
// is the key axis as a grid axis: split-KV (flash-decoding). Pass 1
// (flash_fwd_grid_f32_kernel) runs one block per (32 query rows, (b, h),
// key split of w keys), w = the JAX call's block_k rounded up to the 32-key
// tile, n_split = ceil(sk / w), the JAX grid's n_kb: both depend on shapes
// and arguments only, so the result does not depend on occupancy or timing
// (serving's bit identity needs that). Inside its split a block walks
// 32-key tiles as flash_fwd.cuh does (mask-free below the diagonal, masked
// across it, no tile past the causal frontier of its last row loaded) and
// writes its normalized partial (out_part = acc / l, lse_part = m + log l)
// to a float32 workspace [n_split, bh, sq, D] / [n_split, bh, sq] that the
// caller allocates. A split wholly past the frontier of the block's last row
// is dead: the block returns at once, loading and writing nothing (the TPU
// side clamps the KV index for this, L666-670 and L1099-1102; prefill
// gathers the whole 4096-key table for every chunk, so most splits of an
// early chunk are dead). Pass 2 (flash_fwd_grid_combine_kernel) merges, for
// each row, the splits that row can see, in split order, with
// merge_attention's maths (port of kernels/flash_attention.py:106):
//   M = max_s lse_s,  w_s = exp(lse_s - M_safe),  out = sum_s w_s out_s / L,
//   lse = M + log L  (L = sum_s w_s; L == 0 gives out 0 and lse -1e30).
// It reads only splits whose first key the row can see (live_kv_splits
// below), which every live block has written, so a dead split is never read
// and never yields exp(-1e30 - -1e30). No atomics: deterministic. With
// n_split == 1 pass 1 writes out and lse directly and pass 2 is not run.
//
// Bound on one H100 SXM: as flash_fwd.cuh (operations 4 * B * H *
// sum_rows(visible keys) * D at 67 TFLOP/s float32 outside the tensor cores;
// bytes q, k, v, out and lse once at 3.35 TB/s). At the long training shape
// (4, 8, 4096, 64) causal that is 68.7 GFLOP, 1.03 ms: operation bound.
// The workspace adds 2 * n_split * bh * sq * (D + 1) * 4 bytes of traffic
// (268 MB written and read at w = 512), 0.16 ms at the memory rate. What
// split-KV buys: the stream body gives a batch-1 prefill chunk 8 * C/32
// blocks, the last of which walks 128 tiles; here each block walks at most
// w/32, and there are n_split times as many blocks to fill 132 SMs.
#pragma once
#include "flash_fwd.cuh"

namespace mx_flash {

// Splits of width w (a multiple of kBlockK) whose first key a query row at
// global position q_pos can see: splits [0, result) are live for the row.
__device__ __forceinline__ int live_kv_splits(int q_pos, int k_base, int w,
                                              int n_split, int causal) {
  if (!causal) return n_split;
  const int rel = q_pos - k_base;
  if (rel < 0) return 0;
  return min(rel / w + 1, n_split);
}

// The first query split (width wq) holding a row that can see the key at
// global position k_pos: splits [result, n_split) are live for the key
// (n_split: none is).
__device__ __forceinline__ int first_live_q_split(int k_pos, int q_base,
                                                  int sq, int wq,
                                                  int n_split, int causal) {
  if (!causal) return 0;
  const int rel = k_pos - q_base;   // the first query row that sees it
  if (rel <= 0) return 0;
  if (rel > sq - 1) return n_split;
  return rel / wq;
}

template <int D, bool kOffs>
__global__ void __launch_bounds__(kThreads)
flash_fwd_grid_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ offs,
                          float* __restrict__ out,
                          float* __restrict__ lse,
                          int sq, int sk, int w, int n_split,
                          float sm_scale, int causal) {
  static_assert(D % (4 * kRowThreads) == 0, "D must be a multiple of 32");
  constexpr int kStride = D + 4;          // padded K/V row (floats)
  constexpr int kPStride = kBlockK + 4;   // padded P row (floats)
  constexpr int kChunks = D / (4 * kRowThreads);  // float4 output chunks
  __shared__ __align__(16) float ks[kBlockK * kStride];
  __shared__ __align__(16) float vs[kBlockK * kStride];
  __shared__ __align__(16) float ps[kBlockQ * kPStride];

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int lane = tid % kRowThreads;
  const int bh = blockIdx.y;
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int qi = q0 + row;
  const bool q_valid = qi < sq;
  const bool direct = n_split == 1;

  const int q_base = kOffs ? offs[0] : 0;
  const int k_base = kOffs ? offs[1] : 0;
  const int q_pos = q_base + qi;
  const int last_q = q_base + min(q0 + kBlockQ, sq) - 1;
  // a dead split: nothing to load, nothing the combine will read
  if (!direct && split >= live_kv_splits(last_q, k_base, w, n_split, causal))
    return;

  const float* qb = q + static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;

  // the query row with sm_scale folded in once (_fold_scale)
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_valid) t = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(qi) * D + d);
    qr[d] = t.x * sm_scale;
    qr[d + 1] = t.y * sm_scale;
    qr[d + 2] = t.z * sm_scale;
    qr[d + 3] = t.w * sm_scale;
  }
  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m_i = kNeg;
  float l_i = 0.f;

  // this split's tiles [t_lo, t_end); of those, [.., full_hi) need no mask,
  // [full_hi, hi) are masked, >= hi skipped (global tile indices)
  const int t_lo = split * (w / kBlockK);
  const int n_tiles = (sk + kBlockK - 1) / kBlockK;
  const int t_end = min(t_lo + w / kBlockK, n_tiles);
  const int n_full = sk / kBlockK;
  int full_hi = n_full;
  int hi = t_end;
  if (causal) {
    const int seen_by_all = q_base + q0 - k_base + 1;  // keys every row sees
    full_hi = seen_by_all <= 0 ? 0 : min(seen_by_all / kBlockK, n_full);
    const int last_key = last_q - k_base;             // last key any row sees
    hi = last_key < 0 ? 0 : min(last_key / kBlockK + 1, t_end);
  }

  for (int t = t_lo; t < hi; ++t) {
    const int kt0 = t * kBlockK;
    __syncthreads();  // the previous tile's shared-memory reads are done
    for (int i = tid; i < kBlockK * D / 4; i += kThreads) {
      const int r = i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (kt0 + r < sk) {
        kk = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(kt0 + r) * D + c);
        vv = *reinterpret_cast<const float4*>(vb + static_cast<size_t>(kt0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(ks + r * kStride + c) = kk;
      *reinterpret_cast<float4*>(vs + r * kStride + c) = vv;
    }
    __syncthreads();

    // scores of keys lane, lane + 8, lane + 16, lane + 24 of the tile
    float s[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(
            ks + (lane + kRowThreads * j) * kStride + d);
        s[j] = fmaf(qr[d], kk.x, s[j]);
        s[j] = fmaf(qr[d + 1], kk.y, s[j]);
        s[j] = fmaf(qr[d + 2], kk.z, s[j]);
        s[j] = fmaf(qr[d + 3], kk.w, s[j]);
      }
    }
    if (t >= full_hi) {
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kj = kt0 + lane + kRowThreads * j;
        const bool visible = kj < sk && (!causal || q_pos >= k_base + kj);
        if (!visible) s[j] = kNeg;
      }
    }
    float m_tile = s[0];
#pragma unroll
    for (int j = 1; j < kKeysPerThread; ++j) m_tile = fmaxf(m_tile, s[j]);
#pragma unroll
    for (int o = 1; o < kRowThreads; o <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
    const float m_new = fmaxf(m_i, m_tile);
    // rows with every key masked so far keep m == -1e30; a safe maximum of
    // 0 makes exp underflow to exactly 0 for them
    const float m_safe = m_new > kNeg / 2 ? m_new : 0.f;
    const float alpha = expf(m_i - m_safe);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p = expf(s[j] - m_safe);
      l_tile += p;
      ps[row * kPStride + lane + kRowThreads * j] = p;
    }
#pragma unroll
    for (int o = 1; o < kRowThreads; o <<= 1)
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, o);
    l_i = l_i * alpha + l_tile;
    m_i = m_new;
    __syncwarp();  // the row's eight threads (one warp) wrote its P

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c][0] *= alpha;
      acc[c][1] *= alpha;
      acc[c][2] *= alpha;
      acc[c][3] *= alpha;
    }
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float p = ps[row * kPStride + j];
      const float* vr = vs + j * kStride + 4 * lane;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * kRowThreads * c);
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
  }

  if (q_valid) {
    const float l_safe = l_i == 0.f ? 1.f : l_i;
    // direct: the final (out, lse); else this split's slot of the workspace
    const size_t r = (direct ? 0 : static_cast<size_t>(split) * gridDim.y * sq) +
                     static_cast<size_t>(bh) * sq + qi;
    float* orow = out + r * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      *reinterpret_cast<float4*>(orow + 4 * kRowThreads * c) = make_float4(
          acc[c][0] / l_safe, acc[c][1] / l_safe, acc[c][2] / l_safe,
          acc[c][3] / l_safe);
    }
    if (lane == 0) {
      const float lse_live = m_i + logf(l_safe);
      // the offset kernel and every partial pin rows that saw no key to
      // -1e30; the plain forward's own formula has no such rows
      lse[r] = (kOffs || !direct) ? (l_i > 0.f ? lse_live : kNeg) : lse_live;
    }
  }
}

// Pass 2: one block per 32 rows of one (b, h); eight threads share a row,
// each owning D/8 output columns, as in pass 1.
template <int D, bool kOffs>
__global__ void __launch_bounds__(kThreads)
flash_fwd_grid_combine_kernel(const int* __restrict__ offs,
                              const float* __restrict__ out_part,
                              const float* __restrict__ lse_part,
                              float* __restrict__ out,
                              float* __restrict__ lse,
                              int sq, int w, int n_split, int causal) {
  constexpr int kChunks = D / (4 * kRowThreads);
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int lane = tid % kRowThreads;
  const int qi = blockIdx.x * kBlockQ + row;
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
  float* orow = out + r * D + 4 * lane;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    *reinterpret_cast<float4*>(orow + 4 * kRowThreads * c) = make_float4(
        acc[c][0] / denom, acc[c][1] / denom, acc[c][2] / denom,
        acc[c][3] / denom);
  }
  if (lane == 0) lse[r] = l > 0.f ? m_safe + logf(denom) : kNeg;
}

// Dispatch on the head dim; return cudaGetLastError() (nonzero: the launch
// was refused, or d is not 32, 64 or 128). Pass 1 writes the workspace
// (out_part, lse_part) when n_split > 1, else out and lse.
template <bool kOffs>
int dispatch_fwd_grid(const float* q, const float* k, const float* v,
                      const int* offs, float* out, float* lse, int bh,
                      int sq, int sk, int d, int w, int n_split,
                      float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh, n_split);
  switch (d) {
#define MX_CASE(D)                                                        \
  case D:                                                                 \
    flash_fwd_grid_f32_kernel<D, kOffs><<<grid, kThreads, 0, s>>>(        \
        q, k, v, offs, out, lse, sq, sk, w, n_split, sm_scale, causal);   \
    break;
    MX_CASE(32) MX_CASE(64) MX_CASE(128)
#undef MX_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kOffs>
int dispatch_fwd_grid_combine(const int* offs, const float* out_part,
                              const float* lse_part, float* out, float* lse,
                              int bh, int sq, int d, int w, int n_split,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  switch (d) {
#define MX_CASE(D)                                                         \
  case D:                                                                  \
    flash_fwd_grid_combine_kernel<D, kOffs><<<grid, kThreads, 0, s>>>(     \
        offs, out_part, lse_part, out, lse, sq, w, n_split, causal);       \
    break;
    MX_CASE(32) MX_CASE(64) MX_CASE(128)
#undef MX_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mx_flash
