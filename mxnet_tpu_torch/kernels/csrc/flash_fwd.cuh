// Flash-attention forward body shared by flash_fwd_offs.cu (TPU kernel
// _flash_fwd_offs_kernel, global offsets read on the device) and
// flash_fwd.cu (TPU kernel _flash_fwd_kernel, no offsets), float32, for
// Hopper (sm_90a). Each .cu includes this header and defines its own C
// entry, so the two are separate libraries with separate launch counters.
//
// Function:
//   out[b,h,i,:] = softmax_j(s_ij) v[b,h,j,:],  s_ij = (q_i * sm_scale) . k_j
// with query row i at global position q0 + i and key j at k0 + j, where
// [q0, k0] = offs[0..1] when kOffs and [0, 0] otherwise; under `causal` a
// key is visible iff its position <= the query's. Rows with no visible key
// get out = 0 and lse = -1e30 (the convention merge_attention relies on;
// without offsets no row is fully masked). lse = m + log(l) in float32.
//
// Bound on one H100 SXM: operations are 4 * B * H * sum_rows(visible keys)
// * D (QK^T and PV, a multiply-add counted as two), at 67 TFLOP/s for
// float32 outside the tensor cores; bytes are q, k, v and out read or
// written once plus the lse, at 3.35 TB/s. At the training shape
// (B=8, H=8, S=512, D=64, causal) that is 0.032 ms of operations against
// 0.010 ms of bytes: operation bound. At the serving shapes (B=1, H=8,
// C in {64, 256} query rows, 512 keys) the kernel is latency bound, with
// only C/32 * 8 = 16..64 blocks for 132 SMs.
//
// What the design does about it: each block owns 32 query rows of one
// (b, h) and walks the key axis in 32-key tiles staged in shared memory,
// with the online-softmax state (m, l and the output accumulator) in
// float32 registers, so q, k and v are read from device memory once per
// block and nothing else is. Eight threads share a query row: each computes
// four of the tile's 32 scores with independent accumulators (ILP for the
// few warps an SM holds) and owns D/8 output columns; the row's max and sum
// are combined with warp shuffles. Tiles wholly below the causal diagonal
// run without a mask, tiles across it are masked, and tiles past the causal
// frontier of the block's last row are never loaded (the TPU kernels' loop
// split). Shared-memory rows are padded by four floats so the float4 reads
// of the eight threads of a row fall in distinct banks. Products run on
// CUDA cores in full float32 (no TF32). Splitting the key axis across
// blocks (flash-decoding) to fill the card, cp.async double buffering and
// wgmma are later work.
#pragma once
#include <cuda_runtime.h>

namespace mx_flash {

constexpr int kRowThreads = 8;                  // threads sharing one query row
constexpr int kThreads = 256;
constexpr int kBlockQ = kThreads / kRowThreads;  // 32 query rows per block
constexpr int kBlockK = 32;                     // keys per shared-memory tile
constexpr int kKeysPerThread = kBlockK / kRowThreads;
constexpr float kNeg = -1e30f;

template <int D, bool kOffs>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ offs,
                     float* __restrict__ out,
                     float* __restrict__ lse,
                     int sq, int sk, float sm_scale, int causal) {
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
  const int q0 = blockIdx.x * kBlockQ;
  const int qi = q0 + row;
  const bool q_valid = qi < sq;
  const float* qb = q + static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;

  // offsets read on the device: the analog of scalar prefetch, so a
  // prefill chunk at a new start costs no host round trip
  const int q_base = kOffs ? offs[0] : 0;
  const int k_base = kOffs ? offs[1] : 0;
  const int q_pos = q_base + qi;

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

  // tiles [0, full_hi) need no mask; [full_hi, hi) are masked; >= hi skipped
  const int n_tiles = (sk + kBlockK - 1) / kBlockK;
  const int n_full = sk / kBlockK;
  int full_hi = n_full;
  int hi = n_tiles;
  if (causal) {
    const int first_q = q_base + q0;
    const int last_q = q_base + min(q0 + kBlockQ, sq) - 1;
    const int seen_by_all = first_q - k_base + 1;  // keys every row sees
    full_hi = seen_by_all <= 0 ? 0 : min(seen_by_all / kBlockK, n_full);
    const int last_key = last_q - k_base;          // last key any row sees
    hi = last_key < 0 ? 0 : min(last_key / kBlockK + 1, n_tiles);
    hi = max(hi, full_hi);
  }

  for (int t = 0; t < hi; ++t) {
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
    float* orow = out + (static_cast<size_t>(bh) * sq + qi) * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      *reinterpret_cast<float4*>(orow + 4 * kRowThreads * c) = make_float4(
          acc[c][0] / l_safe, acc[c][1] / l_safe, acc[c][2] / l_safe,
          acc[c][3] / l_safe);
    }
    if (lane == 0)
      lse[static_cast<size_t>(bh) * sq + qi] =
          l_i > 0.f ? m_i + logf(l_safe) : kNeg;
  }
}

template <int D, bool kOffs>
void launch_fwd(const float* q, const float* k, const float* v,
                const int* offs, float* out, float* lse, int bh, int sq,
                int sk, float sm_scale, int causal, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_f32_kernel<D, kOffs><<<grid, kThreads, 0, stream>>>(
      q, k, v, offs, out, lse, sq, sk, sm_scale, causal);
}

// Dispatch on the head dim; returns cudaGetLastError() (nonzero: the launch
// was refused, or d is not 32, 64 or 128).
template <bool kOffs>
int dispatch_fwd(const float* q, const float* k, const float* v,
                 const int* offs, float* out, float* lse, int bh, int sq,
                 int sk, int d, float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: launch_fwd<32, kOffs>(q, k, v, offs, out, lse, bh, sq, sk, sm_scale, causal, s); break;
    case 64: launch_fwd<64, kOffs>(q, k, v, offs, out, lse, bh, sq, sk, sm_scale, causal, s); break;
    case 128: launch_fwd<128, kOffs>(q, k, v, offs, out, lse, bh, sq, sk, sm_scale, causal, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mx_flash
