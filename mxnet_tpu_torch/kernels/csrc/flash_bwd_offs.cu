// Flash-attention backward at dynamic global offsets, float32, for Hopper
// (sm_90a): two kernels, dq and dk/dv. Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (the backward of
// _FlashAttention and of _FlashWithLse).
//
// Replaces the TPU kernels _flash_bwd_dq_offs_kernel and
// _flash_bwd_dkv_offs_kernel (mxnet_tpu/kernels/flash_attention.py:402 and
// :453, launched by _flash_bwd_offs_pallas at L528). The training backward
// runs them at offs = [0, 0] with no lse cotangent, as the JAX package's
// _flash_bwd_pallas does. Same function, not the same blocking:
//   s_ij  = (q_i * sm_scale) . k_j        masked to -1e30 where invisible
//   p_ij  = exp(s_ij - lse_safe_i),        lse_safe = lse > -5e29 ? lse : +1e30
//   ds_ij = p_ij * (do_i . v_j - deff_i),  deff = rowsum(do * out) - dlse
//   dq_i  = sm_scale * sum_j ds_ij k_j
//   dk_j  = sum_i ds_ij (q_i * sm_scale)   (the folded q: no further scale)
//   dv_j  = sum_i p_ij do_i
// with query row i at global position offs[0] + i and key j at offs[1] + j.
// The +1e30 substitute keeps rows with no visible key (a ring step ahead of
// the causal frontier, lse pinned to -1e30) at exactly zero: exp(-1e30 -
// -1e30) would be 1. deff is computed by the caller in plain torch, as
// _bwd_staging does in jnp.
//
// Bound on one H100 SXM: operations are 6 * B * H * sum_rows(visible keys)
// * D for dq (s, dp and ds.k) and 8 * ... * D for dk/dv (s, dp, p^T.do and
// ds^T.q), a multiply-add counted as two, at 67 TFLOP/s for float32 outside
// the tensor cores; bytes are the inputs read once and the outputs written
// once, at 3.35 TB/s. At the training shape (B=8, H=8, S=512, D=64, causal)
// that is 0.048 ms (dq) and 0.064 ms (dk/dv) of operations against ~0.013
// and ~0.015 ms of bytes: operation bound.
//
// What the design does about it: each block owns 32 rows (query rows for
// dq, key rows for dk/dv) of one (b, h), stages its own q and do (dq) or k
// and v (dk/dv) in shared memory once, and walks the other axis in 32-row
// tiles staged in shared memory, so every input is read from device memory
// once per block and the accumulators stay in float32 registers. Eight
// threads share a row: each computes four of the tile's 32 scores and dp
// values, writes p (and ds) into a shared row, and owns D/8 output columns
// for the accumulation, as in flash_fwd.cuh. A block owns its output rows,
// so there are no atomics and the result is deterministic. Tiles that no row
// of the block can see under the causal mask are never loaded (the loop
// bounds of the TPU kernels, L440-442 and L496-498); tiles wholly on one side
// of the diagonal skip the mask. Products run on CUDA cores in full float32
// (no TF32); at D=128 the staged tiles exceed 48 KB of shared memory and the
// kernels take it as dynamic shared memory. wgmma, cp.async pipelining and
// bf16 are later work.
#include "flash_bwd.cuh"

namespace {

using namespace mx_flash_bwd;

// One block: 32 query rows of one (b, h). Walks key tiles up to the causal
// frontier of its last row.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ offs,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ deff,
                        float* __restrict__ dq,
                        int sq, int sk, float sm_scale, int causal) {
  constexpr int kStride = stride<D>();
  constexpr int kChunks = D / (4 * kRowThreads);  // float4 output chunks
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kRows][kStride] folded q
  float* dos = qs + kRows * kStride;      // [kRows][kStride] do
  float* ks = dos + kRows * kStride;      // [kTile][kStride]
  float* vs = ks + kTile * kStride;       // [kTile][kStride]
  float* dss = vs + kTile * kStride;      // [kRows][kPStride] ds

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int lane = tid % kRowThreads;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + row;
  const bool q_valid = qi < sq;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;
  const int q_base = offs[0];
  const int k_base = offs[1];
  const int q_pos = q_base + qi;

  stage_rows<D>(qs, q + qoff * D, q0, sq, sm_scale);  // _fold_scale
  stage_rows<D>(dos, dout + qoff * D, q0, sq, 1.f);
  const float lse_i = q_valid ? lse[qoff + qi] : kNeg;
  const float lse_safe = lse_i > kNeg / 2 ? lse_i : -kNeg;
  const float deff_i = q_valid ? deff[qoff + qi] : 0.f;

  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  // key tiles [0, full_hi) need no mask; [full_hi, hi) are masked
  const int n_tiles = (sk + kTile - 1) / kTile;
  const int n_full = sk / kTile;
  int full_hi = n_full;
  int hi = n_tiles;
  if (causal) {
    const int first_q = q_base + q0;
    const int last_q = q_base + min(q0 + kRows, sq) - 1;
    const int seen_by_all = first_q - k_base + 1;
    full_hi = seen_by_all <= 0 ? 0 : min(seen_by_all / kTile, n_full);
    const int last_key = last_q - k_base;
    hi = last_key < 0 ? 0 : min(last_key / kTile + 1, n_tiles);
    hi = max(hi, full_hi);
  }

  const float* qrow = qs + row * kStride;
  const float* dorow = dos + row * kStride;
  for (int t = 0; t < hi; ++t) {
    const int kt0 = t * kTile;
    __syncthreads();  // staging done / the previous tile's reads are done
    stage_rows<D>(ks, kb, kt0, sk, 1.f);
    stage_rows<D>(vs, vb, kt0, sk, 1.f);
    __syncthreads();

    float s[kPerThread], dp[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s[j] = dp[j] = 0.f;
    dot4x2<D>(qrow, ks, dorow, vs, lane, s, dp);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int kj = kt0 + lane + kRowThreads * j;
      if (t >= full_hi && !(kj < sk && (!causal || q_pos >= k_base + kj)))
        s[j] = kNeg;
      const float p = expf(s[j] - lse_safe);
      dss[row * kPStride + lane + kRowThreads * j] = p * (dp[j] - deff_i);
    }
    __syncwarp();  // the row's eight threads (one warp) wrote its ds

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float ds = dss[row * kPStride + j];
      const float* kr = ks + j * kStride + 4 * lane;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * kRowThreads * c);
        acc[c][0] = fmaf(ds, kk.x, acc[c][0]);
        acc[c][1] = fmaf(ds, kk.y, acc[c][1]);
        acc[c][2] = fmaf(ds, kk.z, acc[c][2]);
        acc[c][3] = fmaf(ds, kk.w, acc[c][3]);
      }
    }
  }

  if (q_valid) {
    float* orow = dq + (qoff + qi) * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      *reinterpret_cast<float4*>(orow + 4 * kRowThreads * c) = make_float4(
          acc[c][0] * sm_scale, acc[c][1] * sm_scale, acc[c][2] * sm_scale,
          acc[c][3] * sm_scale);
    }
  }
}

// One block: 32 key rows of one (b, h). Walks query tiles from the first one
// whose rows can see the block's first key.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ offs,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ deff,
                         float* __restrict__ dk,
                         float* __restrict__ dv,
                         int sq, int sk, float sm_scale, int causal) {
  constexpr int kStride = stride<D>();
  constexpr int kChunks = D / (4 * kRowThreads);
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [kRows][kStride]
  float* vs = ks + kRows * kStride;       // [kRows][kStride]
  float* qs = vs + kRows * kStride;       // [kTile][kStride] folded q
  float* dos = qs + kTile * kStride;      // [kTile][kStride] do
  float* pt = dos + kTile * kStride;      // [kRows][kPStride] p, key-major
  float* dst = pt + kRows * kPStride;     // [kRows][kPStride] ds, key-major
  float* lse_s = dst + kRows * kPStride;  // [kTile] lse_safe
  float* deff_s = lse_s + kTile;          // [kTile]

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int lane = tid % kRowThreads;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int kj = k0 + row;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const float* qb = q + qoff * D;
  const float* dob = dout + qoff * D;
  const int q_base = offs[0];
  const int k_base = offs[1];
  const int k_pos = k_base + kj;

  stage_rows<D>(ks, k + koff * D, k0, sk, 1.f);
  stage_rows<D>(vs, v + koff * D, k0, sk, 1.f);

  float acc_k[kChunks][4], acc_v[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    acc_k[c][0] = acc_k[c][1] = acc_k[c][2] = acc_k[c][3] = 0.f;
    acc_v[c][0] = acc_v[c][1] = acc_v[c][2] = acc_v[c][3] = 0.f;
  }

  // query tiles [lo, mask_end) are masked, [mask_end, n) see every key of
  // the block, tiles before lo see none of them
  const int n_tiles = (sq + kTile - 1) / kTile;
  int lo = 0;
  int mask_end = 0;
  if (causal) {
    const int first_key = k_base + k0 - q_base;          // relative to q row 0
    const int last_key = first_key + kRows - 1;
    lo = first_key <= 0 ? 0 : min(first_key / kTile, n_tiles);
    mask_end = last_key <= 0 ? 0 : min((last_key + kTile - 1) / kTile, n_tiles);
    mask_end = max(mask_end, lo);
  }

  const float* krow = ks + row * kStride;
  const float* vrow = vs + row * kStride;
  for (int t = lo; t < n_tiles; ++t) {
    const int qt0 = t * kTile;
    __syncthreads();  // staging done / the previous tile's reads are done
    stage_rows<D>(qs, qb, qt0, sq, sm_scale);  // _fold_scale
    stage_rows<D>(dos, dob, qt0, sq, 1.f);
    if (tid < kTile) {
      const int i = qt0 + tid;
      const float l = i < sq ? lse[qoff + i] : kNeg;
      lse_s[tid] = l > kNeg / 2 ? l : -kNeg;  // padding rows: p == 0
      deff_s[tid] = i < sq ? deff[qoff + i] : 0.f;
    }
    __syncthreads();

    float s[kPerThread], dp[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s[j] = dp[j] = 0.f;
    dot4x2<D>(krow, qs, vrow, dos, lane, s, dp);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = lane + kRowThreads * j;
      if (t < mask_end && q_base + qt0 + i < k_pos) s[j] = kNeg;
      const float p = expf(s[j] - lse_s[i]);
      pt[row * kPStride + i] = p;
      dst[row * kPStride + i] = p * (dp[j] - deff_s[i]);
    }
    __syncwarp();  // the row's eight threads (one warp) wrote its p and ds

#pragma unroll 8
    for (int i = 0; i < kTile; ++i) {
      const float p = pt[row * kPStride + i];
      const float ds = dst[row * kPStride + i];
      const float* dor = dos + i * kStride + 4 * lane;
      const float* qr = qs + i * kStride + 4 * lane;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 dd = *reinterpret_cast<const float4*>(dor + 4 * kRowThreads * c);
        const float4 qq = *reinterpret_cast<const float4*>(qr + 4 * kRowThreads * c);
        acc_v[c][0] = fmaf(p, dd.x, acc_v[c][0]);
        acc_v[c][1] = fmaf(p, dd.y, acc_v[c][1]);
        acc_v[c][2] = fmaf(p, dd.z, acc_v[c][2]);
        acc_v[c][3] = fmaf(p, dd.w, acc_v[c][3]);
        acc_k[c][0] = fmaf(ds, qq.x, acc_k[c][0]);
        acc_k[c][1] = fmaf(ds, qq.y, acc_k[c][1]);
        acc_k[c][2] = fmaf(ds, qq.z, acc_k[c][2]);
        acc_k[c][3] = fmaf(ds, qq.w, acc_k[c][3]);
      }
    }
  }

  if (kj < sk) {
    float* krow_out = dk + (koff + kj) * D + 4 * lane;
    float* vrow_out = dv + (koff + kj) * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      *reinterpret_cast<float4*>(krow_out + 4 * kRowThreads * c) = make_float4(
          acc_k[c][0], acc_k[c][1], acc_k[c][2], acc_k[c][3]);
      *reinterpret_cast<float4*>(vrow_out + 4 * kRowThreads * c) = make_float4(
          acc_v[c][0], acc_v[c][1], acc_v[c][2], acc_v[c][3]);
    }
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const int* offs,
              const float* dout, const float* lse, const float* deff,
              float* dq, int bh, int sq, int sk, float sm_scale, int causal,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  // once per instantiation (thread-safe static init), before any graph
  // capture the caller may start
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dq, sq, sk, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const int* offs, const float* dout, const float* lse,
               const float* deff, float* dk, float* dv, int bh, int sq,
               int sk, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  // once per instantiation (thread-safe static init), before any graph
  // capture the caller may start
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kRows - 1) / kRows, bh);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dk, dv, sq, sk, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/dout/dq [bh, sq, d], k/v [bh, sk, d] float32, contiguous; lse and deff
// [bh, sq] float32; offs int32[2] on the device. Launches on `stream`
// without synchronizing and returns the CUDA error of the launch (nonzero:
// refused, or d is not 32, 64 or 128).
extern "C" int mx_flash_bwd_dq_f32(const float* q, const float* k,
                                   const float* v, const int* offs,
                                   const float* dout, const float* lse,
                                   const float* deff, float* dq, int bh,
                                   int sq, int sk, int d, float sm_scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dq<32>(q, k, v, offs, dout, lse, deff, dq, bh, sq, sk, sm_scale, causal, s);
    case 64: return launch_dq<64>(q, k, v, offs, dout, lse, deff, dq, bh, sq, sk, sm_scale, causal, s);
    case 128: return launch_dq<128>(q, k, v, offs, dout, lse, deff, dq, bh, sq, sk, sm_scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above, writing dk and dv [bh, sk, d] float32.
extern "C" int mx_flash_bwd_dkv_f32(const float* q, const float* k,
                                    const float* v, const int* offs,
                                    const float* dout, const float* lse,
                                    const float* deff, float* dk, float* dv,
                                    int bh, int sq, int sk, int d,
                                    float sm_scale, int causal,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv<32>(q, k, v, offs, dout, lse, deff, dk, dv, bh, sq, sk, sm_scale, causal, s);
    case 64: return launch_dkv<64>(q, k, v, offs, dout, lse, deff, dk, dv, bh, sq, sk, sm_scale, causal, s);
    case 128: return launch_dkv<128>(q, k, v, offs, dout, lse, deff, dk, dv, bh, sq, sk, sm_scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
