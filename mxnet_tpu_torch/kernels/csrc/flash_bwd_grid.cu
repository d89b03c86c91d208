// Split flash-attention backward at dynamic global offsets, float32, for
// Hopper (sm_90a): the long-context training backward of
// TransformerConfig(attn_variant="grid"). Four kernels: dq over key splits,
// dk/dv over query splits, and the two passes that sum the splits. Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (the backward of
// _FlashAttention and _FlashWithLse with the grid variant).
//
// Replaces the TPU kernels _flash_bwd_dq_grid_kernel and
// _flash_bwd_dkv_grid_kernel (mxnet_tpu/kernels/flash_attention.py:722 and
// :772, launched by _flash_bwd_offs_grid_pallas at L827). The function is
// that of flash_bwd_offs.cu:
//   s_ij  = (q_i * sm_scale) . k_j        masked to -1e30 where invisible
//   p_ij  = exp(s_ij - lse_safe_i),        lse_safe = lse > -5e29 ? lse : +1e30
//   ds_ij = p_ij * (do_i . v_j - deff_i),  deff = rowsum(do * out) - dlse
//   dq_i  = sm_scale * sum_j ds_ij k_j
//   dk_j  = sum_i ds_ij (q_i * sm_scale),  dv_j = sum_i p_ij do_i
// with query row i at global position offs[0] + i and key j at offs[1] + j;
// rows with lse pinned to -1e30 contribute exactly 0.
//
// The TPU kernels make the walked axis a sequential grid dimension with a
// VMEM accumulator. Here it becomes a split, as in flash_fwd_grid.cuh:
// - dq: one block per (32 query rows, (b, h), key split of wk keys), wk =
//   the JAX call's block_k rounded up to 32, n_kv_split = ceil(sk / wk). A
//   block walks its split's key tiles up to the causal frontier of its last
//   row and writes the unscaled sum into dq_part[n_kv_split, bh, sq, D].
// - dk/dv: one block per (32 keys, (b, h), query split of wq rows), wq =
//   block_q rounded up to 32 (the JAX dkv grid's third axis). A block walks
//   its split's query tiles from the first that can see its first key and
//   writes dk_part / dv_part[n_q_split, bh, sk, D].
// - The reduce passes sum, for each row (key), the splits it can see, in
//   split order, and apply sm_scale to dq, as the JAX flush does (L767-769).
// A (tile, split) pair that no row of the block can see is dead: the block
// returns at once, loading and writing nothing, and no reduce reads it (the
// split geometry is flash_fwd_grid.cuh's live_kv_splits /
// first_live_q_split, so a read split is always written). With one split
// the kernels write dq (scaled) or dk/dv directly and the reduce is not run.
// No atomics: deterministic.
//
// Bound on one H100 SXM: operations 6 * B * H * sum_rows(visible keys) * D
// for dq and 8 * ... * D for dk/dv (a multiply-add counted as two) at 67
// TFLOP/s for float32 outside the tensor cores; bytes the inputs read once
// and the outputs written once at 3.35 TB/s. At the long training shape
// (4, 8, 4096, 64) causal that is 1.54 ms (dq) and 2.05 ms (dk/dv) of
// operations: operation bound. The workspaces add 2 * n_split * bh * S * D
// * 4 bytes for dq and twice that for dk/dv (268 and 537 MB at w = 512),
// 0.16 and 0.32 ms at the memory rate. Layout, staging and the float32
// CUDA-core products are flash_bwd_offs.cu's (flash_bwd.cuh); wgmma,
// cp.async pipelining and bf16 are later work.
#include "flash_bwd.cuh"
#include "flash_fwd_grid.cuh"

namespace {

using namespace mx_flash_bwd;
using mx_flash::first_live_q_split;
using mx_flash::live_kv_splits;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_grid_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int* __restrict__ offs,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ deff,
                             float* __restrict__ dq,
                             int sq, int sk, int w, int n_split,
                             float sm_scale, int causal) {
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
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + row;
  const bool q_valid = qi < sq;
  const bool direct = n_split == 1;
  const int q_base = offs[0];
  const int k_base = offs[1];
  const int q_pos = q_base + qi;
  const int last_q = q_base + min(q0 + kRows, sq) - 1;
  if (!direct && split >= live_kv_splits(last_q, k_base, w, n_split, causal))
    return;   // dead: no row of the block sees a key of this split

  const size_t qoff = static_cast<size_t>(bh) * sq;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;
  stage_rows<D>(qs, q + qoff * D, q0, sq, sm_scale);  // _fold_scale
  stage_rows<D>(dos, dout + qoff * D, q0, sq, 1.f);
  const float lse_i = q_valid ? lse[qoff + qi] : kNeg;
  const float lse_safe = lse_i > kNeg / 2 ? lse_i : -kNeg;
  const float deff_i = q_valid ? deff[qoff + qi] : 0.f;

  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  // this split's key tiles [t_lo, t_end); [.., full_hi) need no mask,
  // [full_hi, hi) are masked (global tile indices)
  const int t_lo = split * (w / kTile);
  const int n_tiles = (sk + kTile - 1) / kTile;
  const int t_end = min(t_lo + w / kTile, n_tiles);
  const int n_full = sk / kTile;
  int full_hi = n_full;
  int hi = t_end;
  if (causal) {
    const int seen_by_all = q_base + q0 - k_base + 1;
    full_hi = seen_by_all <= 0 ? 0 : min(seen_by_all / kTile, n_full);
    const int last_key = last_q - k_base;
    hi = last_key < 0 ? 0 : min(last_key / kTile + 1, t_end);
  }

  const float* qrow = qs + row * kStride;
  const float* dorow = dos + row * kStride;
  for (int t = t_lo; t < hi; ++t) {
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
    // direct: the final dq; else this split's unscaled slot
    const float scale = direct ? sm_scale : 1.f;
    const size_t r = (direct ? 0 : static_cast<size_t>(split) * gridDim.y * sq) +
                     qoff + qi;
    float* orow = dq + r * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      *reinterpret_cast<float4*>(orow + 4 * kRowThreads * c) = make_float4(
          acc[c][0] * scale, acc[c][1] * scale, acc[c][2] * scale,
          acc[c][3] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_grid_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ offs,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ deff,
                              float* __restrict__ dk,
                              float* __restrict__ dv,
                              int sq, int sk, int w, int n_split,
                              float sm_scale, int causal) {
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
  const int split = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  const int kj = k0 + row;
  const bool direct = n_split == 1;
  const int q_base = offs[0];
  const int k_base = offs[1];
  const int k_pos = k_base + kj;
  if (!direct && split < first_live_q_split(k_base + k0, q_base, sq, w,
                                            n_split, causal))
    return;   // dead: no query of this split sees a key of the block

  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const float* qb = q + qoff * D;
  const float* dob = dout + qoff * D;
  stage_rows<D>(ks, k + koff * D, k0, sk, 1.f);
  stage_rows<D>(vs, v + koff * D, k0, sk, 1.f);

  float acc_k[kChunks][4], acc_v[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    acc_k[c][0] = acc_k[c][1] = acc_k[c][2] = acc_k[c][3] = 0.f;
    acc_v[c][0] = acc_v[c][1] = acc_v[c][2] = acc_v[c][3] = 0.f;
  }

  // this split's query tiles [t_lo, t_end); tiles before lo see no key of
  // the block, [lo, mask_end) are masked, later ones see every key
  const int t_lo = split * (w / kTile);
  const int n_tiles = (sq + kTile - 1) / kTile;
  const int t_end = min(t_lo + w / kTile, n_tiles);
  int lo = t_lo;
  int mask_end = 0;
  if (causal) {
    const int first_key = k_base + k0 - q_base;          // relative to q row 0
    const int last_key = first_key + kRows - 1;
    lo = max(t_lo, first_key <= 0 ? 0 : min(first_key / kTile, n_tiles));
    mask_end = last_key <= 0 ? 0 : min((last_key + kTile - 1) / kTile, n_tiles);
  }

  const float* krow = ks + row * kStride;
  const float* vrow = vs + row * kStride;
  for (int t = lo; t < t_end; ++t) {
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
    // direct: the final dk, dv; else this split's slots
    const size_t r = (direct ? 0 : static_cast<size_t>(split) * gridDim.y * sk) +
                     koff + kj;
    float* krow_out = dk + r * D + 4 * lane;
    float* vrow_out = dv + r * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      *reinterpret_cast<float4*>(krow_out + 4 * kRowThreads * c) = make_float4(
          acc_k[c][0], acc_k[c][1], acc_k[c][2], acc_k[c][3]);
      *reinterpret_cast<float4*>(vrow_out + 4 * kRowThreads * c) = make_float4(
          acc_v[c][0], acc_v[c][1], acc_v[c][2], acc_v[c][3]);
    }
  }
}

// The reduce passes: one block per 32 rows of one (b, h), eight threads to
// a row, each owning D/8 columns. Row r of the output is `scale` times the
// sum over the splits [lo_r, hi_r) that the row can see of part[s, r, :],
// in split order; a row that sees none gets 0. kKeys: the rows are keys
// (dk/dv: splits [first_live_q_split, n_split) of two arrays), else queries
// (dq: splits [0, live_kv_splits) of one).
template <int D, bool kKeys>
__global__ void __launch_bounds__(kThreads)
flash_bwd_grid_reduce_kernel(const int* __restrict__ offs,
                             const float* __restrict__ part_a,
                             const float* __restrict__ part_b,
                             float* __restrict__ out_a,
                             float* __restrict__ out_b,
                             int n_rows, int n_other, int w, int n_split,
                             float scale, int causal) {
  constexpr int kChunks = D / (4 * kRowThreads);
  const int tid = threadIdx.x;
  const int ri = blockIdx.x * kRows + tid / kRowThreads;
  const int lane = tid % kRowThreads;
  if (ri >= n_rows) return;
  int lo = 0;
  int hi = n_split;
  if (kKeys) {
    // n_other = sq: the query splits that see key k_base + ri
    lo = first_live_q_split(offs[1] + ri, offs[0], n_other, w, n_split,
                            causal);
  } else {
    hi = live_kv_splits(offs[0] + ri, offs[1], w, n_split, causal);
  }
  const size_t r = static_cast<size_t>(blockIdx.y) * n_rows + ri;
  const size_t split_rows = static_cast<size_t>(gridDim.y) * n_rows;
  float acc_a[kChunks][4], acc_b[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    acc_a[c][0] = acc_a[c][1] = acc_a[c][2] = acc_a[c][3] = 0.f;
    acc_b[c][0] = acc_b[c][1] = acc_b[c][2] = acc_b[c][3] = 0.f;
  }
  for (int s = lo; s < hi; ++s) {
    const size_t off = (s * split_rows + r) * D + 4 * lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(part_a + off + 4 * kRowThreads * c);
      acc_a[c][0] += a.x;
      acc_a[c][1] += a.y;
      acc_a[c][2] += a.z;
      acc_a[c][3] += a.w;
      if (kKeys) {
        const float4 b = *reinterpret_cast<const float4*>(part_b + off + 4 * kRowThreads * c);
        acc_b[c][0] += b.x;
        acc_b[c][1] += b.y;
        acc_b[c][2] += b.z;
        acc_b[c][3] += b.w;
      }
    }
  }
  const size_t o = r * D + 4 * lane;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    *reinterpret_cast<float4*>(out_a + o + 4 * kRowThreads * c) = make_float4(
        acc_a[c][0] * scale, acc_a[c][1] * scale, acc_a[c][2] * scale,
        acc_a[c][3] * scale);
    if (kKeys)
      *reinterpret_cast<float4*>(out_b + o + 4 * kRowThreads * c) = make_float4(
          acc_b[c][0], acc_b[c][1], acc_b[c][2], acc_b[c][3]);
  }
}

// Kernel `fn` with `smem` bytes of dynamic shared memory: the attribute is
// set once per instantiation (thread-safe static init), before any graph
// capture the caller may start.
template <typename Kernel>
cudaError_t allow_smem(Kernel fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const int* offs, const float* dout, const float* lse,
              const float* deff, float* dq, int bh, int sq, int sk, int w,
              int n_split, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static const cudaError_t err = allow_smem(flash_bwd_dq_grid_f32_kernel<D>,
                                            smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, bh, n_split);
  flash_bwd_dq_grid_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
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
  static const cudaError_t err = allow_smem(flash_bwd_dkv_grid_f32_kernel<D>,
                                            smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kRows - 1) / kRows, bh, n_split);
  flash_bwd_dkv_grid_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, offs, dout, lse, deff, dk, dv, sq, sk, w, n_split, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kKeys>
int launch_reduce(const int* offs, const float* part_a, const float* part_b,
                  float* out_a, float* out_b, int bh, int n_rows,
                  int n_other, int w, int n_split, float scale, int causal,
                  cudaStream_t stream) {
  const dim3 grid((n_rows + kRows - 1) / kRows, bh);
  flash_bwd_grid_reduce_kernel<D, kKeys><<<grid, kThreads, 0, stream>>>(
      offs, part_a, part_b, out_a, out_b, n_rows, n_other, w, n_split, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MX_DISPATCH(call)                                   \
  switch (d) {                                              \
    case 32: { constexpr int D = 32; return call; }         \
    case 64: { constexpr int D = 64; return call; }         \
    case 128: { constexpr int D = 128; return call; }       \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// q/dout [bh, sq, d], k/v [bh, sk, d] float32, contiguous; lse and deff
// [bh, sq] float32; offs int32[2] on the device; wk keys per split (a
// multiple of 32), n_split = ceil(sk / wk). n_split == 1: writes dq [bh, sq,
// d]; else the unscaled workspace dq [n_split, bh, sq, d], to be summed by
// mx_flash_bwd_dq_grid_reduce_f32. Launches on `stream` without
// synchronizing and returns the CUDA error of the launch (nonzero: refused,
// or d is not 32, 64 or 128).
extern "C" int mx_flash_bwd_dq_grid_f32(const float* q, const float* k,
                                        const float* v, const int* offs,
                                        const float* dout, const float* lse,
                                        const float* deff, float* dq, int bh,
                                        int sq, int sk, int d, int wk,
                                        int n_split, float sm_scale,
                                        int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH((launch_dq<D>(q, k, v, offs, dout, lse, deff, dq, bh, sq, sk,
                            wk, n_split, sm_scale, causal, s)))
}

// As above with wq query rows per split, n_split = ceil(sq / wq), writing
// dk and dv [bh, sk, d] (n_split == 1) or the workspaces dk, dv
// [n_split, bh, sk, d], to be summed by mx_flash_bwd_dkv_grid_reduce_f32.
extern "C" int mx_flash_bwd_dkv_grid_f32(const float* q, const float* k,
                                         const float* v, const int* offs,
                                         const float* dout, const float* lse,
                                         const float* deff, float* dk,
                                         float* dv, int bh, int sq, int sk,
                                         int d, int wq, int n_split,
                                         float sm_scale, int causal,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH((launch_dkv<D>(q, k, v, offs, dout, lse, deff, dk, dv, bh, sq,
                             sk, wq, n_split, sm_scale, causal, s)))
}

// dq [bh, sq, d] = sm_scale * the sum of dq_part [n_split, bh, sq, d] over
// the key splits each row sees (the same offs, wk and n_split).
extern "C" int mx_flash_bwd_dq_grid_reduce_f32(const int* offs,
                                               const float* dq_part,
                                               float* dq, int bh, int sq,
                                               int d, int wk, int n_split,
                                               float sm_scale, int causal,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH((launch_reduce<D, false>(offs, dq_part, nullptr, dq, nullptr,
                                       bh, sq, 0, wk, n_split, sm_scale,
                                       causal, s)))
}

// dk, dv [bh, sk, d] = the sums of dk_part, dv_part [n_split, bh, sk, d]
// over the query splits that see each key (the same offs, wq and n_split).
extern "C" int mx_flash_bwd_dkv_grid_reduce_f32(const int* offs,
                                                const float* dk_part,
                                                const float* dv_part,
                                                float* dk, float* dv, int bh,
                                                int sq, int sk, int d,
                                                int wq, int n_split,
                                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH((launch_reduce<D, true>(offs, dk_part, dv_part, dk, dv, bh, sk,
                                      sq, wq, n_split, 1.f, causal, s)))
}
