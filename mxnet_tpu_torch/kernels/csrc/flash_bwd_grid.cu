// Split flash-attention backward at dynamic global offsets, float32 and
// bf16, for Hopper (sm_90a): the long-context training backward of
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
// that of flash_bwd_offs.cu (flash_bwd.cuh states it).
//
// The TPU kernels make the walked axis a sequential grid dimension with a
// VMEM accumulator. Here it becomes a split, as in the forward
// (flash_fwd.cuh):
// - dq: one block per (64 query rows, (b, h), key split of wk keys), wk =
//   the JAX call's block_k rounded up to 32, n_kv_split = ceil(sk / wk). A
//   block walks its split's keys up to the causal frontier of its last row
//   and writes the unscaled sum into dq_part[n_kv_split, bh, sq, D].
// - dk/dv: one block per (64 keys, (b, h), query split of wq rows), wq =
//   block_q rounded up to 32 (the JAX dkv grid's third axis). A block walks
//   its split's queries from the tile holding the first that sees its first
//   key and writes dk_part / dv_part[n_q_split, bh, sk, D].
// - The reduce passes sum, for each row (key), the splits it can see, in
//   split order, and apply sm_scale to dq, as the JAX flush does (L767-769).
// The split kernels are flash_bwd.cuh's: 3xTF32 mma.sync products,
// cp.async double buffering, 64-row tiles (32 at D = 128) from the split's
// first row, masked past its end (wk and wq are multiples of 32, not of
// 64). A (block, split) pair that no row of the
// block can see is dead: the block returns at once, loading and writing
// nothing, and no reduce reads it (the split geometry is
// flash_split.cuh's live_kv_splits / first_live_q_split, so a read
// split is always written). With one split the kernels write dq (scaled)
// or dk/dv directly and the reduce is not run. No atomics: deterministic.
//
// Bound on one H100 SXM: operations 3 * 6 * B * H * sum_rows(visible keys)
// * D for dq and 3 * 8 * ... * D for dk/dv at the 495 TFLOP/s dense TF32
// rate (three TF32 products for each float32-accurate one); bytes the
// inputs read once and the outputs written once at 3.35 TB/s. At the long
// training shape (4, 8, 4096, 64) causal that is 103.1 and 137.5 GFLOP,
// 0.625 ms (dq) and 0.833 ms (dk/dv): operation bound. The workspaces add
// 2 * n_split * bh * S * D * 4 bytes for dq and twice that for dk/dv (268
// and 537 MB at w = 512), 0.16 and 0.32 ms at the memory rate. The reduce
// passes are bytes-bound and run on CUDA cores, 32 rows a block, eight
// threads to a row.
//
// bf16 inputs take flash_bwd_bf16.cuh's kernels over the same splits
// (Hopper's warpgroup products, the reference kernels' roundings: dS and P
// rounded before their products), writing float32 partials: dq unscaled,
// dk against the folded q. Their reduce passes are the bf16-output
// instantiations: dq summed in split order, times sm_scale, then rounded
// (the reference's L769); dk and dv summed, then rounded (L823-824). At the
// long training shape the 103.1 and 137.5 GFLOP of products above take
// 0.104 ms (dq) and 0.139 ms (dk/dv) at the 989 TFLOP/s dense bf16 rate.
#include "flash_bwd.cuh"
#include "flash_bwd_bf16.cuh"   // and bf16_mma.cuh's store4

namespace {

using mx_flash::first_live_q_split;
using mx_flash::live_kv_splits;

constexpr int kRowThreads = 8;                 // reduce: threads to a row
constexpr int kReduceThreads = 256;
constexpr int kReduceRows = kReduceThreads / kRowThreads;   // 32

// The reduce passes: one block per 32 rows of one (b, h), eight threads to
// a row, each owning D/8 columns. Row r of the output is `scale` times the
// sum over the splits [lo_r, hi_r) that the row can see of part[s, r, :],
// in split order; a row that sees none gets 0. kKeys: the rows are keys
// (dk/dv: splits [first_live_q_split, n_split) of two arrays), else queries
// (dq: splits [0, live_kv_splits) of one). TOut: float, or bf16 (each sum
// rounded once, after the scale).
template <int D, bool kKeys, typename TOut>
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_grid_reduce_kernel(const int* __restrict__ offs,
                             const float* __restrict__ part_a,
                             const float* __restrict__ part_b,
                             TOut* __restrict__ out_a,
                             TOut* __restrict__ out_b,
                             int n_rows, int n_other, int w, int n_split,
                             float scale, int causal) {
  constexpr int kChunks = D / (4 * kRowThreads);
  const int tid = threadIdx.x;
  const int ri = blockIdx.x * kReduceRows + tid / kRowThreads;
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
    mx_bf::store4(out_a + o + 4 * kRowThreads * c, acc_a[c][0] * scale,
                     acc_a[c][1] * scale, acc_a[c][2] * scale,
                     acc_a[c][3] * scale);
    if (kKeys)
      mx_bf::store4(out_b + o + 4 * kRowThreads * c, acc_b[c][0],
                       acc_b[c][1], acc_b[c][2], acc_b[c][3]);
  }
}

template <int D, bool kKeys, typename TOut>
int launch_reduce(const int* offs, const float* part_a, const float* part_b,
                  TOut* out_a, TOut* out_b, int bh, int n_rows,
                  int n_other, int w, int n_split, float scale, int causal,
                  cudaStream_t stream) {
  const dim3 grid((n_rows + kReduceRows - 1) / kReduceRows, bh);
  flash_bwd_grid_reduce_kernel<D, kKeys, TOut><<<grid, kReduceThreads, 0,
                                                 stream>>>(
      offs, part_a, part_b, out_a, out_b, n_rows, n_other, w, n_split, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
  MX_DISPATCH_D((mx_flash_bwd::launch_dq<D>(
      q, k, v, offs, dout, lse, deff, dq, bh, sq, sk, wk, n_split, sm_scale,
      causal, s)))
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
  MX_DISPATCH_D((mx_flash_bwd::launch_dkv<D>(
      q, k, v, offs, dout, lse, deff, dk, dv, bh, sq, sk, wq, n_split,
      sm_scale, causal, s)))
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
  MX_DISPATCH_D((launch_reduce<D, false, float>(offs, dq_part, nullptr, dq,
                                                  nullptr, bh, sq, 0, wk,
                                                  n_split, sm_scale, causal,
                                                  s)))
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
  MX_DISPATCH_D((launch_reduce<D, true, float>(offs, dk_part, dv_part, dk,
                                                 dv, bh, sk, sq, wq, n_split,
                                                 1.f, causal, s)))
}

// As mx_flash_bwd_dq_grid_f32 in bf16: q, k, v and dout bf16 (their bits
// as uint16_t). n_split == 1: dq is the bf16 output [bh, sq, d]; else dq is
// the unscaled float32 workspace [n_split, bh, sq, d], to be summed by
// mx_flash_bwd_dq_grid_reduce_bf16.
extern "C" int mx_flash_bwd_dq_grid_bf16(const uint16_t* q, const uint16_t* k,
                                         const uint16_t* v, const int* offs,
                                         const uint16_t* dout,
                                         const float* lse, const float* deff,
                                         void* dq, int bh, int sq, int sk,
                                         int d, int wk, int n_split,
                                         float sm_scale, int causal,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_bwd_bf16::launch_dq_bf16<D>(
      q, k, v, offs, dout, lse, deff, static_cast<uint16_t*>(dq),
      static_cast<float*>(dq), bh, sq, sk, wk, n_split, sm_scale, causal,
      s)))
}

// As mx_flash_bwd_dkv_grid_f32 in bf16. n_split == 1: dk and dv are the
// bf16 outputs [bh, sk, d]; else the float32 workspaces [n_split, bh, sk,
// d], to be summed by mx_flash_bwd_dkv_grid_reduce_bf16.
extern "C" int mx_flash_bwd_dkv_grid_bf16(const uint16_t* q,
                                          const uint16_t* k,
                                          const uint16_t* v, const int* offs,
                                          const uint16_t* dout,
                                          const float* lse,
                                          const float* deff, void* dk,
                                          void* dv, int bh, int sq, int sk,
                                          int d, int wq, int n_split,
                                          float sm_scale, int causal,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_bwd_bf16::launch_dkv_bf16<D>(
      q, k, v, offs, dout, lse, deff, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), static_cast<float*>(dk),
      static_cast<float*>(dv), bh, sq, sk, wq, n_split, sm_scale, causal,
      s)))
}

// dq [bh, sq, d] bf16 = sm_scale * the float32 sum of dq_part over the key
// splits each row sees, rounded once.
extern "C" int mx_flash_bwd_dq_grid_reduce_bf16(const int* offs,
                                                const float* dq_part,
                                                uint16_t* dq, int bh, int sq,
                                                int d, int wk, int n_split,
                                                float sm_scale, int causal,
                                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_reduce<D, false, uint16_t>(
      offs, dq_part, nullptr, dq, nullptr, bh, sq, 0, wk, n_split, sm_scale,
      causal, s)))
}

// dk, dv [bh, sk, d] bf16 = the float32 sums of dk_part, dv_part over the
// query splits that see each key, each rounded once.
extern "C" int mx_flash_bwd_dkv_grid_reduce_bf16(const int* offs,
                                                 const float* dk_part,
                                                 const float* dv_part,
                                                 uint16_t* dk, uint16_t* dv,
                                                 int bh, int sq, int sk,
                                                 int d, int wq, int n_split,
                                                 int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_reduce<D, true, uint16_t>(
      offs, dk_part, dv_part, dk, dv, bh, sk, sq, wq, n_split, 1.f, causal,
      s)))
}
