// Split-KV flash-attention forward without offsets (causal or not),
// float32, bf16 and float16, for Hopper (sm_90a): the long-context
// training forward of TransformerConfig(attn_variant="grid"). Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (_FlashAttention.forward with
// the grid variant).
//
// Replaces the TPU kernel _flash_fwd_grid_kernel
// (mxnet_tpu/kernels/flash_attention.py:1011, launched by
// _flash_fwd_grid_pallas at L1075). Pass 1 is flash_fwd.cuh's body over
// the key splits (3xTF32 mma.sync products; bound: operations, 0.417 ms at
// q/k/v (4, 8, 4096, 64) causal), pass 2 the combine of flash_fwd_grid.cuh
// (bytes-bound); both with offsets fixed at 0. bf16 and float16 inputs
// take flash_fwd_half.cuh's body over the same splits, one template for
// both (Hopper's warpgroup products, the reference kernel's roundings;
// 0.069 ms of operations at 989 TFLOP/s at that shape), float32 partials,
// and the combine's 16-bit-output instantiation, which rounds out once.
#include "flash_fwd.cuh"
#include "flash_fwd_half.cuh"
#include "flash_fwd_grid.cuh"

using namespace mx_flash;

// q [bh, sq, d], k/v [bh, sk, d] float32, contiguous. n_split == 1: writes
// out [bh, sq, d] and lse [bh, sq]; else the workspace out_part
// [n_split, bh, sq, d] and lse_part [n_split, bh, sq], to be merged by
// mx_flash_fwd_grid_combine_f32. w: keys per split (a multiple of 32),
// n_split = ceil(sk / w). Launches on `stream` without synchronizing and
// returns the CUDA error of the launch (nonzero: refused, or d is not 32,
// 64 or 128).
extern "C" int mx_flash_fwd_grid_f32(const float* q, const float* k,
                                     const float* v, float* out, float* lse,
                                     int bh, int sq, int sk, int d, int w,
                                     int n_split, float sm_scale, int causal,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd<D, false>(q, k, v, nullptr, out, lse, bh, sq,
                                      sk, w, n_split, sm_scale, causal, s)))
}

// Merges the workspace of mx_flash_fwd_grid_f32 into out [bh, sq, d] and
// lse [bh, sq], same stream and error contract.
extern "C" int mx_flash_fwd_grid_combine_f32(const float* out_part,
                                             const float* lse_part,
                                             float* out, float* lse, int bh,
                                             int sq, int d, int w,
                                             int n_split, int causal,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd_grid_combine<D, false, mx_half::F32>(
      nullptr, out_part, lse_part, out, lse, bh, sq, w, n_split, causal, s)))
}

namespace {

// the 16-bit entries below: T is half_mma.cuh's Bf16 or F16
template <typename T>
int fwd_grid_half(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                  void* out, float* lse, int bh, int sq, int sk, int d,
                  int w, int n_split, float sm_scale, int causal,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_half::launch_fwd_half<T, D, false>(
      q, k, v, nullptr, static_cast<uint16_t*>(out), static_cast<float*>(out),
      lse, bh, sq, sk, w, n_split, sm_scale, causal, s)))
}

template <typename T>
int fwd_grid_combine_half(const float* out_part, const float* lse_part,
                          uint16_t* out, float* lse, int bh, int sq, int d,
                          int w, int n_split, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd_grid_combine<D, false, T>(
      nullptr, out_part, lse_part, out, lse, bh, sq, w, n_split, causal, s)))
}

}  // namespace

// As mx_flash_fwd_grid_f32 in bf16 (_bf16) or float16 (_f16): q, k and v
// in the 16-bit type (their bits as uint16_t), lse float32. n_split == 1:
// out is the 16-bit output [bh, sq, d]; else out is the float32 workspace
// [n_split, bh, sq, d] (and lse [n_split, bh, sq]) of normalized,
// unrounded partials, to be merged by the combine entry of the same type.
extern "C" int mx_flash_fwd_grid_bf16(const uint16_t* q, const uint16_t* k,
                                      const uint16_t* v, void* out,
                                      float* lse, int bh, int sq, int sk,
                                      int d, int w, int n_split,
                                      float sm_scale, int causal,
                                      void* stream) {
  return fwd_grid_half<mx_half::Bf16>(q, k, v, out, lse, bh, sq, sk, d, w,
                                      n_split, sm_scale, causal, stream);
}

extern "C" int mx_flash_fwd_grid_f16(const uint16_t* q, const uint16_t* k,
                                     const uint16_t* v, void* out,
                                     float* lse, int bh, int sq, int sk,
                                     int d, int w, int n_split,
                                     float sm_scale, int causal,
                                     void* stream) {
  return fwd_grid_half<mx_half::F16>(q, k, v, out, lse, bh, sq, sk, d, w,
                                     n_split, sm_scale, causal, stream);
}

// Merges the float32 workspace of mx_flash_fwd_grid_bf16 (_f16) into out
// [bh, sq, d] in the 16-bit type (rounded once) and lse [bh, sq] float32.
extern "C" int mx_flash_fwd_grid_combine_bf16(const float* out_part,
                                              const float* lse_part,
                                              uint16_t* out, float* lse,
                                              int bh, int sq, int d, int w,
                                              int n_split, int causal,
                                              void* stream) {
  return fwd_grid_combine_half<mx_half::Bf16>(out_part, lse_part, out, lse,
                                              bh, sq, d, w, n_split, causal,
                                              stream);
}

extern "C" int mx_flash_fwd_grid_combine_f16(const float* out_part,
                                             const float* lse_part,
                                             uint16_t* out, float* lse,
                                             int bh, int sq, int d, int w,
                                             int n_split, int causal,
                                             void* stream) {
  return fwd_grid_combine_half<mx_half::F16>(out_part, lse_part, out, lse,
                                             bh, sq, d, w, n_split, causal,
                                             stream);
}
