// Flash-attention forward without offsets (causal or not), float32 and
// bf16, for Hopper (sm_90a): the training forward. Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (_FlashAttention.forward).
//
// Replaces the TPU kernel _flash_fwd_kernel
// (mxnet_tpu/kernels/flash_attention.py:205, launched by _flash_fwd_pallas
// at L962). The body is flash_fwd.cuh's (3xTF32 mma.sync products,
// cp.async double buffering, 64 query rows a block), instantiated with both
// offsets fixed at 0, so the plain path reads no device offsets, and one
// split over the whole key axis. Bound: operations, 0.0130 ms of
// float32-accurate tensor-core work (three TF32 products each at 495
// TFLOP/s) at q/k/v (8, 8, 512, 64) causal, against 0.010 ms of bytes.
// bf16 inputs take flash_fwd_bf16.cuh's body (Hopper's warpgroup
// products, the reference kernel's roundings): 0.0022 ms of operations at 989
// TFLOP/s against 0.0052 ms of bytes at that shape.
#include "flash_fwd.cuh"
#include "flash_fwd_bf16.cuh"

using namespace mx_flash;

// q [bh, sq, d], k/v [bh, sk, d], out [bh, sq, d] float32, contiguous;
// lse [bh, sq] float32. Launches on `stream` without synchronizing and
// returns the CUDA error of the launch (nonzero: refused, or d is not 32,
// 64 or 128).
extern "C" int mx_flash_fwd_f32(const float* q, const float* k,
                                const float* v, float* out, float* lse,
                                int bh, int sq, int sk, int d,
                                float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd<D, false>(q, k, v, nullptr, out, lse, bh, sq,
                                      sk, sk, 1, sm_scale, causal, s)))
}

// As above in bf16: q, k, v and out bf16 (their bits as uint16_t), lse
// float32.
extern "C" int mx_flash_fwd_bf16(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, uint16_t* out,
                                 float* lse, int bh, int sq, int sk, int d,
                                 float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_bf16::launch_fwd_bf16<D, false>(
      q, k, v, nullptr, out, nullptr, lse, bh, sq, sk, sk, 1, sm_scale,
      causal, s)))
}
