// Flash-attention forward without offsets (causal or not), float32, bf16
// and float16, for Hopper (sm_90a): the training forward. Built by
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
// bf16 and float16 inputs take flash_fwd_half.cuh's body, one template for
// both (Hopper's warpgroup products, the reference kernel's roundings):
// 0.0022 ms of operations at 989 TFLOP/s against 0.0052 ms of bytes at
// that shape.
#include "flash_fwd.cuh"
#include "flash_fwd_half.cuh"

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

namespace {

// the 16-bit entries below: T is half_mma.cuh's Bf16 or F16
template <typename T>
int fwd_half(const uint16_t* q, const uint16_t* k, const uint16_t* v,
             uint16_t* out, float* lse, int bh, int sq, int sk, int d,
             float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_half::launch_fwd_half<T, D, false>(
      q, k, v, nullptr, out, nullptr, lse, bh, sq, sk, sk, 1, sm_scale,
      causal, s)))
}

}  // namespace

// As above in bf16 (_bf16) or float16 (_f16): q, k, v and out in the
// 16-bit type (their bits as uint16_t), lse float32.
extern "C" int mx_flash_fwd_bf16(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, uint16_t* out,
                                 float* lse, int bh, int sq, int sk, int d,
                                 float sm_scale, int causal, void* stream) {
  return fwd_half<mx_half::Bf16>(q, k, v, out, lse, bh, sq, sk, d, sm_scale,
                                 causal, stream);
}

extern "C" int mx_flash_fwd_f16(const uint16_t* q, const uint16_t* k,
                                const uint16_t* v, uint16_t* out, float* lse,
                                int bh, int sq, int sk, int d,
                                float sm_scale, int causal, void* stream) {
  return fwd_half<mx_half::F16>(q, k, v, out, lse, bh, sq, sk, d, sm_scale,
                                causal, stream);
}
