// Causal flash-attention forward at dynamic global offsets, float32, bf16
// and float16, for Hopper (sm_90a): the prefill attention of the serving
// path. Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (flash_attention_with_lse).
//
// Replaces the TPU kernel _flash_fwd_offs_kernel
// (mxnet_tpu/kernels/flash_attention.py:285, launched by
// _flash_fwd_offs_pallas at L346). Same function, not the same blocking.
// The body is flash_fwd.cuh's (3xTF32 mma.sync products, cp.async double
// buffering, 64 query rows a block) with one split over the whole key
// axis, instantiated with the offsets [q0, k0] read from a device
// int32[2], so a prefill chunk or a ring step at a new start costs no host
// round trip; rows with no visible key get out = 0 and lse = -1e30. At
// the serving shapes (q (1, 8, 64 or 256, 64) on 512 keys) it is latency
// bound: 8 or 32 blocks for 132 SMs. bf16 and float16 inputs (a 16-bit
// model's prefill) take flash_fwd_half.cuh's body, one template for both:
// Hopper's warpgroup products, the reference kernel's roundings.
#include "flash_fwd.cuh"
#include "flash_fwd_half.cuh"

using namespace mx_flash;

// q [bh, sq, d], k/v [bh, sk, d], out [bh, sq, d] float32, contiguous;
// lse [bh, sq] float32; offs int32[2] on the device. Launches on `stream`
// without synchronizing and returns the CUDA error of the launch (nonzero:
// refused, or d is not 32, 64 or 128).
extern "C" int mx_flash_fwd_offs_f32(const float* q, const float* k,
                                     const float* v, const int* offs,
                                     float* out, float* lse, int bh, int sq,
                                     int sk, int d, float sm_scale,
                                     int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd<D, true>(q, k, v, offs, out, lse, bh, sq, sk,
                                     sk, 1, sm_scale, causal, s)))
}

namespace {

// the 16-bit entries below: T is half_mma.cuh's Bf16 or F16
template <typename T>
int fwd_offs_half(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                  const int* offs, uint16_t* out, float* lse, int bh, int sq,
                  int sk, int d, float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_half::launch_fwd_half<T, D, true>(
      q, k, v, offs, out, nullptr, lse, bh, sq, sk, sk, 1, sm_scale,
      causal, s)))
}

}  // namespace

// As above in bf16 (_bf16) or float16 (_f16): q, k, v and out in the
// 16-bit type (their bits as uint16_t), lse float32.
extern "C" int mx_flash_fwd_offs_bf16(const uint16_t* q, const uint16_t* k,
                                      const uint16_t* v, const int* offs,
                                      uint16_t* out, float* lse, int bh,
                                      int sq, int sk, int d, float sm_scale,
                                      int causal, void* stream) {
  return fwd_offs_half<mx_half::Bf16>(q, k, v, offs, out, lse, bh, sq, sk,
                                      d, sm_scale, causal, stream);
}

extern "C" int mx_flash_fwd_offs_f16(const uint16_t* q, const uint16_t* k,
                                     const uint16_t* v, const int* offs,
                                     uint16_t* out, float* lse, int bh,
                                     int sq, int sk, int d, float sm_scale,
                                     int causal, void* stream) {
  return fwd_offs_half<mx_half::F16>(q, k, v, offs, out, lse, bh, sq, sk,
                                     d, sm_scale, causal, stream);
}
