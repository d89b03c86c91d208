// Flash-attention backward at dynamic global offsets, float32, bf16 and
// float16, for Hopper (sm_90a): two kernels, dq and dk/dv. Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (the backward of
// _FlashAttention and of _FlashWithLse).
//
// Replaces the TPU kernels _flash_bwd_dq_offs_kernel and
// _flash_bwd_dkv_offs_kernel (mxnet_tpu/kernels/flash_attention.py:402 and
// :453, launched by _flash_bwd_offs_pallas at L528). The training backward
// runs them at offs = [0, 0] with no lse cotangent, as the JAX package's
// _flash_bwd_pallas does. offs is read on the device.
//
// The body is flash_bwd.cuh's with one split: a block owns 64 query
// rows (dq) or 64 keys (dk/dv) of one (b, h) and walks the whole other axis
// up to the causal frontier, in 64-row tiles (32 at D = 128) double-
// buffered by cp.async, with every product on the tensor cores as three
// TF32 mma.sync products (3xTF32, float32 accuracy). dS and P reach the A
// fragments of the second products straight from the accumulator
// registers, in a permuted order of the contracted axis.
//
// Bound on one H100 SXM: operations 3 * 6 * B * H * sum_rows(visible keys)
// * D (dq) and 3 * 8 * ... * D (dk/dv) at the 495 TFLOP/s dense TF32 rate,
// the least time for float32-accurate products on this card; bytes the
// inputs read once and the outputs written once at 3.35 TB/s. At the
// training shape (B=8, H=8, S=512, D=64, causal) that is 0.0196 ms (dq) and
// 0.0261 ms (dk/dv) of operations against 0.0126 and 0.015 ms of bytes:
// operation bound. bf16 and float16 inputs take flash_bwd_half.cuh's body,
// one template for both (Hopper's warpgroup products, the reference
// kernels' roundings), bytes bound at that shape: 0.0067 ms (dq) and
// 0.0078 ms (dk/dv).
#include "flash_bwd.cuh"
#include "flash_bwd_half.cuh"

using namespace mx_flash_bwd;

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
  MX_DISPATCH_D((launch_dq<D>(q, k, v, offs, dout, lse, deff, dq, bh, sq,
                                sk, sk, 1, sm_scale, causal, s)))
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
  MX_DISPATCH_D((launch_dkv<D>(q, k, v, offs, dout, lse, deff, dk, dv, bh,
                                 sq, sk, sq, 1, sm_scale, causal, s)))
}

namespace {

// the 16-bit entries below: T is half_mma.cuh's Bf16 or F16
template <typename T>
int dq_half(const uint16_t* q, const uint16_t* k, const uint16_t* v,
            const int* offs, const uint16_t* dout, const float* lse,
            const float* deff, uint16_t* dq, int bh, int sq, int sk, int d,
            float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_bwd_half::launch_dq_half<T, D>(
      q, k, v, offs, dout, lse, deff, dq, nullptr, bh, sq, sk, sk, 1,
      sm_scale, causal, s)))
}

template <typename T>
int dkv_half(const uint16_t* q, const uint16_t* k, const uint16_t* v,
             const int* offs, const uint16_t* dout, const float* lse,
             const float* deff, uint16_t* dk, uint16_t* dv, int bh, int sq,
             int sk, int d, float sm_scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_bwd_half::launch_dkv_half<T, D>(
      q, k, v, offs, dout, lse, deff, dk, dv, nullptr, nullptr, bh, sq, sk,
      sq, 1, sm_scale, causal, s)))
}

}  // namespace

// As the two entries above in bf16 (_bf16) or float16 (_f16): q, k, v,
// dout, dq, dk and dv in the 16-bit type (their bits as uint16_t); lse and
// deff float32.
extern "C" int mx_flash_bwd_dq_bf16(const uint16_t* q, const uint16_t* k,
                                    const uint16_t* v, const int* offs,
                                    const uint16_t* dout, const float* lse,
                                    const float* deff, uint16_t* dq, int bh,
                                    int sq, int sk, int d, float sm_scale,
                                    int causal, void* stream) {
  return dq_half<mx_half::Bf16>(q, k, v, offs, dout, lse, deff, dq, bh, sq,
                                sk, d, sm_scale, causal, stream);
}

extern "C" int mx_flash_bwd_dkv_bf16(const uint16_t* q, const uint16_t* k,
                                     const uint16_t* v, const int* offs,
                                     const uint16_t* dout, const float* lse,
                                     const float* deff, uint16_t* dk,
                                     uint16_t* dv, int bh, int sq, int sk,
                                     int d, float sm_scale, int causal,
                                     void* stream) {
  return dkv_half<mx_half::Bf16>(q, k, v, offs, dout, lse, deff, dk, dv, bh,
                                 sq, sk, d, sm_scale, causal, stream);
}

extern "C" int mx_flash_bwd_dq_f16(const uint16_t* q, const uint16_t* k,
                                   const uint16_t* v, const int* offs,
                                   const uint16_t* dout, const float* lse,
                                   const float* deff, uint16_t* dq, int bh,
                                   int sq, int sk, int d, float sm_scale,
                                   int causal, void* stream) {
  return dq_half<mx_half::F16>(q, k, v, offs, dout, lse, deff, dq, bh, sq,
                               sk, d, sm_scale, causal, stream);
}

extern "C" int mx_flash_bwd_dkv_f16(const uint16_t* q, const uint16_t* k,
                                    const uint16_t* v, const int* offs,
                                    const uint16_t* dout, const float* lse,
                                    const float* deff, uint16_t* dk,
                                    uint16_t* dv, int bh, int sq, int sk,
                                    int d, float sm_scale, int causal,
                                    void* stream) {
  return dkv_half<mx_half::F16>(q, k, v, offs, dout, lse, deff, dk, dv, bh,
                                sq, sk, d, sm_scale, causal, stream);
}
