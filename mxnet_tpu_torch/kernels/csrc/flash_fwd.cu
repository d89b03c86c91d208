// Flash-attention forward without offsets (causal or not), float32, for
// Hopper (sm_90a): the training forward. Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (_FlashAttention.forward).
//
// Replaces the TPU kernel _flash_fwd_kernel
// (mxnet_tpu/kernels/flash_attention.py:205, launched by _flash_fwd_pallas
// at L962). The body, its bound (operations at the training shape: 0.032 ms
// of float32 CUDA-core work against 0.010 ms of bytes for q/k/v
// (8, 8, 512, 64) causal) and its design are in flash_fwd.cuh, shared with
// flash_fwd_offs.cu; this library instantiates it with both offsets fixed
// at 0, so the plain path reads no device offsets.
#include "flash_fwd.cuh"

// q [bh, sq, d], k/v [bh, sk, d], out [bh, sq, d] float32, contiguous;
// lse [bh, sq] float32. Launches on `stream` without synchronizing and
// returns cudaGetLastError() (nonzero: the launch was refused, or d is not
// 32, 64 or 128).
extern "C" int mx_flash_fwd_f32(const float* q, const float* k,
                                const float* v, float* out, float* lse,
                                int bh, int sq, int sk, int d,
                                float sm_scale, int causal, void* stream) {
  return mx_flash::dispatch_fwd<false>(q, k, v, nullptr, out, lse, bh, sq,
                                       sk, d, sm_scale, causal, stream);
}
