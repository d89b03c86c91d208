// Causal flash-attention forward at dynamic global offsets, float32, for
// Hopper (sm_90a). Built by mxnet_tpu_torch/kernels/_build.py into a shared
// library with a plain C interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (flash_attention_with_lse).
//
// Replaces the TPU kernel _flash_fwd_offs_kernel
// (mxnet_tpu/kernels/flash_attention.py:285, launched by
// _flash_fwd_offs_pallas at L346). Same function, not the same blocking.
// The body, its bound and its design are in flash_fwd.cuh, shared with
// flash_fwd.cu; this library instantiates it with the offsets [q0, k0] read
// from a device int32[2], so a prefill chunk or a ring step at a new start
// costs no host round trip, and rows with no visible key get out = 0 and
// lse = -1e30.
#include "flash_fwd.cuh"

// q [bh, sq, d], k/v [bh, sk, d], out [bh, sq, d] float32, contiguous;
// lse [bh, sq] float32; offs int32[2] on the device. Launches on `stream`
// without synchronizing and returns cudaGetLastError() (nonzero: the launch
// was refused, or d is not 32, 64 or 128).
extern "C" int mx_flash_fwd_offs_f32(const float* q, const float* k,
                                     const float* v, const int* offs,
                                     float* out, float* lse, int bh, int sq,
                                     int sk, int d, float sm_scale,
                                     int causal, void* stream) {
  return mx_flash::dispatch_fwd<true>(q, k, v, offs, out, lse, bh, sq, sk, d,
                                      sm_scale, causal, stream);
}
