// Split-KV causal flash-attention forward at dynamic global offsets,
// float32 and bf16, for Hopper (sm_90a): the long-context prefill attention of
// TransformerConfig(attn_variant="grid"). Built by
// mxnet_tpu_torch/kernels/_build.py into a shared library with a plain C
// interface and called through ctypes from
// mxnet_tpu_torch/kernels/flash_attention.py (flash_attention_with_lse with
// variant="grid").
//
// Replaces the TPU kernel _flash_fwd_offs_grid_kernel
// (mxnet_tpu/kernels/flash_attention.py:594, launched by
// _flash_fwd_offs_grid_pallas at L654). Pass 1 is flash_fwd.cuh's body
// over the key splits, pass 2 the combine of flash_fwd_grid.cuh, both with
// the offsets [q0, k0] read from a device int32[2], so a prefill chunk at
// a new start costs no host round trip, and every block decides on the
// device whether its split is live. Rows with no visible key get out = 0
// and lse = -1e30 exactly. At the last 1024-token chunk of a 3800-token
// prompt (q (1, 8, 1024, 64) at start 2816 against the 4096-key table) the
// work is 7.0 GFLOP, 0.042 ms of float32-accurate tensor-core work (three
// TF32 products each at 495 TFLOP/s): operation bound. bf16 inputs (a
// bf16 model's long prefill) take flash_fwd_bf16.cuh's body over the same
// splits with float32 partials, and the combine's bf16-output
// instantiation (0.0070 ms of operations at 989 TFLOP/s at that chunk).
#include "flash_fwd.cuh"
#include "flash_fwd_bf16.cuh"
#include "flash_fwd_grid.cuh"

using namespace mx_flash;

// As mx_flash_fwd_grid_f32 (flash_fwd_grid.cu), with offs int32[2] on the
// device.
extern "C" int mx_flash_fwd_offs_grid_f32(const float* q, const float* k,
                                          const float* v, const int* offs,
                                          float* out, float* lse, int bh,
                                          int sq, int sk, int d, int w,
                                          int n_split, float sm_scale,
                                          int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd<D, true>(q, k, v, offs, out, lse, bh, sq, sk, w,
                                     n_split, sm_scale, causal, s)))
}

// Merges the workspace of mx_flash_fwd_offs_grid_f32 (same offs) into out
// and lse.
extern "C" int mx_flash_fwd_offs_grid_combine_f32(const int* offs,
                                                  const float* out_part,
                                                  const float* lse_part,
                                                  float* out, float* lse,
                                                  int bh, int sq, int d,
                                                  int w, int n_split,
                                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd_grid_combine<D, true>(
      offs, out_part, lse_part, out, lse, bh, sq, w, n_split, causal, s)))
}

// As mx_flash_fwd_grid_bf16 (flash_fwd_grid.cu), with offs int32[2] on the
// device.
extern "C" int mx_flash_fwd_offs_grid_bf16(const uint16_t* q,
                                           const uint16_t* k,
                                           const uint16_t* v,
                                           const int* offs, void* out,
                                           float* lse, int bh, int sq,
                                           int sk, int d, int w, int n_split,
                                           float sm_scale, int causal,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((mx_flash_bf16::launch_fwd_bf16<D, true>(
      q, k, v, offs, static_cast<uint16_t*>(out), static_cast<float*>(out),
      lse, bh, sq, sk, w, n_split, sm_scale, causal, s)))
}

// Merges the float32 workspace of mx_flash_fwd_offs_grid_bf16 (same offs)
// into out bf16 (rounded once) and lse float32.
extern "C" int mx_flash_fwd_offs_grid_combine_bf16(const int* offs,
                                                   const float* out_part,
                                                   const float* lse_part,
                                                   uint16_t* out, float* lse,
                                                   int bh, int sq, int d,
                                                   int w, int n_split,
                                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH_D((launch_fwd_grid_combine<D, true>(
      offs, out_part, lse_part, out, lse, bh, sq, w, n_split, causal, s)))
}
