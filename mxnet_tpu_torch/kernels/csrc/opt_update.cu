// Fused optimizer update, float32, for Hopper (sm_90a): the gradient
// prologue g' = clip(g * rescale, -clip, clip) + wd * p fused with the SGD,
// SGD-momentum or Adam update, in place, one pass over each parameter leaf.
// Built by mxnet_tpu_torch/kernels/_build.py (with --fmad=false) into a
// shared library with a plain C interface and called through ctypes from
// mxnet_tpu_torch/kernels/opt_update.py.
//
// Replaces the TPU kernels _sgd_kernel, _sgd_mom_kernel and _adam_kernel
// (mxnet_tpu/kernels/opt_update.py:96, 103, 113), launched per leaf by
// _run_leaf_kernel (L130, pallas_call at L151).
//
// Bound: bytes. Per element SGD reads p, g and writes p (12 bytes),
// momentum adds the slot read and write (20 bytes), Adam two slots (28
// bytes), against ~10 float operations: on an H100 (3.35 TB/s, 67 TFLOP/s
// float32) the bytes take ~50x longer than the arithmetic. The design is
// the plainest one that moves each byte once: a flat grid-stride loop, each
// thread reading p, g and the slots once and writing p and the slots once,
// with 16-byte vector accesses when every pointer is 16-byte aligned
// (eligible leaves hold a multiple of 128 elements) and scalar accesses
// otherwise. The TPU's [rows, 128] x 512-row VMEM blocking is not carried
// over: there is no scratch to stage through, only a stream to sweep.
//
// Bit identity with the plain PyTorch version (fused_update_step_plain):
// each expression keeps the reference's operations and their order, and
// the file builds with --fmad=false so nvcc contracts no a*b + c into an
// FMA (separate torch kernels never do); sqrtf and '/' are IEEE (no
// --use_fast_math). The static scalars arrive already rounded to float32
// from Python doubles (1 - b1 included), as torch and JAX round a Python
// scalar once when it meets a float32 tensor. The clip compares instead of
// calling fminf/fmaxf, so a NaN gradient stays NaN as under torch.clamp.
// lr (or Adam's lr * corr) is read from a device scalar, so a new lr
// changes no launch argument and needs no host sync.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Prologue {
  float rescale, lo, hi, wd;
  int clip;

  __device__ __forceinline__ float operator()(float p, float g) const {
    g = g * rescale;
    if (clip) {
      g = (g < lo) ? lo : g;  // NaN fails both tests and stays NaN
      g = (g > hi) ? hi : g;
    }
    return g + wd * p;
  }
};

__device__ __forceinline__ void sgd(float& p, float g, float lr,
                                    const Prologue& pro) {
  p = p - lr * pro(p, g);
}

__device__ __forceinline__ void sgd_mom(float& p, float g, float& mom,
                                        float lr, float momentum,
                                        const Prologue& pro) {
  const float gp = pro(p, g);
  mom = momentum * mom - lr * gp;
  p = p + mom;
}

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     float lc, float b1, float c1, float b2,
                                     float c2, float eps,
                                     const Prologue& pro) {
  const float gp = pro(p, g);
  m = b1 * m + c1 * gp;
  v = b2 * v + c2 * gp * gp;  // (c2 * g') * g', as the reference associates
  p = p - lc * m / (sqrtf(v) + eps);
}

// One template per update; kVec walks float4s, else floats.
template <bool kVec>
__global__ void sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                           const float* __restrict__ lr_ptr, int64_t n,
                           Prologue pro) {
  const float lr = *lr_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (; i < n / 4; i += stride) {
      float4 a = p4[i];
      const float4 b = g4[i];
      sgd(a.x, b.x, lr, pro); sgd(a.y, b.y, lr, pro);
      sgd(a.z, b.z, lr, pro); sgd(a.w, b.w, lr, pro);
      p4[i] = a;
    }
  } else {
    for (; i < n; i += stride) {
      float a = p[i];
      sgd(a, g[i], lr, pro);
      p[i] = a;
    }
  }
}

template <bool kVec>
__global__ void sgd_mom_kernel(float* __restrict__ p,
                               const float* __restrict__ g,
                               float* __restrict__ mom,
                               const float* __restrict__ lr_ptr, int64_t n,
                               float momentum, Prologue pro) {
  const float lr = *lr_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(mom);
    for (; i < n / 4; i += stride) {
      float4 a = p4[i], m = m4[i];
      const float4 b = g4[i];
      sgd_mom(a.x, b.x, m.x, lr, momentum, pro);
      sgd_mom(a.y, b.y, m.y, lr, momentum, pro);
      sgd_mom(a.z, b.z, m.z, lr, momentum, pro);
      sgd_mom(a.w, b.w, m.w, lr, momentum, pro);
      m4[i] = m;
      p4[i] = a;
    }
  } else {
    for (; i < n; i += stride) {
      float a = p[i], m = mom[i];
      sgd_mom(a, g[i], m, lr, momentum, pro);
      mom[i] = m;
      p[i] = a;
    }
  }
}

template <bool kVec>
__global__ void adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                            float* __restrict__ m_ptr,
                            float* __restrict__ v_ptr,
                            const float* __restrict__ lc_ptr, int64_t n,
                            float b1, float c1, float b2, float c2, float eps,
                            Prologue pro) {
  const float lc = *lc_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m_ptr);
    float4* v4 = reinterpret_cast<float4*>(v_ptr);
    for (; i < n / 4; i += stride) {
      float4 a = p4[i], m = m4[i], v = v4[i];
      const float4 b = g4[i];
      adam(a.x, b.x, m.x, v.x, lc, b1, c1, b2, c2, eps, pro);
      adam(a.y, b.y, m.y, v.y, lc, b1, c1, b2, c2, eps, pro);
      adam(a.z, b.z, m.z, v.z, lc, b1, c1, b2, c2, eps, pro);
      adam(a.w, b.w, m.w, v.w, lc, b1, c1, b2, c2, eps, pro);
      m4[i] = m;
      v4[i] = v;
      p4[i] = a;
    }
  } else {
    for (; i < n; i += stride) {
      float a = p[i], m = m_ptr[i], v = v_ptr[i];
      adam(a, g[i], m, v, lc, b1, c1, b2, c2, eps, pro);
      m_ptr[i] = m;
      v_ptr[i] = v;
      p[i] = a;
    }
  }
}

bool aligned16(const void* a, const void* b, const void* c = nullptr,
               const void* d = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15)
         == 0;
}

int blocks_for(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// Every entry: p, g and the slots are float32 device pointers of n
// elements, updated in place; lr (lc for Adam) is a float32 device scalar;
// the static scalars are already float32; clip != 0 clamps to [lo, hi].
// Launches on `stream` without synchronizing and returns
// cudaGetLastError() (nonzero: the launch was refused).
extern "C" int mx_optupdate_sgd_f32(float* p, const float* g,
                                    const float* lr, int64_t n,
                                    float rescale, int clip, float lo,
                                    float hi, float wd, void* stream) {
  const Prologue pro{rescale, lo, hi, wd, clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && aligned16(p, g)) {
    sgd_kernel<true><<<blocks_for(n / 4), kThreads, 0, s>>>(p, g, lr, n,
                                                            pro);
  } else {
    sgd_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(p, g, lr, n, pro);
  }
  return (int)cudaGetLastError();
}

extern "C" int mx_optupdate_sgd_mom_f32(float* p, const float* g, float* mom,
                                        const float* lr, int64_t n,
                                        float momentum, float rescale,
                                        int clip, float lo, float hi,
                                        float wd, void* stream) {
  const Prologue pro{rescale, lo, hi, wd, clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && aligned16(p, g, mom)) {
    sgd_mom_kernel<true><<<blocks_for(n / 4), kThreads, 0, s>>>(
        p, g, mom, lr, n, momentum, pro);
  } else {
    sgd_mom_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        p, g, mom, lr, n, momentum, pro);
  }
  return (int)cudaGetLastError();
}

extern "C" int mx_optupdate_adam_f32(float* p, const float* g, float* m,
                                     float* v, const float* lc, int64_t n,
                                     float b1, float c1, float b2, float c2,
                                     float eps, float rescale, int clip,
                                     float lo, float hi, float wd,
                                     void* stream) {
  const Prologue pro{rescale, lo, hi, wd, clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && aligned16(p, g, m, v)) {
    adam_kernel<true><<<blocks_for(n / 4), kThreads, 0, s>>>(
        p, g, m, v, lc, n, b1, c1, b2, c2, eps, pro);
  } else {
    adam_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        p, g, m, v, lc, n, b1, c1, b2, c2, eps, pro);
  }
  return (int)cudaGetLastError();
}
