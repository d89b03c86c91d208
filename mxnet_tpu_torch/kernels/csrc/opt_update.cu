// Fused optimizer update, float32, for Hopper (sm_90a): the gradient
// prologue g' = clip(g * rescale, -clip, clip) + wd * p fused with the SGD,
// SGD-momentum or Adam update, in place, over a whole table of parameter
// leaves in one launch. Built by mxnet_tpu_torch/kernels/_build.py (with
// --fmad=false) into a shared library with a plain C interface and called
// through ctypes from mxnet_tpu_torch/kernels/opt_update.py.
//
// Replaces the TPU kernels _sgd_kernel, _sgd_mom_kernel and _adam_kernel
// (mxnet_tpu/kernels/opt_update.py:96, 103, 113), launched per leaf by
// _run_leaf_kernel (L130, pallas_call at L151), and the lax tier that the
// JAX package runs beside them for the leaves they reject (L194-238),
// which XLA fuses into the same step program: here every float32 leaf of
// an update goes into the one launch.
//
// Bound: bytes. Per element SGD reads p, g and writes p (12 bytes),
// momentum adds the slot read and write (20 bytes), Adam two slots (28
// bytes), against ~10 float operations: on an H100 (3.35 TB/s, 67 TFLOP/s
// float32) the bytes take ~50x longer than the arithmetic. A ResNet-50
// update is 157 leaves whose median is small (64K elements for the 71
// largest, 3-2048 for the BatchNorm vectors), so a launch a leaf paid a
// launch, a ramp-up and a tail for ~0.4 us of bytes. The design:
// - One launch covers a table of up to kMaxLeaves leaves, passed BY VALUE
//   as the kernel's parameter (__grid_constant__: read in place from the
//   parameter bank, never copied to local memory). No device allocation,
//   no host-to-device copy, and the launch stays capturable in a graph.
// - Every leaf is cut into chunks of kChunk elements; the table keeps each
//   leaf's first chunk (a prefix sum). A grid of min(chunks, SMs x
//   resident blocks) blocks strides over the chunks, so the small leaves
//   share waves with the large ones. A block finds its chunk's leaf by a
//   binary search that is uniform across the block (every thread reads the
//   same parameter words) and only moves forward, since its chunks ascend.
// - Inside a chunk a thread issues kUnroll loads of every operand before
//   its first store: 16-byte float4 loads when the leaf's pointers are all
//   16-byte aligned and its length a multiple of 4 (the record's flag),
//   else 4-byte loads over that leaf alone. kChunk = kThreads x kUnroll
//   float4s, so an aligned chunk is one such round a thread; small chunks
//   keep the tail (the last few chunks, run by few blocks) short.
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
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll * 4;  // elements, 4096
constexpr int kMaxLeaves = 160;                 // ResNet-50 has 157
constexpr int kSgd = 0, kSgdMom = 1, kAdam = 2;

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

// The optimizer's static scalars (those a kind does not use are 0).
struct Hyper {
  float momentum, b1, c1, b2, c2, eps;
};

template <int kKind>
__device__ __forceinline__ void update(float& p, float g, float& s0,
                                       float& s1, float lr, const Hyper& h,
                                       const Prologue& pro) {
  if (kKind == kSgd) {
    sgd(p, g, lr, pro);
  } else if (kKind == kSgdMom) {
    sgd_mom(p, g, s0, lr, h.momentum, pro);
  } else {
    adam(p, g, s0, s1, lr, h.b1, h.c1, h.b2, h.c2, h.eps, pro);
  }
}

// One leaf of a launch: s0 is the momentum or Adam's m, s1 Adam's v.
struct Leaf {
  float* p;
  const float* g;
  float* s0;
  float* s1;
  int64_t n;
  int chunk0;  // chunks of the leaves before this one
  int vec;     // every pointer 16-byte aligned and n % 4 == 0
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
  int chunks;
};

// The update of four neighbours at once (float4 loads and stores).
template <int kKind>
__device__ __forceinline__ void update(float4& p, float4 g, float4& s0,
                                       float4& s1, float lr, const Hyper& h,
                                       const Prologue& pro) {
  update<kKind>(p.x, g.x, s0.x, s1.x, lr, h, pro);
  update<kKind>(p.y, g.y, s0.y, s1.y, lr, h, pro);
  update<kKind>(p.z, g.z, s0.z, s1.z, lr, h, pro);
  update<kKind>(p.w, g.w, s0.w, s1.w, lr, h, pro);
}

// Items [0, n) of one chunk, T = float4 for a leaf whose flag is set, else
// float: every thread loads kUnroll items of each operand before it
// stores any.
template <int kKind, class T>
__device__ __forceinline__ void chunk(T* __restrict__ p,
                                      const T* __restrict__ g,
                                      T* __restrict__ s0, T* __restrict__ s1,
                                      int n, float lr, const Hyper& h,
                                      const Prologue& pro) {
  for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    T a[kUnroll], b[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < n) {
        a[u] = p[i];
        b[u] = g[i];
        if (kKind != kSgd) m[u] = s0[i];
        if (kKind == kAdam) v[u] = s1[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < n) {
        update<kKind>(a[u], b[u], m[u], v[u], lr, h, pro);
        if (kKind != kSgd) s0[i] = m[u];
        if (kKind == kAdam) s1[i] = v[u];
        p[i] = a[u];
      }
    }
  }
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    optupdate_multi_kernel(const __grid_constant__ Table tab,
                           const float* __restrict__ lr_ptr, const Hyper h,
                           const Prologue pro) {
  const float lr = *lr_ptr;
  int li = 0;
  for (int c = blockIdx.x; c < tab.chunks; c += gridDim.x) {
    // the last leaf whose first chunk is <= c
    int hi = tab.count - 1;
    while (li < hi) {
      const int mid = (li + hi + 1) >> 1;
      if (tab.leaf[mid].chunk0 <= c) {
        li = mid;
      } else {
        hi = mid - 1;
      }
    }
    const Leaf& L = tab.leaf[li];
    const int64_t start = (int64_t)(c - L.chunk0) * kChunk;
    const int64_t left = L.n - start;
    const int len = left < kChunk ? (int)left : kChunk;
    if (L.vec) {  // start is a multiple of 4, and so is len
      chunk<kKind>(reinterpret_cast<float4*>(L.p + start),
                   reinterpret_cast<const float4*>(L.g + start),
                   reinterpret_cast<float4*>(L.s0 + start),
                   reinterpret_cast<float4*>(L.s1 + start), len / 4, lr, h,
                   pro);
    } else {
      chunk<kKind>(L.p + start, L.g + start, L.s0 + start, L.s1 + start,
                   len, lr, h, pro);
    }
  }
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15)
         == 0;
}

template <int kKind>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, optupdate_multi_kernel<kKind>, kThreads, 0);
  return n < 1 ? 1 : n;
}

}  // namespace

// The wrapper's record of one leaf (48 bytes): float32 device pointers of
// n >= 1 elements each (s0, s1 null where the update has no such slot),
// and aligned != 0 when all four pointers are 16-byte aligned and
// n % 4 == 0.
struct MxOptLeaf {
  float* p;
  const float* g;
  float* s0;
  float* s1;
  int64_t n;
  int64_t aligned;
};

namespace {

// One launch over records[0, count): the table is checked (count in
// [1, kMaxLeaves], n >= 1, the slots the kind needs present, a set flag
// true) and copied into the kernel's parameter with each leaf's first
// chunk; nothing launches when a check fails.
template <int kKind>
int launch(const MxOptLeaf* records, int count, const float* lr,
           const Hyper& h, const Prologue& pro, void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Table tab;
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) {
    const MxOptLeaf& r = records[i];
    if (r.n < 1 || (kKind != kSgd && !r.s0) || (kKind == kAdam && !r.s1) ||
        (r.aligned && !(r.n % 4 == 0 && aligned16(r.p, r.g, r.s0, r.s1))))
      return (int)cudaErrorInvalidValue;
    tab.leaf[i] = Leaf{r.p, r.g, r.s0, r.s1, r.n, (int)chunks,
                       r.aligned ? 1 : 0};
    chunks += (r.n + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  }
  tab.count = count;
  tab.chunks = (int)chunks;
  static const int per_sm = blocks_per_sm<kKind>();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t most = (int64_t)(sms < 1 ? 1 : sms) * per_sm;
  const int grid = (int)(chunks < most ? chunks : most);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  optupdate_multi_kernel<kKind><<<grid, kThreads, 0, s>>>(tab, lr, h, pro);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry: one launch over `count` leaf records (a host array), each
// updated in place; lr (lc = lr * corr for Adam) is a float32 device
// scalar; the static scalars are already float32; clip != 0 clamps to
// [lo, hi]. Launches on `stream` without synchronizing and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a table the launch
// does not take (nothing launched).
extern "C" int mx_optupdate_multi_sgd_f32(const MxOptLeaf* leaves,
                                          int count, const float* lr,
                                          float rescale, int clip, float lo,
                                          float hi, float wd, void* stream) {
  return launch<kSgd>(leaves, count, lr, Hyper{0, 0, 0, 0, 0, 0},
                      Prologue{rescale, lo, hi, wd, clip}, stream);
}

extern "C" int mx_optupdate_multi_sgd_mom_f32(const MxOptLeaf* leaves,
                                              int count, const float* lr,
                                              float momentum, float rescale,
                                              int clip, float lo, float hi,
                                              float wd, void* stream) {
  return launch<kSgdMom>(leaves, count, lr, Hyper{momentum, 0, 0, 0, 0, 0},
                         Prologue{rescale, lo, hi, wd, clip}, stream);
}

extern "C" int mx_optupdate_multi_adam_f32(const MxOptLeaf* leaves,
                                           int count, const float* lc,
                                           float b1, float c1, float b2,
                                           float c2, float eps,
                                           float rescale, int clip,
                                           float lo, float hi, float wd,
                                           void* stream) {
  return launch<kAdam>(leaves, count, lc, Hyper{0, b1, c1, b2, c2, eps},
                       Prologue{rescale, lo, hi, wd, clip}, stream);
}
