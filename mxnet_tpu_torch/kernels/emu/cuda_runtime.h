// A host emulator of the CUDA the port's kernels use, for the
// CPU tests (mxnet_tpu_torch/kernels/_emulate.py builds the kernel sources
// against it with g++). Every block of a launch runs in turn, its threads
// as host threads; __syncthreads, __shfl_xor_sync and mma.sync meet at
// barriers; cp.async copies at once. Shared memory starts as NaN, so a read
// of a word no thread wrote shows in the results.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __align__(x)
#define __grid_constant__

struct emu_uint3 { unsigned x, y, z; };
extern thread_local emu_uint3 threadIdx;
extern emu_uint3 blockIdx, gridDim, blockDim;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a small card: 2 SMs of 2 resident blocks each, so a launch that sizes
// its grid by occupancy runs few blocks and strides
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 2;
  return cudaSuccess;
}

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

void __syncthreads();
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
// cp.async of n bytes, or n zero bytes when !valid
void emu_cp_async(void* dst, const void* src, bool valid, int n);
// mma.sync.m16n8k8 f32.tf32.tf32.f32 for the calling thread's warp
void emu_mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                  const uint32_t (&b)[2]);
// mma.sync.m16n8k16 f32.bf16.bf16.f32 for the calling thread's warp
void emu_mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                  const uint32_t (&b)[2]);
// cvt.rn.bf16x2.f32: (lo, hi) rounded to nearest even, lo in the low half
uint32_t emu_pack_bf16x2(float lo, float hi);
// the block's dynamic shared memory
float* emu_smem();
void emu_launch(dim3 grid, int threads, size_t smem,
                std::function<void()> body);
