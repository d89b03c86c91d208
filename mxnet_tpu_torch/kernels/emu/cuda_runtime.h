// A host emulator of the CUDA the port's kernels use, for the
// CPU tests (mxnet_tpu_torch/kernels/_emulate.py builds the kernel sources
// against it with g++). Every block of a launch runs in turn, its threads
// as host threads; __syncthreads, __shfl_xor_sync and mma.sync meet at
// barriers; a warpgroup's wgmma runs at the wait_group that retires it,
// the warpgroup meeting there; cp.async copies at once. Shared memory starts as NaN, so a
// read of a word no thread wrote shows in the results.
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
#define __launch_bounds__(...)
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
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
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
[[noreturn]] void __trap();
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
// cp.async of n bytes, or n zero bytes when !valid
void emu_cp_async(void* dst, const void* src, bool valid, int n);
// mma.sync.m16n8k8 f32.tf32.tf32.f32 for the calling thread's warp
void emu_mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                  const uint32_t (&b)[2]);
// wgmma.mma_async.m64nNk16.f32.bf16.bf16 (f16: .f32.f16.f16) for the
// calling thread's warpgroup: d (n / 2 floats a thread) = A B, or += when
// scale_d; A from
// the registers a (4 a thread) or, when a is null, through the shared-memory
// descriptor desc_a; B through desc_b. trans_a / trans_b: 0 K-major, 1
// MN-major. Issued, not run: d reads NaN until the wait_group that
// retires the product, which reads a and the shared tiles then. Aborts on
// a descriptor the warpgroup's threads disagree on; an element outside
// the block's shared memory reads as NaN.
void emu_wgmma(float* d, int n, const uint32_t* a, uint64_t desc_a,
               uint64_t desc_b, int scale_d, int trans_a, int trans_b,
               int f16);
// wgmma.commit_group: the thread's uncommitted products become a group
void emu_wgmma_commit();
// wgmma.wait_group n: runs the thread's committed groups but the n newest,
// the warpgroup meeting once (its last thread to arrive runs every
// thread's products)
void emu_wgmma_wait(int n);
// wgmma.fence: the warpgroup meets
void emu_warpgroup_sync();
// cvt.rn.bf16x2.f32: (lo, hi) rounded to nearest even, lo in the low half
uint32_t emu_pack_bf16x2(float lo, float hi);
// cvt.rn.f16x2.f32: (lo, hi) rounded to nearest even, subnormals kept,
// overflow to inf, lo in the low half
uint32_t emu_pack_f16x2(float lo, float hi);
// cvt.f32.f16: the float16 of bits h
float emu_f16_value(uint16_t h);
// the block's dynamic shared memory
float* emu_smem();
// a shared-memory address: the byte offset into the block's shared memory
inline unsigned __cvta_generic_to_shared(const void* p) {
  return static_cast<unsigned>(static_cast<const char*>(p) -
                               reinterpret_cast<const char*>(emu_smem()));
}
void emu_launch(dim3 grid, int threads, size_t smem,
                std::function<void()> body);
