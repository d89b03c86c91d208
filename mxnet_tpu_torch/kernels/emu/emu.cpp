// The emulator's runtime (cuda_runtime.h states what it does). One launch
// at a time: a library's state is global.
#include "cuda_runtime.h"

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

thread_local emu_uint3 threadIdx;
emu_uint3 blockIdx, gridDim, blockDim;

namespace {

struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void reset(int n_) { n = n_; count = 0; }
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    cv.wait(lk, [&] { return gen != g; });
  }
};

constexpr int kMaxWarps = 32;
Barrier block_bar;
Barrier warp_bar[kMaxWarps];
float shfl_slot[kMaxWarps][32];
uint32_t mma_a[kMaxWarps][32][4], mma_b[kMaxWarps][32][2];
std::vector<float> smem_buf;

// the value a TF32 operand holds: the tensor cores read 10 mantissa bits
double tf32_value(uint32_t u) { return __uint_as_float(u & 0xFFFFE000u); }

// half `hi` (0: bits 0-15, 1: bits 16-31) of a bf16x2 register
float bf16_value(uint32_t w, int hi) {
  return __uint_as_float(hi ? (w & 0xFFFF0000u) : (w << 16));
}

// x rounded to bf16, to nearest even (a NaN stays a NaN)
uint32_t bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (u >> 16) | 0x40u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

}  // namespace

float* emu_smem() { return smem_buf.data(); }

void __syncthreads() { block_bar.wait(); }

float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  shfl_slot[w][lane] = v;
  warp_bar[w].wait();
  const float r = shfl_slot[w][lane ^ lane_mask];
  warp_bar[w].wait();
  return r;
}

void emu_cp_async(void* dst, const void* src, bool valid, int n) {
  if (valid)
    std::memcpy(dst, src, n);
  else
    std::memset(dst, 0, n);
}

// D = A B + C with the PTX fragment layout of m16n8k8 (g = lane / 4,
// t = lane % 4): a = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4);
// b = B(t, g), B(t + 4, g); c = C(g, 2t), C(g, 2t + 1), C(g + 8, 2t),
// C(g + 8, 2t + 1). Products and sums in double, rounded to float once.
void emu_mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                  const uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int e = 0; e < 4; ++e) mma_a[w][lane][e] = a[e];
  for (int e = 0; e < 2; ++e) mma_b[w][lane][e] = b[e];
  warp_bar[w].wait();
  const int g = lane >> 2, t = lane & 3;
  float d[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double sum = c[e];
    for (int k = 0; k < 8; ++k)
      sum += tf32_value(mma_a[w][4 * (row % 8) + k % 4][(row >= 8) + 2 * (k >= 4)]) *
             tf32_value(mma_b[w][4 * col + k % 4][k >= 4]);
    d[e] = static_cast<float>(sum);
  }
  warp_bar[w].wait();
  for (int e = 0; e < 4; ++e) c[e] = d[e];
}

// D = A B + C with the PTX fragment layout of m16n8k16 with bf16 operands
// (g = lane / 4, t = lane % 4; two bf16 a register, the lower index in
// the low half): a = A(g, 2t..), A(g + 8, 2t..), A(g, 2t + 8..),
// A(g + 8, 2t + 8..); b = B(2t.., g), B(2t + 8.., g); c as m16n8k8.
// Products (exact) and sums in double, rounded to float once.
void emu_mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                  const uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int e = 0; e < 4; ++e) mma_a[w][lane][e] = a[e];
  for (int e = 0; e < 2; ++e) mma_b[w][lane][e] = b[e];
  warp_bar[w].wait();
  const int g = lane >> 2, t = lane & 3;
  float d[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double sum = c[e];
    for (int k = 0; k < 16; ++k) {
      const uint32_t aw =
          mma_a[w][4 * (row % 8) + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)];
      const uint32_t bw = mma_b[w][4 * col + (k % 8) / 2][k >= 8];
      sum += static_cast<double>(bf16_value(aw, k & 1)) *
             bf16_value(bw, k & 1);
    }
    d[e] = static_cast<float>(sum);
  }
  warp_bar[w].wait();
  for (int e = 0; e < 4; ++e) c[e] = d[e];
}

uint32_t emu_pack_bf16x2(float lo, float hi) {
  return bf16_rn(lo) | (bf16_rn(hi) << 16);
}

void emu_launch(dim3 grid, int threads, size_t smem,
                std::function<void()> body) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {static_cast<unsigned>(threads), 1, 1};
  block_bar.reset(threads);
  for (int w = 0; w < kMaxWarps; ++w) warp_bar[w].reset(32);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        smem_buf.assign(smem / sizeof(float) + 1, std::nanf(""));
        std::vector<std::thread> ts;
        for (int i = 0; i < threads; ++i)
          ts.emplace_back([&, i] {
            threadIdx = {static_cast<unsigned>(i), 0, 0};
            body();
          });
        for (auto& th : ts) th.join();
      }
}
