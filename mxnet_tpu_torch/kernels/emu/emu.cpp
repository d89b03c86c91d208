// The emulator's runtime (cuda_runtime.h states what it does). One launch
// at a time: a library's state is global.
#include "cuda_runtime.h"

#include <algorithm>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
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
constexpr int kMaxWarpgroups = kMaxWarps / 4;
Barrier block_bar;
Barrier warp_bar[kMaxWarps];
Barrier wg_bar[kMaxWarpgroups];
float shfl_slot[kMaxWarps][32];
uint32_t mma_a[kMaxWarps][32][4], mma_b[kMaxWarps][32][2];
// a warpgroup's wgmma operands: each thread's A registers and descriptors
struct WgmmaSlot {
  uint32_t a[4];
  uint64_t desc_a, desc_b;
  int n, scale_d, regs_a, trans_a, trans_b;
};
WgmmaSlot wg_slot[kMaxWarpgroups][128];
// a product the thread issued and has not waited on: its operands, the
// accumulator it adds to (d_in; empty while a product before it into the
// same registers is pending), and its commit group (-1: not committed)
struct Pending {
  float* d;
  int n;
  const uint32_t* a;
  uint64_t desc_a, desc_b;
  int scale_d, trans_a, trans_b;
  std::vector<float> d_in;
  long group;
};
thread_local std::vector<Pending> pending;
thread_local long n_groups = 0;
std::vector<float> smem_buf;

[[noreturn]] void emu_abort(const char* what) {
  std::fprintf(stderr, "emulated wgmma: %s\n", what);
  std::abort();
}

// element (mn, k) of a wgmma operand through its shared-memory descriptor:
// mn the row of A or the column of B, k < 16 the contracted index. Bits
// 0-13: start address >> 4; 16-29: leading byte offset >> 4; 32-45: stride
// byte offset >> 4; 49-51: base offset (0 here: every tile starts on its
// swizzle atom); 62-63: layout (0 interleaved, 1 128-byte swizzle, 2
// 64-byte, 3 32-byte). Canonical layouts (bytes, W the swizzle width):
// K-major swizzled: row mn at (mn % 8) * W + (mn / 8) * SBO, k at 2k;
// MN-major swizzled: mn at 2 (mn % (W / 2)) + (mn / (W / 2)) * LBO, k at
// (k % 8) * W + (k / 8) * SBO; interleaved (8 x 16-byte core matrices):
// K-major mn at 16 (mn % 8) + (mn / 8) * SBO, k at 2 (k % 8) + (k / 8) * LBO,
// MN-major mn at 2 (mn % 8) + (mn / 8) * SBO, k at 16 (k % 8) + (k / 8) *
// LBO. The swizzle XORs address bits [4, 4 + log2(W / 16)) with the bits
// from 7 up, as the hardware does on the shared-memory address. An element
// past the block's shared memory reads as NaN, as one no thread wrote.
float desc_elem(uint64_t desc, int mn, int k, int mn_major) {
  const size_t start = (desc & 0x3FFF) << 4;
  const size_t lbo = ((desc >> 16) & 0x3FFF) << 4;
  const size_t sbo = ((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 49) & 7) emu_abort("base offset not 0");
  const int layout = static_cast<int>(desc >> 62);
  size_t off;
  if (layout == 0) {
    off = mn_major ? 2 * (mn % 8) + (mn / 8) * sbo + 16 * (k % 8) +
                         (k / 8) * lbo
                   : 16 * (mn % 8) + (mn / 8) * sbo + 2 * (k % 8) +
                         (k / 8) * lbo;
  } else {
    const size_t w = layout == 1 ? 128 : layout == 2 ? 64 : 32;
    off = mn_major ? 2 * (mn % (w / 2)) + (mn / (w / 2)) * lbo +
                         (k % 8) * w + (k / 8) * sbo
                   : (mn % 8) * w + (mn / 8) * sbo + 2 * k;
  }
  size_t addr = start + off;
  if (layout != 0) {
    const size_t w = layout == 1 ? 128 : layout == 2 ? 64 : 32;
    addr ^= ((addr >> 7) & (w / 16 - 1)) << 4;
  }
  if (addr + 2 > smem_buf.size() * sizeof(float))
    return std::nanf("");   // as shared memory no thread wrote
  uint16_t bits;
  std::memcpy(&bits, reinterpret_cast<const char*>(smem_buf.data()) + addr,
              2);
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

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

void __trap() {
  std::fprintf(stderr, "emulated kernel: __trap\n");
  std::abort();
}

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

namespace {

// Runs product p for the calling thread: D = A B (+ D) with the PTX
// fragment layouts of wgmma m64nNk16 (warp w of the warpgroup holds rows
// 16w..16w + 15; g = lane / 4, t = lane % 4): d[4j + e] = D(16w + g + 8
// (e >> 1), 8j + 2t + (e & 1)); an A register a[r] holds A(16w + g + 8
// (r & 1), 2t + 8 (r >> 1) ..+1), the lower index in the low half
// (mma.sync m16n8k16's A). Products (exact) and sums in double, rounded to
// float once. Returns D.
std::vector<float> run_wgmma(const Pending& p) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 127;
  WgmmaSlot& mine = wg_slot[wg][lane];
  for (int e = 0; e < 4; ++e) mine.a[e] = p.a ? p.a[e] : 0u;
  mine.desc_a = p.desc_a;
  mine.desc_b = p.desc_b;
  mine.n = p.n;
  mine.scale_d = p.scale_d;
  mine.regs_a = p.a != nullptr;
  mine.trans_a = p.trans_a;
  mine.trans_b = p.trans_b;
  wg_bar[wg].wait();
  const WgmmaSlot& lead = wg_slot[wg][0];
  if (mine.desc_b != lead.desc_b || mine.n != lead.n ||
      mine.scale_d != lead.scale_d || mine.regs_a != lead.regs_a ||
      mine.trans_b != lead.trans_b ||
      (!mine.regs_a && (mine.desc_a != lead.desc_a ||
                        mine.trans_a != lead.trans_a)))
    emu_abort("the warpgroup's threads disagree on an operand");
  const int n = p.n, w = lane >> 5, g = (lane & 31) >> 2, t = lane & 3;
  std::vector<float> out(n / 2);
  for (int j = 0; j < n / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * w + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
      double sum = p.scale_d ? p.d_in[4 * j + e] : 0.0;
      for (int k = 0; k < 16; ++k) {
        float av;
        if (mine.regs_a) {
          const int holder = 32 * (row / 16) + 4 * (row % 8) + (k % 8) / 2;
          const uint32_t aw =
              wg_slot[wg][holder].a[((row % 16) >= 8) + 2 * (k >= 8)];
          av = bf16_value(aw, k & 1);
        } else {
          av = desc_elem(p.desc_a, row, k, p.trans_a);
        }
        sum += static_cast<double>(av) * desc_elem(p.desc_b, col, k, p.trans_b);
      }
      out[4 * j + e] = static_cast<float>(sum);
    }
  wg_bar[wg].wait();
  return out;
}

}  // namespace

void emu_warpgroup_sync() { wg_bar[threadIdx.x >> 7].wait(); }

void emu_wgmma(float* d, int n, const uint32_t* a, uint64_t desc_a,
               uint64_t desc_b, int scale_d, int trans_a, int trans_b) {
  Pending p{d, n, a, desc_a, desc_b, scale_d, trans_a, trans_b, {}, -1};
  bool chained = false;   // onto a pending product into the same registers
  for (const Pending& q : pending) {
    if (q.d == d && q.n == n)
      chained = true;
    else if (q.d < d + n / 2 && d < q.d + q.n / 2)
      emu_abort("products into overlapping accumulators");
  }
  if (!chained) p.d_in.assign(d, d + n / 2);
  // the accumulators are the product's until its wait
  for (int i = 0; i < n / 2; ++i) d[i] = std::nanf("");
  pending.push_back(std::move(p));
}

void emu_wgmma_commit() {
  for (Pending& p : pending)
    if (p.group < 0) p.group = n_groups;
  ++n_groups;
}

void emu_wgmma_wait(int n) {
  // in issue order: each result goes to the next pending product into the
  // same registers, or to the registers when there is none
  size_t i = 0;
  while (i < pending.size()) {
    Pending& p = pending[i];
    if (p.group < 0 || p.group >= n_groups - n) {
      ++i;
      continue;
    }
    std::vector<float> out = run_wgmma(p);
    auto next = std::find_if(pending.begin() + i + 1, pending.end(),
                             [&](const Pending& q) { return q.d == p.d; });
    if (next != pending.end())
      next->d_in = std::move(out);
    else
      std::copy(out.begin(), out.end(), p.d);
    pending.erase(pending.begin() + i);
  }
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
  for (int w = 0; w < kMaxWarpgroups; ++w) wg_bar[w].reset(128);
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
