// The emulator's runtime (cuda_runtime.h states what it does). One launch
// at a time: a library's state is global.
#include "cuda_runtime.h"

#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

thread_local emu_uint3 threadIdx;
emu_uint3 blockIdx, gridDim, blockDim;

namespace {

// n threads meet: the last to arrive runs ``last`` (while the others
// still wait) and opens the next generation. The waiters sleep on the
// generation's word (a futex, no spinning: the tests run many emulated
// blocks beside other work), not behind a mutex, so a release wakes them
// without a convoy
struct Barrier {
  std::atomic<int> count{0};
  std::atomic<int> gen{0};
  int n = 0;
  void reset(int n_) { n = n_; count.store(0); }
  int* word() { return reinterpret_cast<int*>(&gen); }
  void wait() { wait([] {}); }
  template <class F>
  void wait(F&& last) {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      last();
      count.store(0, std::memory_order_relaxed);
      gen.store(g + 1, std::memory_order_release);
      syscall(SYS_futex, word(), FUTEX_WAKE_PRIVATE, INT_MAX, nullptr,
              nullptr, 0);
      return;
    }
    while (gen.load(std::memory_order_acquire) == g)
      syscall(SYS_futex, word(), FUTEX_WAIT_PRIVATE, g, nullptr, nullptr,
              0);
  }
};

constexpr int kMaxWarps = 32;
constexpr int kMaxWarpgroups = kMaxWarps / 4;
Barrier block_bar;
Barrier warp_bar[kMaxWarps];
Barrier wg_bar[kMaxWarpgroups];
// the warp collectives' operands, two sets used in turns (a thread's
// ``phase``): a thread may publish its next operands while a slower one
// still reads the last, and not the ones after (one barrier a collective)
float shfl_slot[2][kMaxWarps][32];
uint32_t mma_a[2][kMaxWarps][32][4], mma_b[2][kMaxWarps][32][2];
thread_local int shfl_phase = 0, mma_phase = 0;
// a product the thread issued and has not waited on: its operands, the
// accumulator it adds to (d_in; empty while a product before it into the
// same registers is pending), and its commit group (-1: not committed)
struct Pending {
  float* d;
  int n;
  const uint32_t* a;
  uint64_t desc_a, desc_b;
  int scale_d, trans_a, trans_b, f16;
  std::vector<float> d_in;
  long group;
};
thread_local std::vector<Pending> pending;
thread_local long n_groups = 0;
// a warpgroup thread at its wait_group: its pending products, the first k
// of which retire there
struct WaitSlot {
  std::vector<Pending>* pending;
  size_t k;
};
WaitSlot wg_wait[kMaxWarpgroups][128];
std::vector<float> smem_buf;

[[noreturn]] void emu_abort(const char* what) {
  std::fprintf(stderr, "emulated wgmma: %s\n", what);
  std::abort();
}

// x rounded to bf16, to nearest even (a NaN stays a NaN)
uint32_t bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (u >> 16) | 0x40u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// x rounded to float16, to nearest even, on the bits: subnormals kept (no
// flush to zero), anything from 65520 up (the tie above 65504 goes to the
// even 65536) to inf, a NaN stays a NaN
uint32_t f16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign = (u >> 16) & 0x8000u, a = u & 0x7FFFFFFFu;
  if (a > 0x7F800000u) return sign | 0x7E00u | ((a >> 13) & 0x3FFu);
  if (a >= 0x477FF000u) return sign | 0x7C00u;
  if (a >= 0x38800000u) {   // 2^-14 and up: a normal float16
    const uint32_t r = a - 0x38000000u;   // the exponent rebiased by 112
    return sign | ((r + 0xFFFu + ((r >> 13) & 1u)) >> 13);
  }
  // a subnormal (or 0): an integer count of 2^-24, rounded to nearest even
  // (x * 2^24 is exact; nearbyintf rounds ties to even)
  return sign | static_cast<uint32_t>(
                    std::nearbyintf(__uint_as_float(a) * 16777216.0f));
}

// the float16 of bits h
float f16_value(uint32_t h) {
  const int e = (h >> 10) & 0x1F, m = h & 0x3FF;
  const float mag = e == 0 ? std::ldexp(static_cast<float>(m), -24)
                    : e == 31 ? (m ? std::nanf("") : INFINITY)
                    : std::ldexp(static_cast<float>(1024 + m), e - 25);
  return h & 0x8000u ? -mag : mag;
}

// the value of a 16-bit element's bits: float16 (f16) or bf16
float half_value(uint32_t bits, int f16) {
  return f16 ? f16_value(bits) : __uint_as_float(bits << 16);
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
// f16: the element is a float16, else a bf16.
float desc_elem(uint64_t desc, int mn, int k, int mn_major, int f16) {
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
  return half_value(bits, f16);
}

// the value a TF32 operand holds: the tensor cores read 10 mantissa bits
double tf32_value(uint32_t u) { return __uint_as_float(u & 0xFFFFE000u); }


}  // namespace

float* emu_smem() { return smem_buf.data(); }

void __syncthreads() { block_bar.wait(); }

void __trap() {
  std::fprintf(stderr, "emulated kernel: __trap\n");
  std::abort();
}

float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ph = shfl_phase ^= 1;
  shfl_slot[ph][w][lane] = v;
  warp_bar[w].wait();
  return shfl_slot[ph][w][lane ^ lane_mask];
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
  const int ph = mma_phase ^= 1;
  uint32_t (&sa)[32][4] = mma_a[ph][w];
  uint32_t (&sb)[32][2] = mma_b[ph][w];
  for (int e = 0; e < 4; ++e) sa[lane][e] = a[e];
  for (int e = 0; e < 2; ++e) sb[lane][e] = b[e];
  warp_bar[w].wait();
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double sum = c[e];
    for (int k = 0; k < 8; ++k)
      sum += tf32_value(sa[4 * (row % 8) + k % 4][(row >= 8) + 2 * (k >= 4)]) *
             tf32_value(sb[4 * col + k % 4][k >= 4]);
    c[e] = static_cast<float>(sum);
  }
}

namespace {

// Product ps[lane] of the warpgroup's 128 threads, for all of them: D =
// A B (+ D) with the PTX fragment layouts of wgmma m64nNk16 (warp w of the
// warpgroup holds rows 16w..16w + 15; g = lane / 4, t = lane % 4):
// d[4j + e] = D(16w + g + 8 (e >> 1), 8j + 2t + (e & 1)); an A register
// a[r] holds A(16w + g + 8 (r & 1), 2t + 8 (r >> 1) ..+1), the lower index
// in the low half (mma.sync m16n8k16's A). A and B are decoded once,
// products (exact) and sums in double, rounded to float once, into
// out[lane].
void wgmma_product(const Pending* const (&ps)[128], float (&out)[128][64]) {
  const Pending& lead = *ps[0];
  for (const Pending* q : ps)
    if (q->desc_b != lead.desc_b || q->n != lead.n ||
        q->scale_d != lead.scale_d || (q->a == nullptr) != (lead.a == nullptr)
        || q->trans_b != lead.trans_b || q->f16 != lead.f16 ||
        (!q->a && (q->desc_a != lead.desc_a || q->trans_a != lead.trans_a)))
      emu_abort("the warpgroup's threads disagree on an operand");
  const int n = lead.n, f16 = lead.f16;
  float av[64][16], bv[128][16];
  for (int row = 0; row < 64; ++row)
    for (int k = 0; k < 16; ++k) {
      if (lead.a) {
        const int holder = 32 * (row / 16) + 4 * (row % 8) + (k % 8) / 2;
        const uint32_t aw = ps[holder]->a[((row % 16) >= 8) + 2 * (k >= 8)];
        av[row][k] = half_value(k & 1 ? aw >> 16 : aw & 0xFFFFu, f16);
      } else {
        av[row][k] = desc_elem(lead.desc_a, row, k, lead.trans_a, f16);
      }
    }
  for (int col = 0; col < n; ++col)
    for (int k = 0; k < 16; ++k)
      bv[col][k] = desc_elem(lead.desc_b, col, k, lead.trans_b, f16);
  for (int lane = 0; lane < 128; ++lane) {
    const int w = lane >> 5, g = (lane & 31) >> 2, t = lane & 3;
    for (int j = 0; j < n / 8; ++j)
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * w + g + 8 * (e >> 1);
        const int col = 8 * j + 2 * t + (e & 1);
        double sum = lead.scale_d ? ps[lane]->d_in[4 * j + e] : 0.0;
        for (int k = 0; k < 16; ++k)
          sum += static_cast<double>(av[row][k]) * bv[col][k];
        out[lane][4 * j + e] = static_cast<float>(sum);
      }
  }
}

// The products the warpgroup's threads retire at a wait_group, run by the
// last of them to arrive, in issue order: each result goes to the next
// pending product into the same registers, or to the registers when there
// is none. The shared tiles are read before any thread leaves the
// barrier, as the card's products have read them when the wait returns.
void retire(WaitSlot (&slots)[128]) {
  const size_t k = slots[0].k;
  for (const WaitSlot& s : slots)
    if (s.k != k) emu_abort("the warpgroup's threads retire different "
                            "products");
  const Pending* ps[128];
  float out[128][64];
  for (size_t i = 0; i < k; ++i) {
    for (int lane = 0; lane < 128; ++lane)
      ps[lane] = &(*slots[lane].pending)[i];
    wgmma_product(ps, out);
    for (int lane = 0; lane < 128; ++lane) {
      std::vector<Pending>& pend = *slots[lane].pending;
      const Pending& p = pend[i];
      auto next = std::find_if(pend.begin() + i + 1, pend.end(),
                               [&](const Pending& q) { return q.d == p.d; });
      if (next != pend.end())
        next->d_in.assign(out[lane], out[lane] + p.n / 2);
      else
        std::copy(out[lane], out[lane] + p.n / 2, p.d);
    }
  }
}

}  // namespace

void emu_warpgroup_sync() { wg_bar[threadIdx.x >> 7].wait(); }

void emu_wgmma(float* d, int n, const uint32_t* a, uint64_t desc_a,
               uint64_t desc_b, int scale_d, int trans_a, int trans_b,
               int f16) {
  Pending p{d, n, a, desc_a, desc_b, scale_d, trans_a, trans_b, f16, {}, -1};
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
  // committed groups are a prefix of the issue order: retire all but the
  // n newest, the warpgroup meeting once
  size_t k = 0;
  while (k < pending.size() && pending[k].group >= 0 &&
         pending[k].group < n_groups - n)
    ++k;
  if (k == 0) return;   // as for every thread of the warpgroup
  const int wg = threadIdx.x >> 7;
  wg_wait[wg][threadIdx.x & 127] = {&pending, k};
  wg_bar[wg].wait([&] { retire(wg_wait[wg]); });
  pending.erase(pending.begin(), pending.begin() + k);
}

uint32_t emu_pack_bf16x2(float lo, float hi) {
  return bf16_rn(lo) | (bf16_rn(hi) << 16);
}

uint32_t emu_pack_f16x2(float lo, float hi) {
  return f16_rn(lo) | (f16_rn(hi) << 16);
}

float emu_f16_value(uint16_t h) { return f16_value(h); }

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
