"""Hopper's warpgroup products as the 16-bit attention bodies use them
(``csrc/half_wgmma.cuh``), under the host emulator of
``mxnet_tpu_torch/kernels/_emulate.py``, and the bodies at the edges of
their 64-row blocks (one warpgroup) and 64-key tiles (32-query tiles in
dk/dv at D = 128).

- The products: small kernels of this file's own, built against the
  emulator, stage 16-bit tiles as the bodies do and run ``wgmma_rs`` /
  ``wgmma_ss`` through real shared-memory descriptors in the two forms
  the bodies use: A and B both from shared memory with B K-major
  (S = Q K^T), and A from registers or shared memory with B transposed
  (O = P V), at the three staged widths (D = 32: the 64-byte swizzle; 64:
  the 128-byte one; 128: two 128-byte atom columns). The emulator decodes
  the descriptors (start address, leading and stride byte offsets,
  swizzle mode) and reads through the address swizzle, so a product
  agrees with the plain matmul in double (to float32's rounding of each
  16-deep step: ``STEP_TOL``) only if the descriptors and the staging
  agree; a descriptor with the wrong swizzle mode must not. bf16 at
  every width the bodies use, float16 at D = 32, 64 and 128. A from
  registers with B K-major is not covered: no body uses it, and the card
  read a backward built on it wrong where this emulator read it right
  (PERF.md, section 7), so passing here would certify nothing.
- Ordering: the emulator runs a product at the ``wait_group`` that
  retires it, so accumulators read before the wait, and A registers or a
  shared tile overwritten before it, must show. A missing ``wgmma.fence``
  cannot: the emulator has no register file to race on.
- float16's rounds on the bits (``pack_f16x2``, ``widen_f16``) against
  torch's casts: ties to even, subnormals kept down to 2^-24 and below
  it, 65504 and above to inf, NaN.
- The bodies, through their C entries against the plain 16-bit
  versions, held to the dtype's row-ulp limit as
  ``test_torch_kernel_emulation.py`` holds them: sq and sk not multiples
  of 64, several tiles a block (the cp.async ring and the product of the
  previous tile behind the next), a causal frontier inside a key tile,
  split widths 64 and 96 (not multiples of the tile) with dead splits;
  in float16 one case of each family.
Skipped where the host has no ``g++``.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import _emulate
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels.bf16_gate import GATES, row_ulps
from torch_one_thread import one_torch_thread  # noqa: F401

GATE = 1e-4
NEG = -1e30
#: an emulated product rounds its sum to float32 once a 16-deep step; a
#: misread element moves a product by about one of its terms (~1)
STEP_TOL = dict(rtol=1e-6, atol=1e-5)

#: kernels of the tests' own on the bodies' helpers: S = A B^T with B^T an
#: [N][D] tile (K-major), and O = P V with P [64][64] and V a [64][D] tile
#: (transposed), in bf16 or float16 (``f16``); one warpgroup, one block.
#: ``fault`` plants an ordering fault in O = P V (``FAULTS``). ``wg_round``
#: packs pairs to float16 and widens them back.
SOURCE = r"""
#include "half_wgmma.cuh"
using namespace mx_wg;

// the A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of an
// [R][D] tile (g = lane / 4, t = lane % 4): mma.sync m16n8k16's layout
template <int D, int R>
__device__ void load_a(const h16* tile, int r0, int c0, int g, int t,
                       uint32_t (&a)[4]) {
  for (int e = 0; e < 4; ++e)
    a[e] = *reinterpret_cast<const uint32_t*>(
        tile + tile_off<D, R>(r0 + g + 8 * (e & 1), c0 + 2 * t + 8 * (e >> 1)));
}

__device__ void store_acc(const float* d, int n, float* out) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  for (int j = 0; j < n / 8; ++j)
    for (int e = 0; e < 4; ++e)
      out[(wr + g + 8 * (e >> 1)) * n + 8 * j + 2 * t + (e & 1)] =
          d[4 * j + e];
}

__device__ void publish() {
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
}

template <typename T, int D, int N>
__global__ void s_kernel(const h16* a, const h16* bt, float* out,
                         uint64_t flip) {
  extern __shared__ __align__(1024) unsigned char mx_smem[];
  h16* as = smem_base(mx_smem);
  h16* bs = as + 64 * D;
  stage_tile<D, 64, 128>(as, a, 0, 64);
  stage_tile<D, N, 128>(bs, bt, 0, N);
  publish();
  float d[N / 2];
  zero(d);
  wgmma_fence();
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T, N, 0>(d, desc_k<D, 64>(as, 0, kk * 16),
                      desc_k<D, N>(bs, 0, kk * 16) ^ flip, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc(d, N, out);
}

// fault 1: the accumulators read without the wait; 2: A's registers
// zeroed before it; 3: V's tile zeroed before it
template <typename T, int D, bool kRegA>
__global__ void pv_kernel(const h16* p, const h16* v, float* out,
                          uint64_t flip, int fault) {
  extern __shared__ __align__(1024) unsigned char mx_smem[];
  h16* ps = smem_base(mx_smem);
  h16* vs = ps + 64 * 64;
  stage_tile<64, 64, 128>(ps, p, 0, 64);
  stage_tile<D, 64, 128>(vs, v, 0, 64);
  publish();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t fa[4][4];
  for (int jj = 0; jj < 4; ++jj)
    load_a<64, 64>(ps, (threadIdx.x >> 5) * 16, jj * 16, g, t, fa[jj]);
  float d[D / 2];
  zero(d);
  wgmma_fence();
  for (int jj = 0; jj < 4; ++jj)
    for (int c0 = 0; c0 < D; c0 += 64) {
      float (&dc)[D > 64 ? 32 : D / 2] =
          *reinterpret_cast<float (*)[D > 64 ? 32 : D / 2]>(d + c0 / 2);
      const uint64_t b = desc_mn<D, 64>(vs, jj * 16, c0) ^ flip;
      if (kRegA)
        wgmma_rs<T, (D > 64 ? 64 : D), 1>(dc, fa[jj], b, 1);
      else
        wgmma_ss<T, (D > 64 ? 64 : D), 1>(dc, desc_k<64, 64>(ps, 0, jj * 16),
                                          b, 1);
    }
  wgmma_commit();
  if (fault == 2)
    for (auto& f : fa) f[0] = f[1] = f[2] = f[3] = 0u;
  if (fault == 3) {
    for (int i = threadIdx.x; i < 64 * D; i += 128) vs[i] = 0;
    __syncthreads();
  }
  if (fault != 1) wgmma_wait<0>();
  fence_regs(d);
  store_acc(d, D, out);
}


template <typename T, int D, int N>
int run_s(const h16* a, const h16* bt, float* out, uint64_t flip) {
  const size_t smem = 2 * (64 + N) * D;
  s_kernel<T, D, N><<<1, 128, smem>>>(a, bt, out, flip);
  return 0;
}

template <typename T, int D, bool kRegA>
int run_pv(const h16* p, const h16* v, float* out, uint64_t flip,
           int fault) {
  const size_t smem = 2 * 64 * (64 + D);
  pv_kernel<T, D, kRegA><<<1, 128, smem>>>(p, v, out, flip, fault);
  return 0;
}

#define MX_S(D, N)                                                \
  if (d == D && n == N)                                           \
    return f16 ? run_s<F16, D, N>(a, bt, out, flip)               \
               : run_s<Bf16, D, N>(a, bt, out, flip);

extern "C" int wg_s(const h16* a, const h16* bt, float* out, int d, int n,
                    uint64_t flip, int f16) {
  MX_S(32, 32) MX_S(32, 128) MX_S(64, 64) MX_S(64, 128) MX_S(128, 32)
  MX_S(128, 64)
  return 1;
}

#define MX_PV(D, T)                                                  \
  return reg_a ? run_pv<T, D, true>(p, v, out, flip, fault)          \
               : run_pv<T, D, false>(p, v, out, flip, fault);
#define MX_PV_D(D)                                                   \
  if (d == D) {                                                      \
    if (f16) MX_PV(D, F16) else MX_PV(D, Bf16)                       \
  }

extern "C" int wg_pv(const h16* p, const h16* v, float* out, int d,
                     int reg_a, uint64_t flip, int fault, int f16) {
  MX_PV_D(32) MX_PV_D(64) MX_PV_D(128)
  return 1;
}

// out[2i], out[2i + 1] = the float16 pair x[2i], x[2i + 1] rounds to,
// widened back; bits[i] the pair's bits (one thread)
__global__ void round_kernel(const float* x, float* out, uint32_t* bits,
                             int n) {
  for (int i = 0; i < n / 2; ++i) {
    uint32_t w;
    pack2<F16>(w, x[2 * i], x[2 * i + 1]);
    bits[i] = w;
    out[2 * i] = half_of<F16, false>(w);
    out[2 * i + 1] = half_of<F16, true>(w);
  }
}

extern "C" int wg_round(const float* x, float* out, uint32_t* bits, int n) {
  round_kernel<<<1, 1, 0>>>(x, out, bits, n);
  return 0;
}
"""


@pytest.fixture(scope="module")
def emu():
    if _emulate.compiler() is None:
        pytest.skip("no g++ on this host to build the emulated kernels")
    return _emulate


@pytest.fixture(scope="module")
def wg(emu):
    import ctypes
    lib = emu.load_source("wgmma_test", SOURCE)
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    lib.wg_s.argtypes = [p, p, p, i, i, u64, i]
    lib.wg_pv.argtypes = [p, p, p, i, i, u64, i, i]
    lib.wg_round.argtypes = [p, p, p, i]
    return lib


def _half(rng, *shape, dtype=torch.bfloat16):
    return torch.from_numpy(rng.standard_normal(shape)
                            .astype(np.float32)).to(dtype)



#: the layout bits (62-63) of a descriptor flipped: 128-byte swizzle read
#: as 64-byte, and 64-byte as 128-byte
FLIP = 3 << 62


@pytest.mark.parametrize("d,n", [(32, 32), (32, 128), (64, 64), (64, 128),
                                 (128, 32), (128, 64)])
def test_wgmma_k_major(wg, d, n):
    """S = A B^T, A and B K-major from shared memory, contracted over
    D = d in 16-deep steps."""
    rng = np.random.RandomState(d + n)
    a, bt = _half(rng, 64, d), _half(rng, n, d)
    out = torch.full((64, n), math.nan)
    assert wg.wg_s(a.data_ptr(), bt.data_ptr(), out.data_ptr(), d, n,
                   0, 0) == 0
    ref = (a.double() @ bt.double().T).float()
    torch.testing.assert_close(out, ref, **STEP_TOL)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("reg_a", [1, 0], ids=["a_regs", "a_smem"])
def test_wgmma_transposed_b(wg, d, reg_a):
    """O = P V, V MN-major (a [64][d] tile read down its rows), P from
    registers or shared memory."""
    rng = np.random.RandomState(d + 7 * reg_a)
    p, v = _half(rng, 64, 64), _half(rng, 64, d)
    out = torch.full((64, d), math.nan)
    assert wg.wg_pv(p.data_ptr(), v.data_ptr(), out.data_ptr(), d, reg_a,
                    0, 0, 0) == 0
    ref = (p.double() @ v.double()).float()
    torch.testing.assert_close(out, ref, **STEP_TOL)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_wgmma_float16_products(wg, d):
    """The float16 products (wgmma .f32.f16.f16) in both forms the bodies
    use at the three staged widths: S = A B^T from shared memory (N = d,
    and 32 at D = 128) and O = P V with P from registers. Inputs of
    float16's own range (scaled by 200: past bf16's 8 significant bits,
    within float16's 11) show a product read as bf16."""
    rng = np.random.RandomState(40 + d)
    f16 = torch.float16
    n = 32 if d == 128 else d
    a, bt = _half(rng, 64, d, dtype=f16), _half(rng, n, d, dtype=f16)
    a = (a.float() * 200).to(f16)
    out = torch.full((64, n), math.nan)
    assert wg.wg_s(a.data_ptr(), bt.data_ptr(), out.data_ptr(), d, n, 0,
                   1) == 0
    ref = (a.double() @ bt.double().T).float()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=200 * 1e-5)
    p, v = _half(rng, 64, 64, dtype=f16), _half(rng, 64, d, dtype=f16)
    out = torch.full((64, d), math.nan)
    assert wg.wg_pv(p.data_ptr(), v.data_ptr(), out.data_ptr(), d, 1, 0, 0,
                    1) == 0
    ref = (p.double() @ v.double()).float()
    torch.testing.assert_close(out, ref, **STEP_TOL)


def test_float16_round_on_the_bits(wg):
    """``pack2<F16>`` (cvt.rn.f16x2.f32) and ``half_of<F16>``
    (cvt.f32.f16) as emulated, against torch's casts: ties to even among
    normals and subnormals, subnormals kept (no flush to zero) down to
    2^-24, half of it a tie to 0 and just above it 2^-24, the largest
    normal 65504, its tie 65520 to inf, inf, NaN, and a sweep of random
    magnitudes from 2^-27 to 2^17."""
    ulp1 = 2.0 ** -10
    special = [1.0 + ulp1 / 2, 1.0 + 3 * ulp1 / 2, -(1.0 + ulp1 / 2),
               2.0 ** -14, 2.0 ** -14 * (1 - 2.0 ** -12), 3 * 2.0 ** -25,
               5 * 2.0 ** -25, 2.0 ** -24, 2.0 ** -25, 2.0 ** -25 * 1.0001,
               -2.0 ** -26, 65504.0, 65519.0, 65520.0, -70000.0, math.inf,
               math.nan, 0.0, -0.0, 1e-30]
    rng = np.random.RandomState(5)
    sweep = (rng.choice([-1, 1], 4000) * 2.0 ** rng.uniform(-27, 17, 4000))
    x = torch.tensor(special + sweep.tolist(), dtype=torch.float32)
    out = torch.full_like(x, math.nan)
    bits = torch.zeros(x.numel() // 2, dtype=torch.int32)
    assert wg.wg_round(x.data_ptr(), out.data_ptr(), bits.data_ptr(),
                       x.numel()) == 0
    want = x.to(torch.float16)
    got_bits = torch.stack([bits & 0xFFFF, (bits >> 16) & 0xFFFF], 1)
    want_bits = want.view(torch.int16).to(torch.int32) & 0xFFFF
    nan = torch.isnan(x)
    assert torch.equal(got_bits.reshape(-1)[~nan], want_bits[~nan])
    assert torch.isnan(out[nan]).all()
    assert torch.equal(out[~nan], want.float()[~nan])
    assert out[special.index(2.0 ** -24)] == 2.0 ** -24      # kept
    assert out[special.index(65520.0)] == math.inf
    assert out[special.index(65519.0)] == 65504.0


#: the ordering faults ``pv_kernel`` plants (its ``fault`` argument)
FAULTS = {"accumulators_read_before_wait": 1,
          "a_registers_overwritten_before_wait": 2,
          "tile_overwritten_before_wait": 3}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_wgmma_ordering_faults_show(wg, fault):
    """O = P V with P from registers at D = 64, a fault planted between
    the commit and the wait: the emulated product is asynchronous, so
    the result is not P V (NaN accumulators, or a product of zeros)."""
    rng = np.random.RandomState(11)
    p, v = _half(rng, 64, 64), _half(rng, 64, 64)
    out = torch.full((64, 64), math.nan)
    assert wg.wg_pv(p.data_ptr(), v.data_ptr(), out.data_ptr(), 64, 1, 0,
                    FAULTS[fault], 0) == 0
    ref = (p.double() @ v.double()).float()
    assert (out - ref).abs().nan_to_num(math.inf).max().item() > 1.0


@pytest.mark.parametrize("what", ["k_major_d64", "k_major_d32",
                                  "transposed_d64"])
def test_wgmma_reads_the_swizzle_mode(wg, what):
    """The emulator reads the descriptor's swizzle mode: the right tile
    read through the wrong mode gives another product."""
    rng = np.random.RandomState(3)
    if what.startswith("k_major"):
        d = int(what[-2:])
        a, bt = _half(rng, 64, d), _half(rng, d, d)
        out = torch.full((64, d), math.nan)
        assert wg.wg_s(a.data_ptr(), bt.data_ptr(), out.data_ptr(), d, d,
                       FLIP, 0) == 0
        ref = (a.double() @ bt.double().T).float()
    else:
        p, v = _half(rng, 64, 64), _half(rng, 64, 64)
        out = torch.full((64, 64), math.nan)
        assert wg.wg_pv(p.data_ptr(), v.data_ptr(), out.data_ptr(), 64, 1,
                        FLIP, 0, 0) == 0
        ref = (p.double() @ v.double()).float()
    assert (out - ref).abs().nan_to_num(math.inf).max().item() > 1.0


# ------------------------------------------------------------- bodies ----

def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _caller(emu):
    """Calls C entries of the emulated bodies."""
    def call(name, *args):
        assert emu.entry(name)(*args, None) == 0, name
    return call


def _qkv(sq, sk, d, seed, dtype):
    rng = np.random.RandomState(seed)
    return [_half(rng, 1, 1, n, d, dtype=dtype) for n in (sq, sk, sk)]


BF, F16 = torch.bfloat16, torch.float16


def _ids(value):
    """Test ids: the 16-bit dtypes by their entries' suffix."""
    return {BF: "bf16", F16: "f16"}.get(value)


def _lse_err(got, ref):
    return ((got - ref).abs().max() / max(1.0, ref.abs().max())).item()


@pytest.mark.parametrize("entry,sq,sk,d,q0,k0,causal,width,dtype", [
    # 176 rows: 3 blocks, the last of 48 rows; 5 key tiles, the last ragged
    ("#5", 176, 300, 32, 0, 0, False, None, BF),
    # one block: 264 visible keys, the frontier inside the fifth tile
    ("#1", 64, 330, 64, 200, 0, True, None, BF),
    # D = 128: two 64-column halves a tile
    ("#5", 200, 200, 128, 0, 0, True, None, BF),
    # splits of 96 and 64 keys, ragged against the tile, some dead
    ("#6", 320, 320, 64, 0, 0, True, 96, BF),
    ("#3", 80, 300, 32, 100, 0, True, 64, BF),
    # float16: one case of the stream family and one of the split family
    ("#1", 64, 330, 64, 200, 0, True, None, F16),
    ("#3", 80, 300, 32, 100, 0, True, 64, F16)], ids=_ids)
def test_forward_body_at_tile_edges(emu, entry, sq, sk, d, q0, k0, causal,
                                    width, dtype):
    _call = _caller(emu)
    q, k, v = _qkv(sq, sk, d, sq + sk + d, dtype)
    sfx = "_" + tfa._DTYPES[dtype]
    sm = 1.0 / math.sqrt(d)
    offs = torch.tensor([q0, k0], dtype=torch.int32)
    out = torch.full_like(q, math.nan)
    lse = torch.full((1, 1, sq), math.nan)
    geo = [1, sq, sk, d]
    if width is None:
        if entry == "#5":
            _call("mx_flash_fwd" + sfx, *_ptrs(q, k, v, out, lse), *geo,
                  sm, int(causal))
            ref = tfa.flash_fwd_plain(q, k, v, sm, causal)
        else:
            _call("mx_flash_fwd_offs" + sfx,
                  *_ptrs(q, k, v, offs, out, lse), *geo, sm, int(causal))
            ref = tfa.flash_fwd_offs_plain(q, k, v, offs, sm, causal)
    else:
        n = len(tfa._splits(sk, width))
        parts = (torch.full((n, 1, 1, sq, d), math.nan),
                 torch.full((n, 1, 1, sq), math.nan))
        pre = [] if entry == "#6" else [offs]
        name = "mx_flash_fwd_grid" if entry == "#6" else \
            "mx_flash_fwd_offs_grid"
        _call(name + sfx, *_ptrs(q, k, v, *pre, *parts), *geo,
              width, n, sm, int(causal))
        _call(name + "_combine" + sfx, *_ptrs(*pre, *parts, out, lse),
              1, sq, d, width, n, int(causal))
        if entry == "#6":
            ref = tfa.flash_fwd_grid_plain(q, k, v, sm, causal, width)
        else:
            ref = tfa.flash_fwd_offs_grid_plain(q, k, v, offs, sm, causal,
                                                width)
    dead = ref[1] == NEG
    ulps, lerr = row_ulps(out, ref[0]), _lse_err(lse[~dead], ref[1][~dead])
    print("%s %s sq=%d sk=%d D=%d width=%s: out %.2f ulps, lse %.2e"
          % (entry, dtype, sq, sk, d, width, ulps, lerr))
    assert out.dtype == dtype
    assert ulps <= GATES[dtype][2] and lerr <= GATE, (ulps, lerr)
    assert (lse[dead] == NEG).all() and (out[dead] == 0).all()


@pytest.mark.parametrize("d,sq,sk,q0,k0,widths,dtype", [
    # dq: 4 key tiles of 64 in 96-key splits; dk/dv: query splits of 64
    (64, 200, 200, 0, 0, (64, 96), BF),
    # at an offset: dead (block, split) pairs, key blocks whose walk
    # starts past the first query tiles
    (32, 144, 300, 156, 0, (96, 64), BF),
    # D = 128 through the stream entries: 32-query tiles for dk/dv, the
    # first products from shared memory
    (128, 176, 176, 0, 0, None, BF),
    # float16: the split family at an offset, the stream family at D = 64
    (32, 144, 300, 156, 0, (96, 64), F16),
    (64, 136, 136, 0, 0, None, F16)], ids=_ids)
def test_backward_body_at_tile_edges(emu, d, sq, sk, q0, k0, widths, dtype):
    _call = _caller(emu)
    q, k, v = _qkv(sq, sk, d, 3 * d + sq, dtype)
    sfx = "_" + tfa._DTYPES[dtype]
    rng = np.random.RandomState(d)
    do = _half(rng, 1, 1, sq, d, dtype=dtype)
    sm = 1.0 / math.sqrt(d)
    offs = torch.tensor([q0, k0], dtype=torch.int32)
    out, lse = tfa.flash_fwd_offs_plain(q, k, v, offs, sm, True)
    deff = tfa._deff(do, out, None).contiguous()
    common = _ptrs(q, k, v, offs, do, lse, deff)
    dq, dk, dv = torch.full_like(q, math.nan), *(torch.full_like(k, math.nan)
                                                  for _ in range(2))
    if widths is None:
        tail = [1, sq, sk, d, sm, 1]
        _call("mx_flash_bwd_dq" + sfx, *common, dq.data_ptr(), *tail)
        _call("mx_flash_bwd_dkv" + sfx, *common, *_ptrs(dk, dv), *tail)
        ref = tfa.flash_bwd_offs_plain(q, k, v, offs, do, None, out, lse, sm,
                                       True)
    else:
        wq, wk = widths
        nq, nk = len(tfa._splits(sq, wq)), len(tfa._splits(sk, wk))
        pq = torch.full((nk, 1, 1, sq, d), math.nan)
        pk, pv = (torch.full((nq, 1, 1, sk, d), math.nan) for _ in range(2))
        _call("mx_flash_bwd_dq_grid" + sfx, *common, pq.data_ptr(), 1,
              sq, sk, d, wk, nk, sm, 1)
        _call("mx_flash_bwd_dq_grid_reduce" + sfx,
              *_ptrs(offs, pq, dq), 1, sq, d, wk, nk, sm, 1)
        _call("mx_flash_bwd_dkv_grid" + sfx, *common, *_ptrs(pk, pv), 1,
              sq, sk, d, wq, nq, sm, 1)
        _call("mx_flash_bwd_dkv_grid_reduce" + sfx,
              *_ptrs(offs, pk, pv, dk, dv), 1, sq, sk, d, wq, nq, 1)
        ref = tfa.flash_bwd_offs_grid_plain(q, k, v, offs, do, None, out,
                                            lse, sm, True, wq, wk)
    ulps = [row_ulps(g, w) for g, w in zip((dq, dk, dv), ref)]
    print("#2/#4 %s D=%d sq=%d sk=%d widths=%s: dq/dk/dv %s ulps"
          % (dtype, d, sq, sk, widths, ["%.2f" % u for u in ulps]))
    assert all(g.dtype == dtype for g in (dq, dk, dv))
    assert max(ulps) <= GATES[dtype][2], ulps
