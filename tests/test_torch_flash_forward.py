"""The arithmetic of the port's tensor-core forward body (``flash_fwd.cuh``,
behind #1, #3, #5 and #6), emulated in numpy and held against the JAX
package's Pallas forward kernels in interpret mode.

What the body does, and the emulation repeats:
- every product as three TF32 products (3xTF32): x = hi + lo, both
  rounded to TF32 on the bit pattern, a.b ~ lo_a.hi_b + hi_a.lo_b +
  hi_a.hi_b; Q is split once, with sm_scale * log2e folded in first, so
  the scores come out in log2 units, and P (in [0, 1]) is split too;
- an online softmax over key tiles (64 keys; 32 at D = 128) with exp2: a
  masked score becomes -1e30 and its p exactly 0;
- each tile's P V summed from zero, then O = O * alpha + PV_t;
- lse = m * ln 2 + log l, and (0, -1e30) for a row that sees no key.

Cases: the whole key axis as one split against ``_flash_fwd_pallas`` at
(1, 2, 256, 64) with 64-key tiles and (1, 2, 160, 128) with 32-key tiles,
causal; the split form against ``_flash_fwd_grid_pallas`` with three
splits of which the last is ragged (96-key splits of 256 keys, so each
split's second 64-key tile is masked at the split's end; 64-key splits of
160 keys at D = 128), per-split partials merged by the port's
``_combine_splits``; and the offset form against ``_flash_fwd_offs_pallas``
at a ring-style offset whose first rows see no key.

The gate is ``chip_smoke.py``'s 1e-4: max abs error over the reference's
max abs where that exceeds 1. One TF32 product's error is printed beside
it: it is why the body takes three.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the module, not the function of the same name the package re-exports
jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")

from mxnet_tpu_torch.kernels import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

# float32 stays float32 (matters on a card, where cuBLAS may use TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_GATE = 1e-4
NEG = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does: on the bit pattern."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm(a, b, terms):
    """a @ b in float32 from TF32 operands: ``terms`` 3 is the body's
    lo.hi + hi.lo + hi.hi with x = hi + lo, both rounded to TF32; 1 is a
    single TF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _tile(d):
    return 32 if d == 128 else 64


def _kernel_fwd(q, k, v, sm, causal, k_lo, k_end, terms, q0=0, k0=0):
    """(out, lse) of one split, keys [k_lo, k_end), by the body's
    arithmetic; query row i at global position q0 + i, key j at k0 + j."""
    sq, d = q.shape[-2], q.shape[-1]
    kt = _tile(d)
    qc = (q * np.float32(np.float32(sm) * LOG2E)).astype(np.float32)
    o = np.zeros(q.shape, np.float32)
    m = np.full(q.shape[:-1], NEG, np.float32)
    l = np.zeros(q.shape[:-1], np.float32)
    rows = q0 + np.arange(sq)[:, None]
    for t0 in range(k_lo, k_end, kt):
        keys = np.arange(t0, t0 + kt)
        live = keys < k_end
        # rows past k_end read as zeros, as cp.async zero-fills them
        kk = np.where(live[:, None], k[..., np.minimum(keys, k_end - 1), :],
                      np.float32(0))
        vv = np.where(live[:, None], v[..., np.minimum(keys, k_end - 1), :],
                      np.float32(0))
        s = _mm(qc, np.swapaxes(kk, -1, -2), terms)
        vis = live[None, :] & ((not causal) | (rows >= k0 + keys[None, :]))
        s = np.where(vis, s, NEG)
        mx = np.maximum(m, s.max(-1))
        m_safe = np.where(mx > NEG / 2, mx, np.float32(0))
        alpha = np.exp2(m - m_safe)
        m = mx
        p = np.where(vis, np.exp2(s - m_safe[..., None]), np.float32(0))
        l = (l * alpha + p.sum(-1, dtype=np.float32)).astype(np.float32)
        pv = _mm(p.astype(np.float32), vv, terms)
        # one fma: O * alpha + PV_t, rounded once
        o = (o.astype(np.float64) * alpha[..., None] + pv).astype(np.float32)
    seen = l > 0
    out = o / np.where(seen, l, np.float32(1))[..., None]
    lse = np.where(seen, m * LN2 + np.log(np.where(seen, l, 1)), NEG)
    return out.astype(np.float32), lse.astype(np.float32)


def _kernel_fwd_splits(q, k, v, sm, causal, w, terms, q0=0, k0=0):
    """The split form: each split of w keys by :func:`_kernel_fwd`,
    merged by the port's combine."""
    sk = k.shape[-2]
    parts = [_kernel_fwd(q, k, v, sm, causal, lo, min(lo + w, sk), terms,
                         q0, k0) for lo in range(0, sk, w)]
    out, lse = tfa._combine_splits(
        torch.from_numpy(np.stack([o for o, _ in parts])),
        torch.from_numpy(np.stack([ls for _, ls in parts])))
    return out.numpy(), lse.numpy()


def _scaled_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _inputs(shape, sk, seed):
    rng = np.random.RandomState(seed)
    b, h, sq, d = shape
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _hold(what, emulate, ref):
    """Gate the 3xTF32 emulation against ``ref``; print one TF32's error
    beside it."""
    errs = {terms: max(_scaled_err(g, r) for g, r in zip(emulate(terms),
                                                          ref))
            for terms in (3, 1)}
    print("%s: 3xTF32 out/lse %.2e; one TF32 product %.2e"
          % (what, errs[3], errs[1]))
    assert errs[3] <= KERNEL_GATE, errs


@pytest.mark.parametrize("shape,block", [((1, 2, 256, 64), 64),
                                         ((1, 2, 160, 128), 32)])
def test_forward_3xtf32_arithmetic_matches_pallas(shape, block):
    """One split over the whole key axis (#5's launch) against the
    training forward kernel."""
    s, d = shape[2], shape[3]
    sm = 1.0 / np.sqrt(d)
    q, k, v = _inputs(shape, s, 11)
    ref = jfa._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), sm, True, block, block,
                                interpret=True)
    _hold(str(shape), lambda terms: _kernel_fwd(q, k, v, sm, True, 0, s,
                                                terms), ref)


@pytest.mark.parametrize("shape,w,block", [((1, 2, 256, 64), 96, 64),
                                           ((1, 2, 160, 128), 64, 32)])
def test_split_forward_3xtf32_matches_grid_pallas(shape, w, block):
    """Three key splits, the last ragged (#6's launch and its combine),
    against the grid forward kernel."""
    s, d = shape[2], shape[3]
    sm = 1.0 / np.sqrt(d)
    q, k, v = _inputs(shape, s, 12)
    assert len(tfa._splits(s, tfa.split_width(w, s))) == 3 and s % w
    ref = jfa._flash_fwd_grid_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), sm, True, block, block,
                                     interpret=True)
    _hold("%s w=%d" % (shape, w), lambda terms: _kernel_fwd_splits(
        q, k, v, sm, True, w, terms), ref)


def test_offset_forward_3xtf32_matches_offs_pallas():
    """The offset form (#1's launch) at a ring-style offset: the first 40
    query rows see no key and must give exactly (0, -1e30)."""
    shape, sk, offs = (1, 2, 96, 64), 128, (0, 40)
    sm = 1.0 / np.sqrt(shape[3])
    q, k, v = _inputs(shape, sk, 13)
    ref = jfa._flash_fwd_offs_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v),
                                     jnp.asarray(offs, jnp.int32), sm, True,
                                     32, 32, interpret=True)
    emulate = lambda terms: _kernel_fwd(q, k, v, sm, True, 0, sk, terms,
                                        *offs)
    _hold("%s offs=%s" % (shape, offs), emulate, ref)
    out, lse = emulate(3)
    dead = np.arange(shape[2]) + offs[0] < offs[1]
    assert (lse[..., dead] == NEG).all() and (out[..., dead, :] == 0).all()
    assert (lse[..., ~dead] > NEG / 2).all()
