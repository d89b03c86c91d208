"""The port's attention kernels themselves, their CUDA sources built for the
host CPU against the emulator of ``mxnet_tpu_torch/kernels/_emulate.py``
and called through their C entries, held against the plain versions the
card's runs are held to (``chip_smoke.py``'s gate, 1e-4 of the
reference's max abs where that exceeds 1).

This reaches what the plain versions and the numpy emulation of the
arithmetic cannot: the fragment layouts, the swizzle, the staging, the
masks at tile, split and diagonal edges, dead splits, the online softmax
across the thread quad, and the combine. Shapes are small, since the
emulator runs every thread of every block as a host thread:
- #5 (``flash_fwd.cu``) causal, a partial last block of rows, D = 32; and
  D = 128 (Q as hi and lo planes in shared memory, 32-key tiles);
- #1 (``flash_fwd_offs.cu``) at a ring-style offset whose first rows see
  no key (exactly (0, -1e30)), D = 64;
- #6 (``flash_fwd_grid.cu``) with three 96-key splits of 256 keys (each
  split's second 64-key tile masked at the split's end, the last split
  ragged) and its combine, and #3 (``flash_fwd_offs_grid.cu``) at an
  offset where some blocks' splits are dead, D = 32;
- two calls on the same inputs give the same bits;
- the backward pair #2 (``flash_bwd_offs.cu``), whose helpers the forward
  now shares, D = 32;
- the 16-bit bodies (``flash_fwd_half.cuh``, ``flash_bwd_half.cuh``, on
  the warpgroup products of ``half_wgmma.cuh``) behind the ``*_bf16``
  entries of #5, #1, #2, #6, #3 and #4 at D = 32, 64 and 128, and behind
  every ``*_f16`` entry (one case a family), against the plain versions on
  the same 16-bit inputs. Tolerance in ulps of the dtype at each row's
  largest magnitude (``bf16_gate``'s ``row_ulps`` and ``GATES``): the
  emulated MMA sums in double and rounds once where the plain version sums
  in float32, and the kernels round ``p`` against the running row max of
  each key tile where the plain version takes the row's max at once. lse
  (float32) is held to ``GATE``; masked rows are exact, and two calls give
  the same bits.
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

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GATE = 1e-4
NEG = -1e30


@pytest.fixture(scope="module")
def emu():
    if _emulate.compiler() is None:
        pytest.skip("no g++ on this host to build the emulated kernels")
    return _emulate


def _err(got, ref):
    return ((got - ref).abs().max() / max(1.0, ref.abs().max())).item()


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, n, d))
                             .astype(np.float32)) for n in (sq, sk, sk)]


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _call(emu, name, *args):
    assert emu.entry(name)(*args, None) == 0, name


def _forward(emu, q, k, v, causal, offs=None, width=None):
    """(out, lse) through the emulated forward entry of the variant."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sm = 1.0 / math.sqrt(d)
    out = torch.full_like(q, math.nan)
    lse = torch.full((b, h, sq), math.nan)
    tail = [b * h, sq, sk, d]
    if width is None:
        if offs is None:
            _call(emu, "mx_flash_fwd_f32", *_ptrs(q, k, v, out, lse), *tail,
                  sm, int(causal))
        else:
            _call(emu, "mx_flash_fwd_offs_f32", *_ptrs(q, k, v, offs, out,
                                                        lse), *tail, sm,
                  int(causal))
        return out, lse
    n = len(tfa._splits(sk, width))
    part_o = torch.full((n, b, h, sq, d), math.nan)
    part_l = torch.full((n, b, h, sq), math.nan)
    tail += [width, n, sm, int(causal)]
    combine = [part_o, part_l, out, lse]
    if offs is None:
        _call(emu, "mx_flash_fwd_grid_f32", *_ptrs(q, k, v, part_o, part_l),
              *tail)
        _call(emu, "mx_flash_fwd_grid_combine_f32", *_ptrs(*combine),
              b * h, sq, d, width, n, int(causal))
    else:
        _call(emu, "mx_flash_fwd_offs_grid_f32",
              *_ptrs(q, k, v, offs, part_o, part_l), *tail)
        _call(emu, "mx_flash_fwd_offs_grid_combine_f32",
              *_ptrs(offs, *combine), b * h, sq, d, width, n, int(causal))
    return out, lse


def _hold(what, out, lse, ref):
    assert not (torch.isnan(out).any() or torch.isnan(lse).any())
    err = max(_err(out, ref[0]), _err(lse, ref[1]))
    print("%s: out/lse %.2e" % (what, err))
    assert err <= GATE, err
    dead = ref[1] == NEG
    assert (lse[dead] == NEG).all() and (out[dead] == 0).all()
    return err


@pytest.mark.parametrize("shape", [(1, 2, 96, 32), (1, 1, 64, 128)])
def test_training_forward_kernel(emu, shape):
    b, h, s, d = shape
    q, k, v = _qkv(b, h, s, s, d, 0)
    out, lse = _forward(emu, q, k, v, True)
    _hold("#5 %s" % (shape,), out, lse,
          tfa.flash_fwd_plain(q, k, v, 1.0 / math.sqrt(d), True))
    again = _forward(emu, q, k, v, True)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


def test_offset_forward_kernel_masks_whole_rows(emu):
    q, k, v = _qkv(1, 1, 64, 96, 64, 1)
    offs = torch.tensor([0, 24], dtype=torch.int32)
    out, lse = _forward(emu, q, k, v, True, offs)
    ref = tfa.flash_fwd_offs_plain(q, k, v, offs, 0.125, True)
    _hold("#1", out, lse, ref)
    assert (ref[1][..., :24] == NEG).all()
    assert (ref[1][..., 24:] > NEG / 2).all()


def test_split_forward_kernel_and_combine(emu):
    q, k, v = _qkv(1, 1, 256, 256, 32, 2)
    out, lse = _forward(emu, q, k, v, True, width=96)
    _hold("#6", out, lse, tfa.flash_fwd_grid_plain(
        q, k, v, 1.0 / math.sqrt(32), True, 96))


def test_offset_split_forward_kernel_with_dead_splits(emu):
    q, k, v = _qkv(1, 1, 80, 192, 32, 3)
    offs = torch.tensor([40, 0], dtype=torch.int32)
    out, lse = _forward(emu, q, k, v, True, offs, width=64)
    _hold("#3", out, lse, tfa.flash_fwd_offs_grid_plain(
        q, k, v, offs, 1.0 / math.sqrt(32), True, 64))


def test_backward_pair_kernels(emu):
    q, k, v = _qkv(1, 1, 96, 96, 32, 4)
    rng = np.random.RandomState(5)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    sm = 1.0 / math.sqrt(32)
    offs = torch.tensor([0, 0], dtype=torch.int32)
    out, lse = tfa.flash_fwd_plain(q, k, v, sm, True)
    deff = tfa._deff(do, out, None).contiguous()
    dq, dk, dv = (torch.full_like(q, math.nan) for _ in range(3))
    common = _ptrs(q, k, v, offs, do, lse, deff)
    tail = [1, 96, 96, 32, sm, 1]
    _call(emu, "mx_flash_bwd_dq_f32", *common, dq.data_ptr(), *tail)
    _call(emu, "mx_flash_bwd_dkv_f32", *common, *_ptrs(dk, dv), *tail)
    ref = tfa.flash_bwd_offs_plain(q, k, v, offs, do, None, out, lse, sm,
                                   True)
    errs = [_err(got, want) for got, want in zip((dq, dk, dv), ref)]
    print("#2: dq/dk/dv %s" % ["%.2e" % e for e in errs])
    assert max(errs) <= GATE, errs


# ----------------------------------------------------- bf16, float16 ----

BF, F16 = torch.bfloat16, torch.float16


def _ids(value):
    """Test ids: the 16-bit dtypes by their entries' suffix."""
    return {BF: "bf16", F16: "f16"}.get(value)


def _half(dtype, *ts):
    return [t.to(dtype).contiguous() for t in ts]


def _sfx(t):
    return "_" + tfa._DTYPES[t.dtype]


def _forward_half(emu, q, k, v, causal, offs=None):
    b, h, sq, d = q.shape
    sm = 1.0 / math.sqrt(d)
    out = torch.full_like(q, math.nan)
    lse = torch.full((b, h, sq), math.nan)
    tail = [b * h, sq, k.shape[2], d, sm, int(causal)]
    if offs is None:
        _call(emu, "mx_flash_fwd" + _sfx(q), *_ptrs(q, k, v, out, lse),
              *tail)
    else:
        _call(emu, "mx_flash_fwd_offs" + _sfx(q),
              *_ptrs(q, k, v, offs, out, lse), *tail)
    return out, lse


@pytest.mark.parametrize("entry,shape,q0,k0,dtype", [
    ("#5", (1, 2, 96, 96, 32), 0, 0, BF),
    ("#5", (1, 1, 64, 64, 128), 0, 0, BF),
    ("#1", (1, 1, 64, 160, 64), 0, 24, BF),
    ("#1", (1, 1, 32, 80, 64), 48, 0, BF),
    ("#5", (1, 1, 96, 96, 64), 0, 0, F16),
    ("#1", (1, 1, 64, 160, 32), 0, 24, F16)], ids=_ids)
def test_bf16_forward_kernels(emu, entry, shape, q0, k0, dtype):
    b, h, sq, sk, d = shape
    q, k, v = _half(dtype, *_qkv(b, h, sq, sk, d, 6))
    sm = 1.0 / math.sqrt(d)
    if entry == "#5":
        offs = None
        ref = tfa.flash_fwd_plain(q, k, v, sm, True)
    else:
        offs = torch.tensor([q0, k0], dtype=torch.int32)
        ref = tfa.flash_fwd_offs_plain(q, k, v, offs, sm, True)
    out, lse = _forward_half(emu, q, k, v, True, offs)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert not (torch.isnan(out.float()).any() or torch.isnan(lse).any())
    dead = ref[1] == NEG
    ulps, lerr = row_ulps(out, ref[0]), _err(lse[~dead], ref[1][~dead])
    print("%s %s %s: out %.2f ulps, lse %.2e" % (entry, dtype, shape, ulps,
                                                 lerr))
    assert ulps <= GATES[dtype][2] and lerr <= GATE, (ulps, lerr)
    assert (lse[dead] == NEG).all() and (out[dead] == 0).all()
    again = _forward_half(emu, q, k, v, True, offs)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("d,q0,k0,dtype", [(32, 0, 0, BF), (64, 16, 40, BF),
                                           (128, 0, 0, BF), (64, 16, 40, F16)],
                         ids=_ids)
def test_bf16_backward_pair_kernels(emu, d, q0, k0, dtype):
    s = 64 if d == 128 else 96
    q, k, v = _half(dtype, *_qkv(1, 1, s, s, d, 7))
    rng = np.random.RandomState(8)
    do, = _half(dtype, torch.from_numpy(rng.standard_normal(q.shape)
                                        .astype(np.float32)))
    sm = 1.0 / math.sqrt(d)
    offs = torch.tensor([q0, k0], dtype=torch.int32)
    out, lse = tfa.flash_fwd_offs_plain(q, k, v, offs, sm, True)
    deff = tfa._deff(do, out, None).contiguous()
    dq, dk, dv = (torch.full_like(q, math.nan) for _ in range(3))
    common = _ptrs(q, k, v, offs, do, lse, deff)
    tail = [1, s, s, d, sm, 1]
    _call(emu, "mx_flash_bwd_dq" + _sfx(q), *common, dq.data_ptr(), *tail)
    _call(emu, "mx_flash_bwd_dkv" + _sfx(q), *common, *_ptrs(dk, dv), *tail)
    ref = tfa.flash_bwd_offs_plain(q, k, v, offs, do, None, out, lse, sm,
                                   True)
    ulps = [row_ulps(got, want) for got, want in zip((dq, dk, dv), ref)]
    print("#2 %s D=%d: dq/dk/dv %s ulps" % (dtype, d,
                                           ["%.2f" % u for u in ulps]))
    assert all(g.dtype == dtype for g in (dq, dk, dv))
    assert max(ulps) <= GATES[dtype][2], ulps
    if k0 > q0:   # rows that see no key, keys no row sees: exactly 0
        assert (dq[..., :k0 - q0, :].float() == 0).all()


# ------------------------------------------------ bf16, float16 grid ----

def _forward_grid_half(emu, q, k, v, causal, width, offs=None):
    """(out, lse) through #6 (``offs`` None) or #3 in q's 16-bit dtype and,
    with more than one split, its combine pass over the float32
    workspace."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    n = len(tfa._splits(sk, width))
    out = torch.full_like(q, math.nan)
    lse = torch.full((b, h, sq), math.nan)
    if n == 1:
        dst = (out, lse)
    else:
        dst = (torch.full((n, b, h, sq, d), math.nan),
               torch.full((n, b, h, sq), math.nan))
    geo = [b * h, sq, sk, d, width, n, 1.0 / math.sqrt(d), int(causal)]
    pre = [] if offs is None else [offs]
    name = "mx_flash_fwd_grid" if offs is None else "mx_flash_fwd_offs_grid"
    _call(emu, name + _sfx(q), *_ptrs(q, k, v, *pre, *dst), *geo)
    if n > 1:
        _call(emu, name + "_combine" + _sfx(q), *_ptrs(*pre, *dst, out, lse),
              b * h, sq, d, width, n, int(causal))
    return out, lse


@pytest.mark.parametrize("entry,shape,q0,k0,width,dtype", [
    ("#6", (1, 1, 256, 256, 32), 0, 0, 96, BF),
    ("#6", (1, 1, 64, 64, 128), 0, 0, 32, BF),
    ("#3", (1, 1, 80, 192, 32), 40, 0, 64, BF),
    ("#3", (1, 1, 64, 160, 64), 0, 24, 64, BF),
    ("#6", (1, 1, 128, 128, 64), 0, 0, 96, F16),
    ("#3", (1, 1, 80, 192, 32), 40, 0, 64, F16)], ids=_ids)
def test_bf16_split_forward_kernels_and_combine(emu, entry, shape, q0, k0,
                                                width, dtype):
    """#6 with three 96-key splits of 256 keys (the last ragged) and with
    one split per 32-key tile at D = 128; #3 at an offset where some
    blocks' splits are dead, and where the first rows see no key; float16
    through #6 with ragged splits and #3 with dead ones."""
    b, h, sq, sk, d = shape
    q, k, v = _half(dtype, *_qkv(b, h, sq, sk, d, 9))
    sm = 1.0 / math.sqrt(d)
    offs = None if entry == "#6" else torch.tensor([q0, k0],
                                                   dtype=torch.int32)
    if offs is None:
        ref = tfa.flash_fwd_grid_plain(q, k, v, sm, True, width)
    else:
        ref = tfa.flash_fwd_offs_grid_plain(q, k, v, offs, sm, True, width)
    out, lse = _forward_grid_half(emu, q, k, v, True, width, offs)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert not (torch.isnan(out.float()).any() or torch.isnan(lse).any())
    dead = ref[1] == NEG
    ulps, lerr = row_ulps(out, ref[0]), _err(lse[~dead], ref[1][~dead])
    print("%s %s %s splits of %d: out %.2f ulps, lse %.2e"
          % (entry, dtype, shape, width, ulps, lerr))
    assert ulps <= GATES[dtype][2] and lerr <= GATE, (ulps, lerr)
    assert (lse[dead] == NEG).all() and (out[dead] == 0).all()
    again = _forward_grid_half(emu, q, k, v, True, width, offs)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("d,s,q0,k0,widths,dtype", [
    (32, 160, 0, 0, (64, 96), BF), (64, 96, 16, 40, (32, 64), BF),
    (128, 64, 0, 0, (32, 32), BF), (64, 96, 16, 40, (32, 64), F16)],
    ids=_ids)
def test_bf16_split_backward_kernels_and_reduce(emu, d, s, q0, k0, widths,
                                                dtype):
    """#4 in bf16 and float16: dq over key splits and dk/dv over query
    splits (ragged last splits, dead (block, split) pairs at an offset),
    each with its reduce pass of the dtype, against the plain split
    backward; two calls give the same bits."""
    q, k, v = _half(dtype, *_qkv(1, 1, s, s, d, 10))
    rng = np.random.RandomState(11)
    do, = _half(dtype, torch.from_numpy(rng.standard_normal(q.shape)
                                        .astype(np.float32)))
    sm = 1.0 / math.sqrt(d)
    offs = torch.tensor([q0, k0], dtype=torch.int32)
    out, lse = tfa.flash_fwd_offs_plain(q, k, v, offs, sm, True)
    deff = tfa._deff(do, out, None).contiguous()
    wq, wk = widths
    nq, nk = len(tfa._splits(s, wq)), len(tfa._splits(s, wk))
    common = _ptrs(q, k, v, offs, do, lse, deff)

    def run():
        dq, dk, dv = (torch.full_like(q, math.nan) for _ in range(3))
        parts = [torch.full((n, 1, 1, s, d), math.nan)
                 for n in (nk, nq, nq)]
        sfx = _sfx(q)
        _call(emu, "mx_flash_bwd_dq_grid" + sfx, *common,
              parts[0].data_ptr(), 1, s, s, d, wk, nk, sm, 1)
        _call(emu, "mx_flash_bwd_dq_grid_reduce" + sfx,
              *_ptrs(offs, parts[0], dq), 1, s, d, wk, nk, sm, 1)
        _call(emu, "mx_flash_bwd_dkv_grid" + sfx, *common,
              *_ptrs(parts[1], parts[2]), 1, s, s, d, wq, nq, sm, 1)
        _call(emu, "mx_flash_bwd_dkv_grid_reduce" + sfx,
              *_ptrs(offs, parts[1], parts[2], dk, dv), 1, s, s, d, wq, nq,
              1)
        return dq, dk, dv

    got = run()
    ref = tfa.flash_bwd_offs_grid_plain(q, k, v, offs, do, None, out, lse,
                                        sm, True, wq, wk)
    ulps = [row_ulps(g, w) for g, w in zip(got, ref)]
    print("#4 %s D=%d splits %s: dq/dk/dv %s ulps"
          % (dtype, d, widths, ["%.2f" % u for u in ulps]))
    assert all(g.dtype == dtype for g in got)
    assert max(ulps) <= GATES[dtype][2], ulps
    if k0 > q0:   # rows that see no key: exactly 0
        assert (got[0][..., :k0 - q0, :].float() == 0).all()
    assert all(torch.equal(a, b) for a, b in zip(run(), got))
