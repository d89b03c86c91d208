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
  now shares, D = 32.
Skipped where the host has no ``g++``.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import _emulate
from mxnet_tpu_torch.kernels import flash_attention as tfa

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
