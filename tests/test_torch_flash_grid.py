"""The port's split-KV grid attention held against the JAX package's grid
kernels on the CPU.

- The plain versions of the three grid kernels (``flash_fwd_grid_plain``
  for ``_flash_fwd_grid_kernel``, ``flash_fwd_offs_grid_plain`` for
  ``_flash_fwd_offs_grid_kernel``, ``flash_bwd_offs_grid_plain`` for the
  pair ``_flash_bwd_dq_grid_kernel``/``_flash_bwd_dkv_grid_kernel``)
  against the Pallas launchers run in interpret mode, at (sq, sk) in
  {(128, 128), (64, 16), (16, 64)} and offsets (0, 0), (64, 0), (0, 64)
  and (64, 128). Fully masked rows and keys must be exact: out 0, lse
  -1e30, zero gradients.
- ``flash_attention(variant="grid")`` (``_FlashAttention`` with splits)
  against ``jax.vjp`` of ``_flash_attention_tpu(..., "grid")``, and
  ``flash_attention_with_lse(variant="grid")`` (``_FlashWithLse`` with
  splits) against ``jax.vjp`` of the JAX ``custom_vjp`` with both
  cotangents.
- The plain versions at one split, several, and one per 32-key tile: they
  agree within 1e-6 and are bit-identical from call to call (the split
  count depends on shapes and arguments only).

B = 1, H = 2, D in {16, 32}; JAX blocks of min(32, n), the port's splits
``split_width(32, n)`` = 32 rows. Tolerance: float32 on both sides in
another order of summation (the port merges per-split softmaxes, the JAX
kernel runs an online softmax over blocks), so 1e-5 absolute and relative
for forward values and 1e-4 relative / 1e-5 absolute for gradients (each
gradient sums over a whole row or column of scores). Across split counts
the port's own plain versions differ only by the merge's rounding: 1e-6.
The JAX launchers are jitted once per shape (the offsets are data), so the
file stays cheap.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the module, not the function of the same name the package re-exports
jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SPLIT_TOL = dict(rtol=1e-6, atol=1e-6)
NEG = -1e30
BLOCK = 32
SHAPES = [(128, 128), (64, 16), (16, 64)]
OFFSETS = [(0, 0), (64, 0), (0, 64), (64, 128)]


def _inputs(seed, sq, sk, d):
    rng = np.random.RandomState(seed)
    q, do = (rng.standard_normal((1, 2, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, sk, d)).astype(np.float32)
            for _ in range(2))
    dlse = rng.standard_normal((1, 2, sq)).astype(np.float32)
    return q, k, v, do, dlse


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _dead_rows(sq, offs):
    return np.arange(sq) + offs[0] < offs[1]


def _dead_keys(sq, sk, offs):
    return np.arange(sk) + offs[1] > sq - 1 + offs[0]


@functools.lru_cache(maxsize=None)
def _jax_fwd_offs(sq, sk, d):
    """The JAX grid launchers at one shape, jitted once (offsets are an
    argument), with the same residuals handed to the backward."""
    sm = 1.0 / np.sqrt(d)
    bq, bk = min(BLOCK, sq), min(BLOCK, sk)
    fwd = jax.jit(lambda q, k, v, o: jfa._flash_fwd_offs_grid_pallas(
        q, k, v, o, sm, True, bq, bk, interpret=True))
    bwd = jax.jit(lambda q, k, v, o, do, dl, out, lse:
                  jfa._flash_bwd_offs_grid_pallas(
                      q, k, v, o, do, dl, out, lse, sm, True, bq, bk,
                      interpret=True))
    return fwd, bwd


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", SHAPES)
def test_fwd_grid_plain_matches_pallas(sq, sk, causal):
    """#6 (no offsets), D = 32."""
    q, k, v, _, _ = _inputs(0, sq, sk, 32)
    sm = 1.0 / np.sqrt(32)
    ref_o, ref_l = jfa._flash_fwd_grid_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm, causal,
        min(BLOCK, sq), min(BLOCK, sk), interpret=True)
    out, lse = tfa.flash_fwd_grid_plain(_t(q), _t(k), _t(v), sm, causal,
                                        BLOCK)
    _close(out, ref_o, FWD_TOL)
    _close(lse, ref_l, FWD_TOL)


@pytest.mark.parametrize("offs", OFFSETS)
@pytest.mark.parametrize("sq,sk", SHAPES)
def test_offs_grid_plain_fwd_and_bwd_match_pallas(sq, sk, offs):
    """#3 and #4 at global offsets, D = 16, from the same forward
    residuals and a nonzero lse cotangent."""
    d = 16
    sm = 1.0 / np.sqrt(d)
    q, k, v, do, dlse = _inputs(1, sq, sk, d)
    fwd, bwd = _jax_fwd_offs(sq, sk, d)
    offs_j = jnp.asarray(offs, jnp.int32)
    ref_o, ref_l = fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       offs_j)
    offs_t = torch.tensor(offs, dtype=torch.int32)
    out, lse = tfa.flash_fwd_offs_grid_plain(_t(q), _t(k), _t(v), offs_t, sm,
                                             True, BLOCK)
    _close(out, ref_o, FWD_TOL)
    _close(lse, ref_l, FWD_TOL)
    dead = _dead_rows(sq, offs)
    assert (lse.numpy()[..., dead] == NEG).all()
    assert (out.numpy()[..., dead, :] == 0.0).all()

    ref = bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offs_j,
              jnp.asarray(do), jnp.asarray(dlse), ref_o, ref_l)
    got = tfa.flash_bwd_offs_grid_plain(_t(q), _t(k), _t(v), offs_t, _t(do),
                                        _t(dlse), _t(ref_o), _t(ref_l), sm,
                                        True, BLOCK, BLOCK)
    for g, r in zip(got, ref):
        _close(g, r, GRAD_TOL)
    dq, dk, dv = (g.numpy() for g in got)
    dead_keys = _dead_keys(sq, sk, offs)
    assert (dq[..., dead, :] == 0.0).all()
    assert (dk[..., dead_keys, :] == 0.0).all()
    assert (dv[..., dead_keys, :] == 0.0).all()


def test_flash_attention_grid_matches_jax_vjp(monkeypatch):
    """flash_attention(variant="grid")'s kernel tier, _FlashAttention with
    splits (forward #6, backward #4 at offs 0), on CPU tensors against
    jax.vjp of _flash_attention_tpu(..., "grid") in interpret mode,
    causal, four key splits. The tier resolver is told to pick the kernel
    tier, whose CPU path is the kernels' plain versions."""
    q, k, v, do, _ = _inputs(2, 128, 128, 16)
    sm = 1.0 / np.sqrt(16)
    f = lambda q, k, v: jfa._flash_attention_tpu(q, k, v, sm, True, BLOCK,
                                                 BLOCK, True, "grid")
    ref_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_g = vjp(jnp.asarray(do))
    before = (tfa.launches_fwd_grid, tfa.launches_bwd_dq_grid,
              tfa.launches_bwd_dkv_grid)
    monkeypatch.setattr(tfa, "resolve_kernel_tier",
                        lambda mode, device: True)
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=True, sm_scale=sm, block_q=BLOCK,
                              block_k=BLOCK, variant="grid")
    assert "_FlashAttentionBackward" in type(out.grad_fn).__name__
    out.backward(_t(do))
    _close(out, ref_o, FWD_TOL)
    for t, r in zip(ts, ref_g):
        _close(t.grad, r, GRAD_TOL)
    assert (tfa.launches_fwd_grid, tfa.launches_bwd_dq_grid,
            tfa.launches_bwd_dkv_grid) == before, "CPU calls count no launch"


@functools.lru_cache(maxsize=None)
def _jax_with_lse_vjp(sm):
    """(out, lse) and the q/k/v cotangents of the JAX custom_vjp with the
    grid variant, jitted once (the offsets are an argument)."""
    def run(q, k, v, do, dlse, offs):
        f = lambda q, k, v: jfa.flash_attention_with_lse(
            q, k, v, offs, sm, True, BLOCK, BLOCK, True, "grid")
        outs, vjp = jax.vjp(f, q, k, v)
        return outs, vjp((do, dlse))
    return jax.jit(run)


@pytest.mark.parametrize("offs", [(64, 0), (0, 64)])
def test_flash_with_lse_grid_matches_jax_vjp(offs):
    """flash_attention_with_lse(variant="grid") on CPU tensors against
    jax.vjp of the JAX custom_vjp with the grid variant, both cotangents
    nonzero; (0, 64) has rows that see no key."""
    q, k, v, do, dlse = _inputs(3, 64, 64, 16)
    sm = 1.0 / np.sqrt(16)
    (ref_o, ref_l), ref_g = _jax_with_lse_vjp(sm)(
        *(jnp.asarray(a) for a in (q, k, v, do, dlse)),
        jnp.asarray(offs, jnp.int32))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = tfa.flash_attention_with_lse(
        *ts, torch.tensor(offs, dtype=torch.int32), sm, True, BLOCK, BLOCK,
        variant="grid")
    assert "_FlashWithLseBackward" in type(out.grad_fn).__name__
    torch.autograd.backward((out, lse), (_t(do), _t(dlse)))
    _close(out, ref_o, FWD_TOL)
    _close(lse, ref_l, FWD_TOL)
    for t, r in zip(ts, ref_g):
        _close(t.grad, r, GRAD_TOL)


@pytest.mark.parametrize("offs", [(0, 0), (100, 0), (0, 50)])
def test_split_counts_agree_and_repeat_bit_for_bit(offs):
    """The plain versions at one split (block 512), several (block 64:
    four of 200 keys, the last ragged) and one per 32-key tile (block 1:
    seven) agree within 1e-6, and two calls give the same bits."""
    q, k, v, do, dlse = (_t(a) for a in _inputs(4, 150, 200, 32))
    offs_t = torch.tensor(offs, dtype=torch.int32)
    assert [len(tfa._splits(200, tfa.split_width(b, 200)))
            for b in (512, 64, 1)] == [1, 4, 7]
    results = []
    for block in (512, 64, 1):
        runs = []
        for _ in range(2):
            out, lse = tfa.flash_fwd_offs_grid_plain(q, k, v, offs_t, None,
                                                     True, block)
            grads = tfa.flash_bwd_offs_grid_plain(q, k, v, offs_t, do, dlse,
                                                  out, lse, None, True,
                                                  block, block)
            runs.append((out, lse) + grads)
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        results.append(runs[0])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            lse_like = a.dim() == 3
            if lse_like:   # pinned rows compare exactly, live ones closely
                assert torch.equal(a == NEG, b == NEG)
                a, b = a[a != NEG], b[b != NEG]
            np.testing.assert_allclose(a.numpy(), b.numpy(), **SPLIT_TOL)
    out, lse = tfa.flash_fwd_grid_plain(q, k, v, None, True, 64)
    ref = tfa.flash_fwd_plain(q, k, v, None, True)
    np.testing.assert_allclose(out.numpy(), ref[0].numpy(), **SPLIT_TOL)
    np.testing.assert_allclose(lse.numpy(), ref[1].numpy(), **SPLIT_TOL)


def test_split_width_and_combine_of_dead_splits():
    """Split widths round the JAX block up to the 32-row tile (and are
    idempotent); a merge over splits a row cannot see gives (0, -1e30)
    exactly, with no nan."""
    assert [tfa.split_width(b, n) for b, n in
            ((512, 4096), (16, 64), (512, 100), (1, 7), (96, 96))] == \
        [512, 32, 128, 32, 96]
    assert tfa.split_width(tfa.split_width(40, 1000), 1000) == 64
    out_part = torch.zeros(3, 1, 2, 4, 8)
    lse_part = torch.full((3, 1, 2, 4), NEG)
    lse_part[1, 0, 0, 1] = 0.5
    out_part[1, 0, 0, 1] = 2.0
    out, lse = tfa._combine_splits(out_part, lse_part)
    assert torch.isfinite(out).all()
    assert lse[0, 0, 1] == 0.5 and (out[0, 0, 1] == 2.0).all()
    live = torch.zeros(1, 2, 4, dtype=torch.bool)
    live[0, 0, 1] = True
    assert (lse[~live] == NEG).all() and (out[~live] == 0).all()


def test_grid_wrappers_check_their_split_widths():
    """The CUDA wrappers refuse a split width the kernels cannot walk
    before they build or launch anything."""
    q = torch.zeros(1, 2, 64, 32)
    with pytest.raises(MXNetError, match="split width"):
        tfa._flash_fwd_grid_cuda(q, q, q, None, 0.125, True, 48)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(MXNetError, match="split width"):
        tfa._flash_bwd_grid_cuda(q, q, q, torch.zeros(2, dtype=torch.int32),
                                 q, lse, lse, 0.125, True, (32, 0))
