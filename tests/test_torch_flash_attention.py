"""The port's attention (mxnet_tpu_torch/kernels/flash_attention.py) held
against the JAX package's on identical numpy inputs.

- The plain versions (attention_with_lse, merge_attention,
  blockwise_attention) against their JAX counterparts, fully masked rows
  included.
- flash_attention_with_lse on CPU tensors (the plain version of the CUDA
  kernel) against the JAX flash_attention_with_lse running the Pallas
  kernel _flash_fwd_offs_kernel in interpret mode.

Tolerance: float32, 1e-5 absolute and relative — both sides compute the
same float32 arithmetic in a different summation order. Fully masked
rows are compared exactly (lse pinned to -1e30, out 0).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the module, not the function of the same name the package re-exports
jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")

from mxnet_tpu_torch.kernels import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

# float32 stays float32 (matters on a card, where cuBLAS may use TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = ATOL = 1e-5
NEG = -1e30


def _qkv(seed, sq=8, sk=12, d=16, lead=(2, 3)):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal(lead + (sq, d)).astype(np.float32)
    k = rng.standard_normal(lead + (sk, d)).astype(np.float32)
    v = rng.standard_normal(lead + (sk, d)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# (causal, q_offset, k_offset): plain, causal at the origin, a chunk past
# the origin, and a ring step ahead of the causal frontier (rows 0..3 see
# no key at all)
CASES = [(False, 0, 0), (True, 0, 0), (True, 5, 0), (True, 0, 4)]


@pytest.mark.parametrize("causal,q_off,k_off", CASES)
@pytest.mark.parametrize("offset_as_tensor", [False, True])
def test_attention_with_lse_matches_jax(causal, q_off, k_off,
                                        offset_as_tensor):
    q, k, v = _qkv(0)
    ref_o, ref_l = jfa.attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_off, k_offset=k_off)
    qo, ko = ((torch.tensor(q_off), torch.tensor(k_off))
              if offset_as_tensor else (q_off, k_off))
    out, lse = tfa.attention_with_lse(*_t(q, k, v), causal=causal,
                                      q_offset=qo, k_offset=ko)
    _close(out, ref_o)
    _close(lse, ref_l)
    if causal and k_off > q_off:
        dead = np.arange(8) + q_off < k_off
        assert (lse.numpy()[..., dead] == NEG).all()
        assert (out.numpy()[..., dead, :] == 0.0).all()


def test_merge_attention_matches_jax():
    """Two partial attentions over disjoint key halves, one of them with
    fully masked rows, and a pair where both sides are fully masked."""
    q, k, v = _qkv(1)
    halves = ((slice(0, 6), 0), (slice(6, 12), 6))

    def merged(fa, q, k, v):
        parts = [fa.attention_with_lse(q, k[..., s, :], v[..., s, :],
                                       causal=True, q_offset=2, k_offset=o)
                 for s, o in halves]
        return fa.merge_attention(*parts[0], *parts[1])

    ref = jax.jit(lambda *a: merged(jfa, *a))(q, k, v)
    got = merged(tfa, *_t(q, k, v))
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    # both sides fully masked: out 0, lse -1e30, no nan
    dead_o = torch.zeros(2, 3, 8, 16)
    dead_l = torch.full((2, 3, 8), NEG)
    o, l = tfa.merge_attention(dead_o, dead_l, dead_o, dead_l)
    assert (o == 0).all() and (l == NEG).all()


@pytest.mark.parametrize("causal,q_off,k_off", CASES[2:])
def test_blockwise_attention_matches_jax(causal, q_off, k_off):
    q, k, v = _qkv(2, sq=8, sk=16)
    ref_o, ref_l = jfa.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_k=4, q_offset=q_off, k_offset=k_off)
    out, lse = tfa.blockwise_attention(*_t(q, k, v), causal=causal,
                                       block_k=4, q_offset=q_off,
                                       k_offset=k_off)
    _close(out, ref_o)
    _close(lse, ref_l)


@pytest.mark.parametrize("offs", [(0, 0), (8, 0)])
def test_flash_with_lse_cpu_matches_pallas_interpret(offs):
    """The CPU path of the kernel wrapper (its plain version) against the
    Pallas offset kernel in interpret mode: (1, 2, 16, 16) queries against
    (1, 2, 32, 16) keys, at the start of a sequence and one chunk in."""
    q, k, v = _qkv(3, sq=16, sk=32, d=16, lead=(1, 2))
    sm = 1.0 / np.sqrt(16)
    ref_o, ref_l = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(offs, jnp.int32), sm, True, 8, 8, True, "stream")
    before = tfa.launches
    out, lse = tfa.flash_attention_with_lse(
        *_t(q, k, v), torch.tensor(offs, dtype=torch.int32), sm, True, 8, 8)
    assert tfa.launches == before, "a CPU call must not count a launch"
    _close(out, ref_o)
    _close(lse, ref_l)
