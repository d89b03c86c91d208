"""The port's flash-attention gradients held against the JAX package's.

- The plain versions of the three kernels on the training path
  (``flash_fwd_plain`` for ``_flash_fwd_kernel``, ``flash_bwd_offs_plain``
  for the pair ``_flash_bwd_dq_offs_kernel``/``_flash_bwd_dkv_offs_kernel``)
  against the Pallas kernels run in interpret mode.
- The two ``torch.autograd.Function``s on CPU tensors (where they run the
  plain versions): ``_FlashAttention`` against ``jax.vjp`` of the JAX
  ``flash_attention`` (``interpret=True``), and ``_FlashWithLse`` (behind
  ``flash_attention_with_lse``) against ``jax.vjp`` of the JAX
  ``flash_attention_with_lse``, with and without an lse cotangent.

Cases: causal and non-causal at the origin, a chunk at ``offs = [5, 0]``,
a ring step ``[0, 4]`` whose first rows see no key, and ``[0, 16]`` whose
rows all see none. Fully masked rows must give exactly zero gradient.

Tolerance: float32 on both sides in another order of summation, so 1e-5
absolute and relative for forward values and 1e-4 relative / 1e-5
absolute for gradients (each gradient sums over a whole row or column of
scores).
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

# float32 stays float32 (matters on a card, where cuBLAS may use TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SQ = SK = 16
D = 16
SM = 1.0 / np.sqrt(D)
BLOCK = 8

# (causal, offs)
CASES = [(True, (0, 0)), (False, (0, 0)), (True, (5, 0)), (True, (0, 4)),
         (True, (0, 16))]


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = [rng.standard_normal((1, 2, SQ, D)).astype(np.float32)
                   for _ in range(4)]
    dlse = rng.standard_normal((1, 2, SQ)).astype(np.float32)
    return q, k, v, do, dlse


def _leaves(*arrs):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrs]


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _dead_rows(offs):
    """Query rows that see no key under the causal mask."""
    return np.arange(SQ) + offs[0] < offs[1]


def _dead_keys(offs):
    """Keys that no query row sees under the causal mask."""
    return np.arange(SK) + offs[1] > SQ - 1 + offs[0]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_matches_pallas(causal):
    q, k, v, _, _ = _inputs(0)
    ref_o, ref_l = jfa._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), SM, causal, BLOCK,
                                         BLOCK, interpret=True)
    out, lse = tfa.flash_fwd_plain(*[torch.from_numpy(a) for a in (q, k, v)],
                                   SM, causal)
    _close(out, ref_o, FWD_TOL)
    _close(lse, ref_l, FWD_TOL)


@pytest.mark.parametrize("causal,offs", CASES)
def test_flash_bwd_offs_plain_matches_pallas(causal, offs):
    """The plain backward against the Pallas pair, from the same forward
    residuals and a nonzero lse cotangent."""
    q, k, v, do, dlse = _inputs(1)
    offs_j = jnp.asarray(offs, jnp.int32)
    out, lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offs_j, SM, causal,
        BLOCK, BLOCK, True, "stream")
    ref = jfa._flash_bwd_offs_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offs_j,
        jnp.asarray(do), jnp.asarray(dlse), out, lse, SM, causal, BLOCK,
        BLOCK, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfa.flash_bwd_offs_plain(t(q), t(k), t(v),
                                   torch.tensor(offs, dtype=torch.int32),
                                   t(do), t(dlse), t(out), t(lse), SM, causal)
    for g, r in zip(got, ref):
        _close(g, r, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_matches_jax_vjp(causal):
    """_FlashAttention (forward #5, backward #2 at offs 0) on CPU tensors
    against jax.vjp of the JAX flash_attention in interpret mode."""
    q, k, v, do, _ = _inputs(2)
    f = lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, sm_scale=SM, block_q=BLOCK, block_k=BLOCK,
        interpret=True)
    ref_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_g = vjp(jnp.asarray(do))
    before = (tfa.launches_fwd, tfa.launches_bwd_dq, tfa.launches_bwd_dkv)
    ts = _leaves(q, k, v)
    out = tfa._FlashAttention.apply(*ts, SM, causal)
    out.backward(torch.from_numpy(do))
    _close(out, ref_o, FWD_TOL)
    for t, r in zip(ts, ref_g):
        _close(t.grad, r, GRAD_TOL)
    assert (tfa.launches_fwd, tfa.launches_bwd_dq,
            tfa.launches_bwd_dkv) == before, "CPU calls count no launch"


@pytest.mark.parametrize("causal,offs", CASES)
@pytest.mark.parametrize("with_dlse", [True, False])
def test_flash_with_lse_function_matches_jax_vjp(causal, offs, with_dlse):
    """flash_attention_with_lse (_FlashWithLse: forward #1, backward #2)
    on CPU tensors against jax.vjp of the JAX custom_vjp. Without an lse
    cotangent only ``out`` reaches the loss, so torch hands the Function
    ``None`` for it and JAX a zero cotangent."""
    q, k, v, do, dlse = _inputs(3)
    if not with_dlse:
        dlse = np.zeros_like(dlse)
    f = lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, jnp.asarray(offs, jnp.int32), SM, causal, BLOCK, BLOCK,
        True, "stream")
    (ref_o, ref_l), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    ref_g = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    ts = _leaves(q, k, v)
    out, lse = tfa.flash_attention_with_lse(
        *ts, torch.tensor(offs, dtype=torch.int32), SM, causal, BLOCK, BLOCK)
    if with_dlse:
        torch.autograd.backward((out, lse), (torch.from_numpy(do),
                                             torch.from_numpy(dlse)))
    else:
        out.backward(torch.from_numpy(do))
    _close(out, ref_o, FWD_TOL)
    _close(lse, ref_l, FWD_TOL)
    for t, r in zip(ts, ref_g):
        _close(t.grad, r, GRAD_TOL)
    if causal:
        dq, dk, dv = (t.grad.numpy() for t in ts)
        assert (dq[..., _dead_rows(offs), :] == 0.0).all()
        assert (dk[..., _dead_keys(offs), :] == 0.0).all()
        assert (dv[..., _dead_keys(offs), :] == 0.0).all()


def test_flash_attention_default_tier_on_cpu_is_plain():
    """The public entry on CPU tensors with use_pallas=None takes the
    plain tier (blockwise_attention), as the JAX entry does off-TPU, and
    agrees with the JAX blockwise path and its gradient."""
    q, k, v, do, _ = _inputs(4)
    f = lambda q, k, v: jfa.flash_attention(q, k, v, causal=True,
                                            block_k=BLOCK, use_pallas=False)
    ref_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_g = vjp(jnp.asarray(do))
    ts = _leaves(q, k, v)
    out = tfa.flash_attention(*ts, causal=True, block_k=BLOCK)
    assert out.grad_fn is not None and \
        "FlashAttention" not in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    _close(out, ref_o, FWD_TOL)
    for t, r in zip(ts, ref_g):
        _close(t.grad, r, GRAD_TOL)
