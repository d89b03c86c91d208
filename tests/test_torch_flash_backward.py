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

- The arithmetic of the CUDA pair (``flash_bwd.cuh``), emulated here in
  numpy: every product as three TF32 products (3xTF32), against the
  Pallas pair in interpret mode at (1, 2, 256, 64) and (1, 2, 160, 128)
  causal, within the 1e-4 gate that ``chip_smoke.py`` holds the kernels
  to (max abs error over the reference's max abs where that exceeds 1).
  One TF32 product's error is printed beside it: it is why the kernels
  take three.

Cases: causal and non-causal at the origin, a chunk at ``offs = [5, 0]``,
a ring step ``[0, 4]`` whose first rows see no key, and ``[0, 16]`` whose
rows all see none. Fully masked rows must give exactly zero gradient.

Tolerance: float32 on both sides in another order of summation, so 1e-5
absolute and relative for forward values and 1e-4 relative / 1e-5
absolute for gradients (each gradient sums over a whole row or column of
scores).
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

from mxnet_tpu_torch.kernels import flash_attention as tfa
from torch_one_thread import one_torch_thread  # noqa: F401

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


@functools.lru_cache(maxsize=None)
def _pallas_bwd(causal):
    """The forward residuals and the Pallas pair in interpret mode, one
    jitted program a mask: the offsets are traced, so the cases of a mask
    share its compile."""
    def run(q, k, v, offs, do, dlse):
        out, lse = jfa.flash_attention_with_lse(q, k, v, offs, SM, causal,
                                                BLOCK, BLOCK, True, "stream")
        return out, lse, jfa._flash_bwd_offs_pallas(
            q, k, v, offs, do, dlse, out, lse, SM, causal, BLOCK, BLOCK,
            interpret=True)
    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _lse_vjp(causal):
    """jax.vjp of the JAX flash_attention_with_lse, one jitted program a
    mask (offsets traced)."""
    def run(q, k, v, offs, do, dlse):
        (out, lse), vjp = jax.vjp(
            lambda q, k, v: jfa.flash_attention_with_lse(
                q, k, v, offs, SM, causal, BLOCK, BLOCK, True, "stream"),
            q, k, v)
        return out, lse, vjp((do, dlse))
    return jax.jit(run)


@pytest.mark.parametrize("causal,offs", CASES)
def test_flash_bwd_offs_plain_matches_pallas(causal, offs):
    """The plain backward against the Pallas pair, from the same forward
    residuals and a nonzero lse cotangent."""
    q, k, v, do, dlse = _inputs(1)
    out, lse, ref = _pallas_bwd(causal)(q, k, v,
                                        np.asarray(offs, np.int32), do, dlse)
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
    ref_o, ref_l, ref_g = _lse_vjp(causal)(
        q, k, v, np.asarray(offs, np.int32), do, dlse)
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


# --- the tensor-core kernels' arithmetic (3xTF32), emulated -------------

KERNEL_GATE = 1e-4
LOG2E = np.float32(1.4426950408889634)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does: on the bit pattern."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm(a, b, terms):
    """a @ b in float32 from TF32 operands: ``terms`` 3 is the kernels'
    hi.hi + hi.lo + lo.hi with x = hi + lo, both rounded to TF32; 1 is a
    single TF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _kernel_bwd(q, k, v, do, deff, lse, sm, terms):
    """dq, dk, dv by the kernels' formulas: scores from unscaled q, scaled
    on the accumulator, p by exp2, masked entries exactly 0, sm_scale on
    dq and dk at the end."""
    sq, sk = q.shape[-2], k.shape[-2]
    kt = np.swapaxes(k, -1, -2)
    s = _mm(q, kt, terms)
    dp = _mm(do, np.swapaxes(v, -1, -2), terms)
    lse_safe = np.where(lse > -5e29, lse, np.float32(1e30))
    p = np.exp2(s * np.float32(sm) * LOG2E - (lse_safe * LOG2E)[..., None])
    p = np.where(np.tril(np.ones((sq, sk), bool)), p, np.float32(0))
    ds = (p * (dp - deff[..., None])).astype(np.float32)
    dq = _mm(ds, k, terms) * np.float32(sm)
    dk = _mm(np.swapaxes(ds, -1, -2), q, terms) * np.float32(sm)
    dv = _mm(np.swapaxes(p, -1, -2).astype(np.float32), do, terms)
    return dq, dk, dv


def _scaled_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("shape,block", [((1, 2, 256, 64), 64),
                                         ((1, 2, 160, 128), 32)])
def test_kernel_3xtf32_arithmetic_matches_pallas(shape, block):
    b, h, s, d = shape
    sm = 1.0 / np.sqrt(d)
    rng = np.random.RandomState(7)
    q, k, v, do = [rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4)]
    dlse = rng.standard_normal((b, h, s)).astype(np.float32)
    # forward residuals in float64, shared by both sides
    sc = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * sm
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    lse = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) + \
        sc.max(-1)
    out = np.einsum("bhqk,bhkd->bhqd", np.exp(sc - lse[..., None]), v)
    lse, out = lse.astype(np.float32), out.astype(np.float32)
    ref = jfa._flash_bwd_offs_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.zeros(2, jnp.int32), jnp.asarray(do), jnp.asarray(dlse),
        jnp.asarray(out), jnp.asarray(lse), sm, True, block, block,
        interpret=True)
    deff = ((do * out).sum(-1) - dlse).astype(np.float32)
    got3 = _kernel_bwd(q, k, v, do, deff, lse, sm, 3)
    got1 = _kernel_bwd(q, k, v, do, deff, lse, sm, 1)
    errs3 = [_scaled_err(g, r) for g, r in zip(got3, ref)]
    errs1 = [_scaled_err(g, r) for g, r in zip(got1, ref)]
    print("%s: 3xTF32 dq/dk/dv %s; one TF32 product %s"
          % (shape, ["%.2e" % e for e in errs3], ["%.2e" % e for e in errs1]))
    assert max(errs3) <= KERNEL_GATE, errs3
