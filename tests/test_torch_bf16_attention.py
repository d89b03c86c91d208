"""The plain 16-bit versions of the attention kernels held against the JAX
package's Pallas kernels in interpret mode, on the same bf16 or float16
inputs (every case in bf16; in float16 one case of each kernel, its most
demanding: rows that see no key, several splits).

- #5 ``flash_fwd_plain`` against ``_flash_fwd_pallas`` (causal and not,
  head dims 64 and 128);
- #1 ``flash_fwd_offs_plain`` against ``_flash_fwd_offs_pallas`` at the
  start of a sequence, one chunk in, and a ring-style offset whose first
  rows see no key;
- #2 ``flash_bwd_offs_plain`` against ``_flash_bwd_offs_pallas`` with an
  lse cotangent, from the JAX forward's own out and lse;
- the split-KV ("grid") plain versions against the JAX grid kernels: #6
  ``flash_fwd_grid_plain`` against ``_flash_fwd_grid_pallas``, #3
  ``flash_fwd_offs_grid_plain`` against ``_flash_fwd_offs_grid_pallas``
  (an offset whose first rows see no key) and #4
  ``flash_bwd_offs_grid_plain`` against ``_flash_bwd_offs_grid_pallas``,
  with one split and with several; at one split the plain grid forward
  and backward are bit for bit the stream plain versions (the repairs of
  ROADMAP C4 and C5: float32 scores, statistics and partials, ``p`` and
  ``ds`` rounded before their products, the output rounded once);
- the CPU path of the autograd Functions (``flash_attention_with_lse``,
  ``flash_attention(use_pallas=True)`` on CPU tensors raises, so the
  Function itself) carries the dtype through: 16-bit out and grads,
  float32 lse;
- float16's 5-bit exponent: q scaled so that most of P falls below
  2^-14 (subnormal) and some below 2^-25 (0), where both packages round
  P alike, keeping the subnormals.

Inputs: seeded numpy normals rounded to the dtype once, handed to both
packages. Shapes (1, 2, 128, D), 64-row blocks on the JAX side.
Tolerance: 16-bit outputs within the dtype's limit (``bf16_gate.GATES``:
``BF16_ULPS``, ``F16_ULPS``) in ulps of the dtype at each row's largest
magnitude (``bf16_gate.row_ulps``): both round the same products,
but the JAX kernel takes the softmax max over 64-key blocks as it goes
(``p`` rounds against that running max) where the plain version takes the
row's max at once, and the float32 sums run in another order. lse
(float32) within ``LSE_TOL`` relative; rows that see no key are exactly
(0, -1e30) on both sides.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels.bf16_gate import BF16_ULPS, GATES, row_ulps
from torch_one_thread import one_torch_thread  # noqa: F401

jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LSE_TOL = 1e-5
NEG = -1e30
BLOCK = 64
BF, F16 = torch.bfloat16, torch.float16
#: torch dtype -> jnp dtype
JNP = {BF: jnp.bfloat16, F16: jnp.float16}


def _ids(value):
    """Test ids: the 16-bit dtypes by their entries' suffix."""
    return {BF: "bf16", F16: "f16"}.get(value)


def _half(seed, dtype, *shapes, scale=1.0):
    """Seeded normals (times ``scale``) rounded to ``dtype``: (torch
    tensors, jnp arrays) holding the same values."""
    rng = np.random.RandomState(seed)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                           * scale).to(dtype) for s in shapes]
    return ts, [jnp.asarray(t.float().numpy()).astype(JNP[dtype])
                for t in ts]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.tensor(_np(x))


def _hold_fwd(out, lse, ref_out, ref_lse):
    dtype = out.dtype
    assert dtype in JNP and lse.dtype == torch.float32
    assert ref_out.dtype == JNP[dtype]
    ref_lse = _np(ref_lse)
    dead = ref_lse == NEG
    assert (_np(lse)[dead] == NEG).all() and (_np(out)[dead] == 0).all()
    assert row_ulps(*map(_t, (out, ref_out)), dtype) <= GATES[dtype][2]
    live = ~dead
    np.testing.assert_allclose(_np(lse)[live], ref_lse[live], rtol=LSE_TOL,
                               atol=LSE_TOL)


@pytest.mark.parametrize("dtype,d,causal", [
    (BF, 64, True), (BF, 64, False), (BF, 128, True), (F16, 64, True)],
    ids=_ids)
def test_training_forward_plain_matches_pallas(dtype, d, causal):
    (q, k, v), (jq, jk, jv) = _half(0, dtype, *[(1, 2, 128, d)] * 3)
    sm = 1.0 / math.sqrt(d)
    ref = jfa._flash_fwd_pallas(jq, jk, jv, sm, causal, BLOCK, BLOCK,
                                interpret=True)
    _hold_fwd(*tfa.flash_fwd_plain(q, k, v, sm, causal), *ref)


@pytest.mark.parametrize("dtype,offs", [
    (BF, (0, 0)), (BF, (64, 0)), (BF, (0, 32)), (F16, (0, 32))], ids=_ids)
def test_offset_forward_plain_matches_pallas(dtype, offs):
    (q, k, v), (jq, jk, jv) = _half(1, dtype, (1, 2, 64, 64),
                                    (1, 2, 128, 64), (1, 2, 128, 64))
    ref = jfa._flash_fwd_offs_pallas(jq, jk, jv, jnp.asarray(offs,
                                                             jnp.int32),
                                     0.125, True, BLOCK, BLOCK,
                                     interpret=True)
    got = tfa.flash_fwd_offs_plain(q, k, v, torch.tensor(offs,
                                                         dtype=torch.int32),
                                   0.125, True)
    _hold_fwd(*got, *ref)
    if offs[1] > offs[0]:
        assert (_np(ref[1])[..., :offs[1] - offs[0]] == NEG).all()


@pytest.mark.parametrize("dtype,d,offs", [
    (BF, 64, (0, 0)), (BF, 64, (32, 0)), (BF, 128, (0, 0)),
    (F16, 64, (32, 0))], ids=_ids)
def test_backward_pair_plain_matches_pallas(dtype, d, offs):
    (q, k, v, do), (jq, jk, jv, jdo) = _half(2, dtype,
                                             *[(1, 2, 128, d)] * 4)
    rng = np.random.RandomState(3)
    dlse = rng.standard_normal((1, 2, 128)).astype(np.float32)
    sm = 1.0 / math.sqrt(d)
    joffs = jnp.asarray(offs, jnp.int32)
    jout, jlse = jfa._flash_fwd_offs_pallas(jq, jk, jv, joffs, sm, True,
                                            BLOCK, BLOCK, interpret=True)
    ref = jfa._flash_bwd_offs_pallas(jq, jk, jv, joffs, jdo,
                                     jnp.asarray(dlse), jout, jlse, sm, True,
                                     BLOCK, BLOCK, interpret=True)
    out = torch.tensor(_np(jout)).to(dtype)
    got = tfa.flash_bwd_offs_plain(
        q, k, v, torch.tensor(offs, dtype=torch.int32), do,
        torch.from_numpy(dlse), out, torch.tensor(_np(jlse)), sm, True)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and r.dtype == JNP[dtype], name
        assert row_ulps(_t(g), _t(r), dtype) <= GATES[dtype][2], name


@pytest.mark.parametrize("dtype,causal,block", [
    (BF, True, 128), (BF, True, 32), (BF, False, 64), (F16, True, 32)],
    ids=_ids)
def test_grid_forward_plain_matches_pallas(dtype, causal, block):
    """#6 with one split (block 128) and with 4 or 2; at one split bit for
    bit the stream plain forward."""
    (q, k, v), (jq, jk, jv) = _half(5, dtype, *[(1, 2, 128, 64)] * 3)
    ref = jfa._flash_fwd_grid_pallas(jq, jk, jv, 0.125, causal, block, block,
                                     interpret=True)
    got = tfa.flash_fwd_grid_plain(q, k, v, 0.125, causal, block)
    _hold_fwd(*got, *ref)
    if block == 128:
        want = tfa.flash_fwd_plain(q, k, v, 0.125, causal)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype,offs,block_k", [
    (BF, (0, 0), 128), (BF, (64, 0), 32), (BF, (0, 32), 64),
    (F16, (0, 32), 64)], ids=_ids)
def test_grid_offset_forward_plain_matches_pallas(dtype, offs, block_k):
    """#3 at the start, one chunk in with 4 key splits, and at an offset
    whose first rows see no key (2 splits, the second dead for them); at
    one split bit for bit the stream plain offset forward."""
    (q, k, v), (jq, jk, jv) = _half(6, dtype, (1, 2, 64, 64),
                                    (1, 2, 128, 64), (1, 2, 128, 64))
    toffs = torch.tensor(offs, dtype=torch.int32)
    ref = jfa._flash_fwd_offs_grid_pallas(jq, jk, jv, jnp.asarray(
        offs, jnp.int32), 0.125, True, 64, block_k, interpret=True)
    got = tfa.flash_fwd_offs_grid_plain(q, k, v, toffs, 0.125, True, block_k)
    _hold_fwd(*got, *ref)
    if block_k == 128:
        want = tfa.flash_fwd_offs_plain(q, k, v, toffs, 0.125, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if offs[1] > offs[0]:
        assert (_np(ref[1])[..., :offs[1] - offs[0]] == NEG).all()


@pytest.mark.parametrize("dtype,offs,blocks", [
    (BF, (0, 0), (128, 128)), (BF, (0, 0), (32, 64)),
    (BF, (32, 0), (64, 32)), (F16, (32, 0), (64, 32))], ids=_ids)
def test_grid_backward_plain_matches_pallas(dtype, offs, blocks):
    """#4 with an lse cotangent from the JAX grid forward's out and lse,
    with one split on each axis and with several; at one split bit for
    bit the stream plain backward."""
    (q, k, v, do), (jq, jk, jv, jdo) = _half(7, dtype,
                                             *[(1, 2, 128, 64)] * 4)
    dlse = np.random.RandomState(8).standard_normal((1, 2, 128)).astype(
        np.float32)
    bq, bk = blocks
    joffs = jnp.asarray(offs, jnp.int32)
    jout, jlse = jfa._flash_fwd_offs_grid_pallas(jq, jk, jv, joffs, 0.125,
                                                 True, bq, bk, interpret=True)
    ref = jfa._flash_bwd_offs_grid_pallas(jq, jk, jv, joffs, jdo,
                                          jnp.asarray(dlse), jout, jlse,
                                          0.125, True, bq, bk,
                                          interpret=True)
    args = (q, k, v, torch.tensor(offs, dtype=torch.int32), do,
            torch.from_numpy(dlse), torch.tensor(_np(jout)).to(dtype),
            torch.tensor(_np(jlse)), 0.125, True)
    got = tfa.flash_bwd_offs_grid_plain(*args, bq, bk)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and r.dtype == JNP[dtype], name
        assert row_ulps(_t(g), _t(r), dtype) <= GATES[dtype][2], name
    if blocks == (128, 128):
        want = tfa.flash_bwd_offs_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_float16_subnormal_p_plain_matches_pallas():
    """float16 with q scaled by 6: scores of std ~6 put most of P =
    exp(s - m) below 2^-14, float16's least normal, and some below 2^-25,
    where it rounds to 0. The plain #5 forward and #2 backward keep P's
    and dS's subnormals as the Pallas kernels' casts do (numpy's and
    XLA's astype(float16), no flush to zero) and match them."""
    dtype = torch.float16
    (q, k, v, do), (jq, jk, jv, jdo) = _half(12, dtype,
                                             *[(1, 2, 128, 64)] * 4)
    q, jq = (q.float() * 6).to(dtype), (jq.astype(jnp.float32) * 6).astype(
        jnp.float16)
    s = (tfa._fold_scale(q, 0.125).float() @ k.float().transpose(-1, -2))
    s = s.masked_fill(~tfa._visible(128, 128, 0, 0, "cpu"), NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p[tfa._visible(128, 128, 0, 0, "cpu").expand_as(p)]
    assert ((p > 0) & (p < 2.0 ** -14)).float().mean() > 0.5
    assert (p < 2.0 ** -25).any()
    ref = jfa._flash_fwd_pallas(jq, jk, jv, 0.125, True, BLOCK, BLOCK,
                                interpret=True)
    out, lse = tfa.flash_fwd_plain(q, k, v, 0.125, True)
    _hold_fwd(out, lse, *ref)
    joffs = jnp.asarray((0, 0), jnp.int32)
    jgrads = jfa._flash_bwd_offs_pallas(
        jq, jk, jv, joffs, jdo, jnp.zeros((1, 2, 128), jnp.float32), ref[0],
        ref[1], 0.125, True, BLOCK, BLOCK, interpret=True)
    grads = tfa.flash_bwd_offs_plain(
        q, k, v, torch.tensor((0, 0), dtype=torch.int32), do, None,
        torch.tensor(_np(ref[0])).to(dtype), torch.tensor(_np(ref[1])),
        0.125, True)
    for name, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == dtype and r.dtype == jnp.float16, name
        assert row_ulps(_t(g), _t(r), dtype) <= GATES[dtype][2], name


@pytest.mark.parametrize("dtype", [BF, F16], ids=_ids)
def test_autograd_functions_carry_bf16_on_the_cpu(dtype):
    """The Functions' CPU path: 16-bit in, 16-bit out and grads, float32
    lse, no launch counted; the grads are the plain backward's."""
    (q, k, v, do), _ = _half(4, dtype, *[(1, 2, 64, 32)] * 4)
    offs = torch.tensor([16, 0], dtype=torch.int32)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    counters = [n for n in dir(tfa) if n.startswith("launches")]
    before = [getattr(tfa, n) for n in counters]
    out, lse = tfa.flash_attention_with_lse(*ts, offs, None, True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    out.backward(do)
    ref_out, ref_lse = tfa.flash_fwd_offs_plain(q, k, v, offs, None, True)
    want = tfa.flash_bwd_offs_plain(q, k, v, offs, do, None, ref_out,
                                    ref_lse, None, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    for t, w in zip(ts, want):
        assert t.grad.dtype == dtype and torch.equal(t.grad, w)
    o2 = tfa._FlashAttention.apply(*ts, 0.125, True)
    assert o2.dtype == dtype
    assert before == [getattr(tfa, n) for n in counters]


def test_row_gate_holds_each_row_to_its_own_scale():
    """``row_ulps`` against the whole-tensor measure on a causal output at
    the training sequence length: the late rows average hundreds of
    values and sit far below the tensor's largest, so an error of 5% in
    them stays under BF16_ULPS of the whole tensor's scale and is many
    ulps of their own; rows that cancel to noise are held at the floor,
    and an all-zero reference must be met exactly."""
    from mxnet_tpu_torch.kernels.bf16_gate import ROW_FLOOR, tensor_ulps
    (q, k, v), _ = _half(11, torch.bfloat16, *[(1, 2, 512, 64)] * 3)
    out, _ = tfa.flash_fwd_plain(q, k, v, 1.0 / 8, True)
    late = out.clone()
    late[:, :, 256:] = (late[:, :, 256:].float() * 1.05).to(late.dtype)
    assert tensor_ulps(late, out) <= BF16_ULPS      # the old measure passes
    assert row_ulps(late, out) >= 3 * BF16_ULPS     # each row's own fails
    assert row_ulps(out, out) == 0.0
    # a row of rounding noise (1e-7 against a largest value of 1) is held
    # at ROW_FLOOR's ulp (2 ** -19), not its own
    ref = torch.ones(2, 64)
    ref[1] = 1e-7
    got = ref.clone()
    got[1] = -1e-7
    assert ROW_FLOOR == 2.0 ** -12
    assert row_ulps(got, ref) == pytest.approx(2e-7 / 2.0 ** -19)
    assert row_ulps(torch.zeros(3, 4), torch.zeros(3, 4)) == 0.0
    assert row_ulps(torch.full((3, 4), 1e-30), torch.zeros(3, 4)) == math.inf
