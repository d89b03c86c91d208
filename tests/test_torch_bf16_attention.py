"""The plain bf16 versions of the stream attention kernels held against the
JAX package's Pallas kernels in interpret mode, on the same bf16 inputs.

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
  Function itself) carries bf16 through: bf16 out and grads, float32 lse.

Inputs: seeded numpy normals rounded to bf16 once, handed to both
packages. Shapes (1, 2, 128, D), 64-row blocks on the JAX side.
Tolerance: bf16 outputs within ``BF16_ULPS`` bf16 ulps of each row's
largest magnitude (``bf16_gate.row_ulps``): both round the same products,
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
from mxnet_tpu_torch.kernels.bf16_gate import BF16_ULPS, row_ulps

jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LSE_TOL = 1e-5
NEG = -1e30
BLOCK = 64


def _bf16(seed, *shapes):
    """Seeded normals rounded to bf16: (torch bf16 tensors, jnp bf16
    arrays) holding the same values."""
    rng = np.random.RandomState(seed)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(torch.bfloat16) for s in shapes]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                for t in ts]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.tensor(_np(x))


def _hold_fwd(out, lse, ref_out, ref_lse):
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert ref_out.dtype == jnp.bfloat16
    ref_lse = _np(ref_lse)
    dead = ref_lse == NEG
    assert (_np(lse)[dead] == NEG).all() and (_np(out)[dead] == 0).all()
    assert row_ulps(*map(_t, (out, ref_out))) <= BF16_ULPS
    live = ~dead
    np.testing.assert_allclose(_np(lse)[live], ref_lse[live], rtol=LSE_TOL,
                               atol=LSE_TOL)


@pytest.mark.parametrize("d,causal", [(64, True), (64, False), (128, True)])
def test_training_forward_plain_matches_pallas(d, causal):
    (q, k, v), (jq, jk, jv) = _bf16(0, *[(1, 2, 128, d)] * 3)
    sm = 1.0 / math.sqrt(d)
    ref = jfa._flash_fwd_pallas(jq, jk, jv, sm, causal, BLOCK, BLOCK,
                                interpret=True)
    _hold_fwd(*tfa.flash_fwd_plain(q, k, v, sm, causal), *ref)


@pytest.mark.parametrize("offs", [(0, 0), (64, 0), (0, 32)])
def test_offset_forward_plain_matches_pallas(offs):
    (q, k, v), (jq, jk, jv) = _bf16(1, (1, 2, 64, 64), (1, 2, 128, 64),
                                    (1, 2, 128, 64))
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


@pytest.mark.parametrize("d,offs", [(64, (0, 0)), (64, (32, 0)),
                                    (128, (0, 0))])
def test_backward_pair_plain_matches_pallas(d, offs):
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16(2, *[(1, 2, 128, d)] * 4)
    rng = np.random.RandomState(3)
    dlse = rng.standard_normal((1, 2, 128)).astype(np.float32)
    sm = 1.0 / math.sqrt(d)
    joffs = jnp.asarray(offs, jnp.int32)
    jout, jlse = jfa._flash_fwd_offs_pallas(jq, jk, jv, joffs, sm, True,
                                            BLOCK, BLOCK, interpret=True)
    ref = jfa._flash_bwd_offs_pallas(jq, jk, jv, joffs, jdo,
                                     jnp.asarray(dlse), jout, jlse, sm, True,
                                     BLOCK, BLOCK, interpret=True)
    out = torch.tensor(_np(jout)).to(torch.bfloat16)
    got = tfa.flash_bwd_offs_plain(
        q, k, v, torch.tensor(offs, dtype=torch.int32), do,
        torch.from_numpy(dlse), out, torch.tensor(_np(jlse)), sm, True)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, name
        assert row_ulps(_t(g), _t(r)) <= BF16_ULPS, name


@pytest.mark.parametrize("causal,block", [(True, 128), (True, 32),
                                          (False, 64)])
def test_grid_forward_plain_matches_pallas(causal, block):
    """#6 with one split (block 128) and with 4 or 2; at one split bit for
    bit the stream plain forward."""
    (q, k, v), (jq, jk, jv) = _bf16(5, *[(1, 2, 128, 64)] * 3)
    ref = jfa._flash_fwd_grid_pallas(jq, jk, jv, 0.125, causal, block, block,
                                     interpret=True)
    got = tfa.flash_fwd_grid_plain(q, k, v, 0.125, causal, block)
    _hold_fwd(*got, *ref)
    if block == 128:
        want = tfa.flash_fwd_plain(q, k, v, 0.125, causal)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("offs,block_k", [((0, 0), 128), ((64, 0), 32),
                                          ((0, 32), 64)])
def test_grid_offset_forward_plain_matches_pallas(offs, block_k):
    """#3 at the start, one chunk in with 4 key splits, and at an offset
    whose first rows see no key (2 splits, the second dead for them); at
    one split bit for bit the stream plain offset forward."""
    (q, k, v), (jq, jk, jv) = _bf16(6, (1, 2, 64, 64), (1, 2, 128, 64),
                                    (1, 2, 128, 64))
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


@pytest.mark.parametrize("offs,blocks", [((0, 0), (128, 128)),
                                         ((0, 0), (32, 64)),
                                         ((32, 0), (64, 32))])
def test_grid_backward_plain_matches_pallas(offs, blocks):
    """#4 with an lse cotangent from the JAX grid forward's out and lse,
    with one split on each axis and with several; at one split bit for
    bit the stream plain backward."""
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16(7, *[(1, 2, 128, 64)] * 4)
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
            torch.from_numpy(dlse), torch.tensor(_np(jout)).to(torch.bfloat16),
            torch.tensor(_np(jlse)), 0.125, True)
    got = tfa.flash_bwd_offs_grid_plain(*args, bq, bk)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, name
        assert row_ulps(_t(g), _t(r)) <= BF16_ULPS, name
    if blocks == (128, 128):
        want = tfa.flash_bwd_offs_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_autograd_functions_carry_bf16_on_the_cpu():
    """The Functions' CPU path: bf16 in, bf16 out and grads, float32 lse,
    no launch counted; the grads are the plain backward's."""
    (q, k, v, do), _ = _bf16(4, *[(1, 2, 64, 32)] * 4)
    offs = torch.tensor([16, 0], dtype=torch.int32)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (tfa.launches_bf16, tfa.launches_fwd_bf16,
              tfa.launches_bwd_dq_bf16, tfa.launches_bwd_dkv_bf16)
    out, lse = tfa.flash_attention_with_lse(*ts, offs, None, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    out.backward(do)
    ref_out, ref_lse = tfa.flash_fwd_offs_plain(q, k, v, offs, None, True)
    want = tfa.flash_bwd_offs_plain(q, k, v, offs, do, None, ref_out,
                                    ref_lse, None, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w)
    o2 = tfa._FlashAttention.apply(*ts, 0.125, True)
    assert o2.dtype == torch.bfloat16
    assert before == (tfa.launches_bf16, tfa.launches_fwd_bf16,
                      tfa.launches_bwd_dq_bf16, tfa.launches_bwd_dkv_bf16)


def test_row_gate_holds_each_row_to_its_own_scale():
    """``row_ulps`` against the whole-tensor measure on a causal output at
    the training sequence length: the late rows average hundreds of
    values and sit far below the tensor's largest, so an error of 5% in
    them stays under BF16_ULPS of the whole tensor's scale and is many
    ulps of their own; rows that cancel to noise are held at the floor,
    and an all-zero reference must be met exactly."""
    from mxnet_tpu_torch.kernels.bf16_gate import ROW_FLOOR, tensor_ulps
    (q, k, v), _ = _bf16(11, *[(1, 2, 512, 64)] * 3)
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
