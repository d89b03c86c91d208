"""The port's contrib ops held against ``mxnet_tpu``'s on the CPU:
``CTCLoss`` (and its aliases), ``_contrib_fft``, ``_contrib_ifft`` and
``_contrib_quadratic``.

- CTC: both blank conventions (``first``: blank 0, padding 0; ``last``:
  blank A-1, padding -1), with and without ``use_data_lengths`` /
  ``use_label_lengths``; each batch holds a sequence whose alignment
  cannot exist, whose loss is the reference's ~1e30 (its ``-1e30``
  sentinel) and not ``inf``, and whose gradient is the reference's too.
  The losses and the gradient into the activations, for one random
  cotangent, of the port's ``mx.nd.CTCLoss`` agree with the reference
  op's within rtol 1e-5 / atol 1e-6.
- fft interleaves re and im; ifft is unnormalised (x d); quadratic is
  a x^2 + b x + c, its gradient included.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import contrib_ops as jco

import mxnet_tpu_torch as tmx
from torch_nd_parity import check_op, rand
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
T, B, A = 6, 3, 5
ACTS = rand(0, (T, B, A))
#: the second sequence's two 3s need 3 steps; its data length is 2
LABELS = {"first": np.array([[1, 2, 0], [3, 3, 0], [1, 4, 1]], np.float32),
          "last": np.array([[1, 2, -1], [3, 3, -1], [0, 2, 0]], np.float32)}
DATA_LENS = np.array([6, 2, 5], np.float32)
LABEL_LENS = np.array([2, 2, 3], np.float32)


CTC_CASES = [(blank, lengths) for blank in ("first", "last")
             for lengths in (False, True)]


def _ctc_arrays(blank, lengths):
    return [ACTS, LABELS[blank]] + ([DATA_LENS, LABEL_LENS] if lengths
                                    else [])


def _ctc_attrs(blank, lengths):
    return {"blank_label": blank, "use_data_lengths": lengths,
            "use_label_lengths": lengths}


@pytest.fixture(scope="module")
def ctc_reference():
    """The reference op's losses and activation gradients of every case,
    from one jitted program (its ``mx.nd`` path would run the scan's
    primitives one by one)."""
    cot = np.random.RandomState(5).standard_normal(B).astype(np.float32)

    def all_cases(cases):
        res = []
        for (blank, lengths), arrays in zip(CTC_CASES, cases):
            params = jco.CTCLossParam(**_ctc_attrs(blank, lengths))
            loss, vjp = jax.vjp(
                lambda d: jco._ctc_loss(params, d, *arrays[1:]), arrays[0])
            res.append((loss, vjp(cot)[0]))
        return res
    res = jax.jit(all_cases)([_ctc_arrays(*c) for c in CTC_CASES])
    return cot, {c: (np.asarray(l), np.asarray(g))
                 for c, (l, g) in zip(CTC_CASES, res)}


@pytest.mark.parametrize("blank,lengths", CTC_CASES,
                         ids=["%s-%s" % (b, "lengths" if n else "padded")
                              for b, n in CTC_CASES])
def test_ctc_loss_matches_the_reference(ctc_reference, blank, lengths):
    cot, want = ctc_reference
    want_loss, want_grad = want[(blank, lengths)]
    nds = [tmx.nd.array(a, ctx=tmx.cpu()) for a in _ctc_arrays(blank,
                                                               lengths)]
    nds[0].attach_grad()
    with tmx.autograd.record():
        loss = tmx.nd.CTCLoss(*nds, **_ctc_attrs(blank, lengths))
    loss.backward(tmx.nd.array(cot, ctx=tmx.cpu()))
    got = loss.asnumpy()
    assert got.dtype == want_loss.dtype and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(nds[0].grad.asnumpy(), want_grad, rtol=RTOL,
                               atol=ATOL)
    if lengths:
        # the infeasible sequence: the sentinel, as the reference gives it
        assert got[1] == want_loss[1] == np.float32(1e30)


def test_ctc_aliases_and_symbol():
    nds = [tmx.nd.array(a, ctx=tmx.cpu()) for a in (ACTS, LABELS["first"])]
    base = tmx.nd.CTCLoss(*nds).asnumpy()
    for alias in ("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"):
        np.testing.assert_array_equal(getattr(tmx.nd, alias)(*nds).asnumpy(),
                                      base)
    sym = tmx.sym.ctc_loss(tmx.sym.Variable("data"),
                           tmx.sym.Variable("label"), name="ctc")
    assert sym.list_arguments() == ["data", "label"]
    _, outs, _ = sym.infer_shape(data=(T, B, A), label=(B, 3))
    assert outs == [(B,)]


@pytest.mark.parametrize("op,arrays,attrs,grad", [
    ("_contrib_fft", [rand(1, (3, 8))], {}, ()),
    ("_contrib_ifft", [rand(2, (3, 16))], {}, ()),
    ("_contrib_quadratic", [rand(3, (4, 5))], {"a": 0.5, "b": -2.0,
                                                "c": 3.0}, (0,)),
], ids=("fft", "ifft", "quadratic"))
def test_fft_ifft_quadratic_match_the_reference(op, arrays, attrs, grad):
    check_op(op, arrays, attrs, grad=grad, rtol=RTOL, atol=1e-5)


def test_ifft_undoes_fft_times_d():
    x = rand(4, (2, 8))
    y = tmx.nd._contrib_ifft(tmx.nd._contrib_fft(tmx.nd.array(
        x, ctx=tmx.cpu()))).asnumpy()
    np.testing.assert_allclose(y, 8 * x, rtol=1e-5, atol=1e-5)
