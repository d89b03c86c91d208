"""The fork's own four ops in the port held against ``mxnet_tpu``'s on the
CPU: ``LSoftmax``, ``MultiLogistic``, ``WeightedL1`` and
``Correlation1D`` (``mxnet_tpu_torch/ops/fork_ops.py``).

Each case runs through the reference op (one jitted program for the
file) and the port's ``mx.nd`` op on the same seeded numpy inputs:
outputs and the gradients of the first output agree within rtol 1e-5 /
atol 1e-6 (LSoftmax's margin logit, a polynomial of a cosine times two
norms, within rtol 2e-5).

- LSoftmax in inference, where the op is the plain product, against the
  reference; its shape hook names the weight. In training the reference
  raises (it compares the (N,) cosines against a (1, m) table; ROADMAP
  §C), so the port's margin logit (margins 2, 3 and 4, with beta) is held
  to a float64 numpy transcription of lsoftmax.cu's forward with
  ``cos(m t)`` in closed form (rtol 2e-5), and its gradient to finite
  differences in float64 (``torch.autograd.gradcheck``).
- MultiLogistic's and WeightedL1's hand-written backwards under a
  constant cotangent of 2^10, a supervised step's loss-scale seed: the
  gradient is the reference's times the seed, as for every loss head.
- Correlation1D two-sided, one-sided both ways, with a kernel of 3.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_op_parity import case, check, rand, reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

X = rand(0, (6, 5))
W = rand(1, (4, 5))
Y = np.array([0, 3, 1, 2, 3, 0], np.float32)
LOGITS = rand(2, (4, 6), -3.0, 3.0)
TARGETS = (rand(3, (4, 6)) > 0).astype(np.float32)
REG = rand(4, (4, 6))
REG_LABEL = np.where(rand(5, (4, 6)) > 0.3, rand(6, (4, 6)), 0.0).astype(
    np.float32)
LEFT, RIGHT = rand(7, (2, 3, 4, 9)), rand(8, (2, 3, 4, 9))
SCALE = 2.0 ** 10

CASES = [
    case("lsoftmax_inference", "LSoftmax", [X, W, Y],
         {"num_hidden": 4, "margin": 3}, grad=(0, 1), train=False),
    case("multi_logistic", "MultiLogistic", [LOGITS, TARGETS],
         {"weight": 3.0, "grad_scale": 0.5}, grad=(0,)),
    case("multi_logistic_loss_scale", "MultiLogistic", [LOGITS, TARGETS],
         {"weight": 3.0}, grad=(0,), cot_scale=SCALE),
    case("weighted_l1", "WeightedL1", [REG, REG_LABEL],
         {"grad_scale": 2.0}, grad=(0,)),
    case("weighted_l1_loss_scale", "WeightedL1", [REG, REG_LABEL], {},
         grad=(0,), cot_scale=SCALE),
    case("correlation1d", "Correlation1D", [LEFT, RIGHT],
         {"max_displacement": 2, "pad_size": 2}, grad=(0, 1)),
    case("correlation1d_left_k3", "Correlation1D", [LEFT, RIGHT],
         {"max_displacement": 3, "pad_size": 1, "kernel_size": 3,
          "single_side": -1}, grad=(0, 1)),
    case("correlation1d_right_stride2", "Correlation1D", [LEFT, RIGHT],
         {"max_displacement": 4, "stride2": 2, "single_side": 1},
         grad=(0, 1)),
]
BY_ID = {c.id: c for c in CASES}


@pytest.fixture(scope="module")
def want():
    return reference(CASES)


@pytest.mark.parametrize("cid", [c.id for c in CASES])
def test_fork_op_matches_the_reference(want, cid):
    check(BY_ID[cid], want[cid])


def _lsoftmax_numpy(x, w, y, m, beta):
    """lsoftmax.cu's forward in float64: the label logit becomes
    ((-1)^k cos(m t) - 2k) |x| |w_y| blended with beta, k the cosine's
    sector."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    out = x @ w.T
    xn = np.sqrt((x * x).sum(1) + 1e-12)
    wn = np.sqrt((w * w).sum(1) + 1e-12)
    for i, yi in enumerate(y.astype(int)):
        fo = out[i, yi]
        cos_t = np.clip(fo / (xn[i] * wn[yi]), -1.0, 1.0)
        k = sum(cos_t < np.cos(j * np.pi / m) for j in range(1, m + 1))
        psi = (-1.0) ** k * np.cos(m * np.arccos(cos_t)) - 2.0 * k
        out[i, yi] = (psi * xn[i] * wn[yi] + beta * fo) / (1.0 + beta)
    return out


@pytest.mark.parametrize("margin,beta", [(2, 0.5), (3, 0.0), (4, 2.0)])
def test_lsoftmax_in_training(margin, beta):
    attrs = {"num_hidden": 4, "margin": margin, "beta": beta}
    nds = [tmx.nd.array(a, ctx=tmx.cpu()) for a in (X, W, Y)]
    with tmx.autograd.record(train_mode=True):
        out, xn, wn = tmx.nd.LSoftmax(*nds, **attrs)
    want = _lsoftmax_numpy(X, W, Y, margin, beta)
    np.testing.assert_allclose(out.asnumpy(), want, rtol=2e-5, atol=1e-6)
    with tmx.autograd.record(train_mode=False):
        plain = tmx.nd.LSoftmax(*nds, **attrs)[0].asnumpy()
    moved = out.asnumpy() != plain
    assert moved.sum() == len(Y) and (np.argwhere(moved)[:, 1] == Y).all()
    from mxnet_tpu_torch.ops.fork_ops import LSoftmaxParam, _lsoftmax
    params = LSoftmaxParam(**attrs)
    x64, w64 = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                for a in (X, W))
    assert torch.autograd.gradcheck(
        lambda a, b: _lsoftmax(params, a, b, torch.tensor(Y),
                               is_train=True)[0], (x64, w64))


def test_the_reference_lsoftmax_raises_in_training():
    """ROADMAP §C: mxnet_tpu's training path broadcasts (N,) against
    (1, m)."""
    import jax
    from mxnet_tpu.ops.fork_ops import LSoftmaxParam, _lsoftmax
    with pytest.raises((TypeError, ValueError), match="broadcast"):
        jax.eval_shape(lambda x, w, y: _lsoftmax(
            LSoftmaxParam(num_hidden=4, margin=3), x, w, y, is_train=True),
            X, W, Y)


def test_loss_heads_take_the_seed_multiplicatively(want):
    """Under the constant seed the gradient is the seed times the
    gradient under ones."""
    ones = tmx.nd.array(np.ones_like(LOGITS), ctx=tmx.cpu())
    x = tmx.nd.array(LOGITS, ctx=tmx.cpu())
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.MultiLogistic(x, tmx.nd.array(TARGETS, ctx=tmx.cpu()),
                                 weight=3.0)
    y.backward(ones)
    np.testing.assert_allclose(
        want["multi_logistic_loss_scale"][1][0], SCALE * x.grad.asnumpy(),
        rtol=1e-6)


def test_lsoftmax_symbol_infers_its_weight():
    sym = tmx.sym.LSoftmax(tmx.sym.Variable("data"),
                           label=tmx.sym.Variable("label"), num_hidden=10,
                           margin=2, name="ls")
    assert sym.list_arguments() == ["data", "ls_weight", "label"]
    args, outs, _ = sym.infer_shape(data=(8, 12), label=(8,))
    assert args[1] == (10, 12) and outs[0] == (8, 10)
