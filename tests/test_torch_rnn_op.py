"""The port's fused ``RNN`` op held against ``mxnet_tpu``'s on the CPU.

- Every mode (``rnn_relu``, ``rnn_tanh``, ``lstm``, ``gru``), one and two
  directions, with and without ``state_outputs``, at 2 layers: the
  outputs and the gradients into ``data``, ``parameters``, ``state`` and
  ``state_cell`` (one random cotangent on every output) of the plain loop
  and of the ``torch._VF`` route (torch's own RNN on the CPU; cuDNN's on
  the card) against the reference's scan, rtol 1e-5 / atol 1e-6. The
  ``_VF`` route reads the reference's packed layout through views, so a
  fault in the views shows here.
- ``mx.nd.RNN`` and ``mx.sym.RNN`` (the shape hook infers ``parameters``
  and the states, as ``simple_bind`` needs) against the reference.
- Dropout between layers draws from the op's generator: the same seed the
  same bits on both routes, its masks keep 1 - p at 1 / (1 - p), and at
  inference ``p`` changes nothing. ``lstm_state_clip_*`` is accepted and
  ignored, as in the reference.
- A CUDA tensor takes the cuDNN route (``rnn_route``); nothing on the
  card falls back to the loop.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import nn as tnn
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
T, N, I, H, L = 5, 3, 4, 6, 2
MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")
CASES = list(itertools.product(MODES, (False, True), (False, True)))


def _inputs(mode, bi, seed=0):
    d = 2 if bi else 1
    n = tnn.rnn_param_size(mode, I, H, L, bi)
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(T, N, I).astype(np.float32),
              (rng.randn(n) * 0.4).astype(np.float32),
              rng.randn(L * d, N, H).astype(np.float32)]
    if mode == "lstm":
        arrays.append(rng.randn(L * d, N, H).astype(np.float32))
    return arrays


def _attrs(mode, bi, so, **kw):
    return dict(state_size=H, num_layers=L, bidirectional=bi, mode=mode,
                state_outputs=so, **kw)


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


@pytest.fixture(scope="module")
def reference():
    """The reference's outputs and input gradients of every case: each
    (mode, directions) runs forward once with ``state_outputs``, and its
    vjp is taken with a cotangent on every output and with one on the
    sequence output alone (the case without ``state_outputs``), both in
    one jitted program."""
    out = {}
    for mode, bi in itertools.product(MODES, (False, True)):
        params = jnn.RNNParam(**_attrs(mode, bi, True))
        d = 2 if bi else 1
        shapes = [(T, N, H * d)] + [(L * d, N, H)] * (
            2 if mode == "lstm" else 1)
        ct = _cotangents([np.empty(sh) for sh in shapes])
        cots = tuple(np.stack([c, c if k == 0 else np.zeros_like(c)])
                     for k, c in enumerate(ct))

        def run(xs, cots, params=params):
            outs, vjp = jax.vjp(lambda *a: jnn._rnn(params, *a), *xs)
            return outs, jax.vmap(vjp)(cots)
        outs, grads = jax.jit(run)(_inputs(mode, bi), cots)
        outs = [np.asarray(o) for o in outs]
        out[(mode, bi, True)] = (outs, [np.asarray(g[0]) for g in grads])
        out[(mode, bi, False)] = (outs[:1], [np.asarray(g[1])
                                            for g in grads])
    return out


def _port(mode, bi, so, route, **kw):
    arrays = [torch.tensor(a, requires_grad=True) for a in _inputs(mode, bi)]
    out = tnn.rnn_forward(tnn.RNNParam(**_attrs(mode, bi, so, **kw)),
                          *arrays, route=route)
    outs = list(out) if isinstance(out, tuple) else [out]
    cots = _cotangents([o.detach().numpy() for o in outs])
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [o.detach().numpy() for o in outs], [a.grad.numpy()
                                               for a in arrays]


@pytest.mark.parametrize("route", ("plain", "cudnn"))
@pytest.mark.parametrize("mode,bi,so", CASES)
def test_rnn_matches_the_reference_scan(reference, mode, bi, so, route):
    want_out, want_grad = reference[(mode, bi, so)]
    got_out, got_grad = _port(mode, bi, so, route)
    assert len(got_out) == len(want_out)
    for g, w in zip(got_out + got_grad, want_out + want_grad):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_state_clip_is_accepted_and_ignored_as_in_the_reference(reference):
    want_out, want_grad = reference[("lstm", False, True)]
    got_out, got_grad = _port("lstm", False, True, "plain",
                              lstm_state_clip_min=-0.01,
                              lstm_state_clip_max=0.01)
    for g, w in zip(got_out + got_grad, want_out + want_grad):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ("lstm", "gru"))
def test_nd_and_sym_rnn_match_the_reference(reference, mode):
    """``mx.nd.RNN`` under ``record`` (the registry's path) against the
    reference's op, and ``mx.sym.RNN``'s inferred shapes against the
    reference's."""
    want_out, want_grad = reference[(mode, True, True)]
    attrs = _attrs(mode, True, True)
    nds = [tmx.nd.array(a, ctx=tmx.cpu()) for a in _inputs(mode, True)]
    for a in nds:
        a.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.RNN(*nds, **attrs)
    tmx.autograd.backward(list(out), [
        tmx.nd.array(c, ctx=tmx.cpu())
        for c in _cotangents([o.asnumpy() for o in out])])
    got = [o.asnumpy() for o in out] + [a.grad.asnumpy() for a in nds]
    for g, w in zip(got, want_out + want_grad):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the shape hook: simple_bind infers the packed parameters and states
    shapes = []
    for mx in (jmx, tmx):
        sym = mx.sym.RNN(mx.sym.Variable("data"), name="rnn", **attrs)
        args, outs, _ = sym.infer_shape(data=(T, N, I))
        shapes.append((sym.list_arguments(), args, outs))
    assert shapes[0] == shapes[1]
    exe = sym.simple_bind(tmx.cpu(), data=(T, N, I))
    assert exe.arg_dict["rnn_parameters"].shape == (
        tnn.rnn_param_size(mode, I, H, L, True),)


def _dropout_run(route, seed, is_train=True, p=0.5):
    arrays = [torch.from_numpy(a) for a in _inputs("lstm", True)]
    gen = torch.Generator().manual_seed(seed)
    out = tnn.rnn_forward(tnn.RNNParam(**_attrs("lstm", True, True, p=p)),
                          *arrays, is_train=is_train, rng=gen, route=route)
    return [o.numpy() for o in out]


def test_dropout_draws_from_the_op_generator():
    a = _dropout_run("plain", 7)
    for again in (_dropout_run("plain", 7), _dropout_run("cudnn", 7)):
        for x, y in zip(a, again):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    other = _dropout_run("plain", 8)
    assert not np.allclose(a[0], other[0])
    no_drop = _dropout_run("plain", 7, p=0.0)
    assert not np.allclose(a[0], no_drop[0])
    # at inference p changes nothing, on both routes
    for route in ("plain", "cudnn"):
        for x, y in zip(_dropout_run(route, 7, is_train=False),
                        _dropout_run(route, 9, is_train=False, p=0.0)):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


def test_dropout_mask_keeps_one_minus_p_scaled(monkeypatch):
    """The mask between the layers, read where the op draws it: each lane
    kept with probability 1 - p and scaled by exactly 1 / (1 - p)."""
    seen = []
    dropout = tnn._dropout

    def watching(params, x, is_train=False, rng=None):
        out = dropout(params, x, is_train, rng)
        seen.append((x, out))
        return out
    monkeypatch.setattr(tnn, "_dropout", watching)
    p = 0.3
    params = tnn.RNNParam(state_size=40, num_layers=3, mode="rnn_tanh", p=p)
    data = torch.randn(50, 20, I, generator=torch.Generator().manual_seed(1))
    n = tnn.rnn_param_size("rnn_tanh", I, 40, 3, False)
    with torch.no_grad():
        tnn.rnn_forward(params, data, 0.2 * torch.ones(n),
                        torch.zeros(3, 20, 40), is_train=True,
                        rng=torch.Generator().manual_seed(0), route="plain")
    assert len(seen) == 2          # between the layers, not after the last
    for x, y in seen:
        kept = y != 0
        np.testing.assert_array_equal(y[kept].numpy(),
                                      (x[kept] / (1 - p)).numpy())
        se = np.sqrt(p * (1 - p) / y.numel())
        assert abs(kept.float().mean().item() - (1 - p)) < 5 * se


def test_a_cuda_tensor_takes_the_cudnn_route():
    assert tnn.rnn_route(torch.device("cuda", 0)) == "cudnn"
    assert tnn.rnn_route("cpu") == "plain"
    before = dict(tnn.RNN_COUNTS)
    _port("gru", False, False, None)
    assert tnn.RNN_COUNTS["plain"] == before["plain"] + 1
    assert tnn.RNN_COUNTS["cudnn"] == before["cudnn"]
