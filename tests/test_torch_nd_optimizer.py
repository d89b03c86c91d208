"""The port's optimizer update ops (``ops/optimizer_ops.py``, its 11
registrations) held against ``mxnet_tpu``'s on the CPU, and against
kernel #7's plain version.

- Each op in both packages on the same weight, gradient and states (a
  seed), with clipping, weight decay and rescaling: every output within
  1 ulp-scale (rtol 1e-6 / atol 1e-7: XLA may contract a multiply and
  an add into one FMA, torch's CPU kernels do not).
- ``mx.nd.sgd_mom_update(w, g, mom, out=w)`` writes the weight into
  ``w`` and the momentum into ``mom`` in place (MXNet's mutated
  inputs); the reference returns them.
- A loop of ``sgd_mom_update`` / ``sgd_update`` ops over a tree of
  leaves equals one ``fused_update_step`` (kernel #7's wrapper, its
  plain version on CPU tensors) bit for bit: the same operations in the
  same order.
- The symbolic operators of ``Symbol`` (``- * / **``, reversed and
  scalar forms, comparisons, unary minus), ``bind`` and ``eval`` give the
  reference's op names and values.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels.opt_update import fused_update_step
from torch_nd_parity import check_op, rand
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-6, 1e-7
W, G = rand(1, (4, 5)), rand(2, (4, 5), -3.0, 3.0)
POS = rand(3, (4, 5), 0.1, 1.0)
COMMON = {"lr": 0.05, "wd": 1e-3, "rescale_grad": 0.5, "clip_gradient": 1.0}

CASES = [
    ("sgd_update", [W, G], {}),
    ("sgd_mom_update", [W, G, rand(4, (4, 5))], {"momentum": 0.9}),
    ("mp_sgd_update", [W.astype(np.float16), G.astype(np.float16), W], {}),
    ("mp_sgd_mom_update", [W.astype(np.float16), G.astype(np.float16),
                           rand(4, (4, 5)), W], {"momentum": 0.9}),
    ("adam_update", [W, G, rand(5, (4, 5)), POS], {"beta1": 0.8}),
    ("rmsprop_update", [W, G, POS], {"clip_weights": 0.5}),
    ("rmspropalex_update", [W, G, POS + 1, rand(6, (4, 5), -0.1, 0.1),
                            rand(7, (4, 5))], {}),
    ("ftrl_update", [W, G, rand(8, (4, 5)), POS], {"lamda1": 0.02}),
    ("signsgd_update", [W, G], {}),
    ("signum_update", [W, G, rand(9, (4, 5))], {"momentum": 0.9,
                                                "wd_lh": 0.01}),
    ("_sparse_adagrad_update", [W, G, POS], {}),
]


@pytest.mark.parametrize("name,inputs,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_update_op_matches_the_reference(name, inputs, attrs):
    check_op(name, inputs, dict(COMMON, **attrs), rtol=RTOL, atol=ATOL)


def test_update_ops_write_their_states_in_place():
    ctx = tmx.cpu()
    w = tmx.nd.array(W, ctx=ctx)
    mom = tmx.nd.array(rand(4, (4, 5)), ctx=ctx)
    handle = w._data
    want = jmx.nd.sgd_mom_update(jmx.nd.array(W), jmx.nd.array(G),
                                 jmx.nd.array(rand(4, (4, 5))),
                                 momentum=0.9, **COMMON)
    out = tmx.nd.sgd_mom_update(w, tmx.nd.array(G, ctx=ctx), mom,
                                out=w, momentum=0.9, **COMMON)
    assert out is w and w._data is handle
    np.testing.assert_allclose(w.asnumpy(), want[0].asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(mom.asnumpy(), want[1].asnumpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_a_loop_of_update_ops_is_one_fused_update(momentum):
    rng = np.random.RandomState(10)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 2)}
    params = {k: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
              for k, s in shapes.items()}
    grads = {k: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for k, s in shapes.items()}
    moms = {k: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for k, s in shapes.items()}
    fused_p = {k: v.clone() for k, v in params.items()}
    state = {"mom": {k: v.clone() for k, v in moms.items()}} \
        if momentum else {}
    hp = {"lr": 0.03, "momentum": momentum}
    fused_update_step("sgd", hp, fused_p, state, grads, rescale=0.25,
                      clip=0.7, wd=1e-4)
    for k in shapes:
        w = tmx.nd.NDArray(params[k].clone())
        g = tmx.nd.NDArray(grads[k])
        kw = dict(lr=0.03, wd=1e-4, rescale_grad=0.25, clip_gradient=0.7)
        if momentum:
            m = tmx.nd.NDArray(moms[k].clone())
            tmx.nd.sgd_mom_update(w, g, m, out=w, momentum=momentum, **kw)
            assert torch.equal(m._data, state["mom"][k])
        else:
            tmx.nd.sgd_update(w, g, out=w, **kw)
        assert torch.equal(w._data, fused_p[k]), k


def _sym_values(mx):
    with mx.name.NameManager():
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        outs = [a - b, a * b, a / b, a ** b, 2 - a, 3 / b, -a,
                a == b, a != 1.0, a > b, a >= 0.5, a < b,
                a <= 0.5, (a * 2).reshape((-1,)), a.transpose(),
                a.sum(axis=1), mx.sym.pow(a, 2), mx.sym.pow(2, a)]
        group = mx.sym.Group(outs)
    arrays = {"a": mx.nd.array(POS, ctx=mx.cpu()),
              "b": mx.nd.array(POS[::-1] + 0.2, ctx=mx.cpu())}
    exe = group.bind(mx.cpu(), arrays, grad_req="null")
    vals = [o.asnumpy() for o in exe.forward()]
    evald = (a * b).eval(ctx=mx.cpu(), **arrays)[0].asnumpy()
    return group.tojson(), vals, evald


def test_symbol_operators_bind_and_eval_match_the_reference():
    tjson, tvals, tev = _sym_values(tmx)
    jjson, jvals, jev = _sym_values(jmx)
    import json
    tnodes = [(n["op"], n["name"]) for n in json.loads(tjson)["nodes"]]
    jnodes = [(n["op"], n["name"]) for n in json.loads(jjson)["nodes"]]
    assert tnodes == jnodes
    for t, j in zip(tvals + [tev], jvals + [jev]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
