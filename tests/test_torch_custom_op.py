"""The port's Python user ops (``mx.operator``) held against
``mxnet_tpu``'s on the CPU.

The op is the reference example's softmax loss layer
(``example/numpy-ops/custom_softmax.py``: forward and backward in numpy,
results handed back with ``self.assign(..., mx.nd.array(y))``), and a
``need_top_grad`` op that scales by a keyword of its prop and keeps a
count in an aux state. Each is registered in both packages under the
same name and runs on the same numpy inputs:

- imperatively: ``mx.nd.Custom`` under ``autograd.record()``, then
  ``backward`` with a random head gradient;
- in a ``Symbol`` bound by ``simple_bind``: ``forward(is_train=True)``,
  ``backward``, the aux state written back;
- in ``Module.fit`` of 2 steps (an MLP over the softmax op, one numpy
  params dict, ``kvstore`` ``local`` and ``tpu_sync``), the params after
  it.

Outputs and gradients within rtol 1e-5 / atol 1e-6, the params after
the fit within 1e-6 of each leaf's max abs (float32 matmuls in another
order). The callbacks receive host NDArrays in both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6


def _register(mx):
    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy()
            y[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("t_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Scale(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * self.scale)
            aux[0][:] = aux[0] + 1

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.scale)

    @mx.operator.register("t_scale")
    class ScaleProp(mx.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_auxiliary_states(self):
            return ["count"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [(1,)]

        def create_operator(self, ctx, shapes, dtypes):
            return Scale(self.scale)


_register(jmx)
_register(tmx)

X = np.random.RandomState(0).standard_normal((4, 5)).astype(np.float32)
LABEL = np.array([0, 3, 1, 4], np.float32)
COT = np.random.RandomState(1).standard_normal((4, 5)).astype(np.float32)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _imperative(mx):
    ctx = mx.cpu()
    x = mx.nd.array(X, ctx=ctx)
    label = mx.nd.array(LABEL, ctx=ctx)
    count = mx.nd.zeros((1,), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        s = mx.nd.Custom(x, count, op_type="t_scale", scale=2.5)
        y = mx.nd.Custom(s * 1.0, label, op_type="t_softmax")
    y.backward(mx.nd.array(COT, ctx=ctx))
    return [y.asnumpy(), x.grad.asnumpy(), count.asnumpy()]


def test_custom_op_runs_imperatively_as_the_reference():
    got, want = _imperative(tmx), _imperative(jmx)
    _close(got, want)
    assert got[2][0] == 1.0
    assert "t_softmax" in tmx.operator.get_all_registered_operators()


def _symbol(mx):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data, num_hidden=5, name="fc")
        s = mx.sym.Custom(fc, op_type="t_scale", scale=0.5, name="scale")
        return mx.sym.Custom(s, mx.sym.Variable("softmax_label"),
                             op_type="t_softmax", name="softmax")


def _executor(mx):
    sym = _symbol(mx)
    exe = sym.simple_bind(mx.cpu(), data=(4, 5), softmax_label=(4,),
                          scale_count=(1,))
    rng = np.random.RandomState(2)
    exe.arg_dict["data"][:] = X
    exe.arg_dict["softmax_label"][:] = LABEL
    exe.arg_dict["fc_weight"][:] = rng.standard_normal((5, 5)).astype(
        np.float32)
    exe.arg_dict["fc_bias"][:] = rng.standard_normal(5).astype(np.float32)
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    return [out] + [exe.grad_dict[n].asnumpy() for n in
                    ("data", "fc_weight", "fc_bias")] + \
        [exe.aux_dict["scale_count"].asnumpy()]


def test_custom_op_runs_in_an_executor_as_the_reference():
    assert _symbol(tmx).list_auxiliary_states() == ["scale_count"]
    assert _symbol(tmx).list_arguments() == _symbol(jmx).list_arguments()
    got, want = _executor(tmx), _executor(jmx)
    _close(got, want)


def _fit(mx, kvstore):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=8,
                                                    name="fc1"),
                              act_type="relu")
        fc2 = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
        sym = mx.sym.Custom(fc2, mx.sym.Variable("softmax_label"),
                            op_type="t_softmax", name="softmax")
    rng = np.random.RandomState(3)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    params = {"fc1_weight": rng.standard_normal((8, 6)) * 0.3,
              "fc1_bias": np.zeros(8), "fc2_weight":
              rng.standard_normal((4, 8)) * 0.3, "fc2_bias": np.zeros(4)}
    ctx = {} if mx is jmx else {"context": mx.cpu()}
    mod = mx.mod.Module(sym, label_names=("softmax_label",), **ctx)
    it = mx.io.NDArrayIter(x, y, batch_size=4, label_name="softmax_label")
    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v.astype(np.float32), ctx=mx.cpu())
                        for k, v in params.items()}, aux_params={})
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


@pytest.mark.parametrize("kvstore", ["local", "tpu_sync"])
def test_custom_op_trains_in_module_fit_as_the_reference(kvstore):
    got, want = _fit(tmx, kvstore), _fit(jmx, kvstore)
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= 1e-6, (k, err)
