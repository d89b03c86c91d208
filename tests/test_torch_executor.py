"""The port's ``Executor`` outputs held against the JAX package's.

MXNet's executors allocate their outputs at bind and write each forward
into them, so an output array held across forwards reads the latest
forward (``mxnet_tpu/executor.py``: the ``outputs`` property and
``forward``; ``Module``'s executor group relies on it). The case:
``FullyConnected(num_hidden=3)`` bound with ``simple_bind(data=(2, 4))``,
weights of ones and a zero bias. Before the first forward ``outputs`` is
zeros of shape (2, 3); an array held after ``forward(data=ones)`` reads
4 everywhere, and 8 after ``forward(data=2 * ones)``. Exact: the values
are small integers in float32.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PACKAGES = {"reference": (jmx, jmx.cpu), "port": (tmx, tmx.cpu)}


def _fc(mx, ctx, grad_req):
    with mx.name.NameManager():
        sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                    name="fc")
    exe = sym.simple_bind(ctx, data=(2, 4), grad_req=grad_req)
    exe.arg_dict["fc_weight"][:] = np.ones((3, 4), np.float32)
    exe.arg_dict["fc_bias"][:] = np.zeros(3, np.float32)
    return exe


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_outputs_are_bound_and_written_in_place(package):
    mx, cpu = PACKAGES[package]
    exe = _fc(mx, cpu(), "null")
    before = exe.outputs
    assert len(before) == 1
    np.testing.assert_array_equal(before[0].asnumpy(),
                                  np.zeros((2, 3), np.float32))
    held = exe.forward(data=np.ones((2, 4), np.float32))[0]
    assert held is before[0]
    np.testing.assert_array_equal(held.asnumpy(), np.full((2, 3), 4.0))
    exe.forward(data=2 * np.ones((2, 4), np.float32))
    np.testing.assert_array_equal(held.asnumpy(), np.full((2, 3), 8.0))
    assert exe.outputs[0] is held


def test_train_forward_keeps_outputs_and_gradients():
    """A train-mode forward writes the held outputs too, and backward's
    gradients (taken from the forward's own autograd outputs) equal the
    reference's."""
    data = np.arange(8, dtype=np.float32).reshape(2, 4) / 8
    head = np.arange(6, dtype=np.float32).reshape(2, 3) - 2
    got = {}
    for name, (mx, cpu) in PACKAGES.items():
        exe = _fc(mx, cpu(), "write")
        held = exe.outputs[0]
        exe.forward(is_train=True, data=data)
        exe.backward(out_grads=mx.nd.array(head, ctx=cpu()))
        got[name] = (held.asnumpy(), exe.outputs[0] is held,
                     {k: g.asnumpy() for k, g in exe.grad_dict.items()})
    ref, port = got["reference"], got["port"]
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] and ref[1]
    assert sorted(port[2]) == sorted(ref[2])
    for k in ref[2]:
        np.testing.assert_allclose(port[2][k], ref[2][k], rtol=1e-6,
                                   atol=1e-6)
