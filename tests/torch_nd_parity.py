"""The harness of the ``mx.nd`` op parity tests (``test_torch_nd_*.py``).

``run_op(mx, name, arrays, attrs, grad)`` calls ``mx.nd.<name>`` of one
package on the CPU: the inputs are ``arrays`` (numpy, each kept in its
dtype), those at the positions ``grad`` get ``attach_grad``, the call is
recorded, and the first output is seeded with a cotangent drawn from a
numpy seed; an op without tensor inputs gets ``ctx=cpu()``. It returns
(outputs as numpy, output dtypes, input gradients). ``check_op`` runs it
in ``mxnet_tpu`` and in the port and holds outputs, dtypes and gradients
to each other within ``rtol`` / ``atol``. The JAX package runs without
x64, so a 64-bit dtype of the port is held to its 32-bit dtype.
"""
import numpy as np

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx


def run_op(mx, name, arrays, attrs, grad=(), seed=0):
    ctx = mx.cpu()
    if not arrays:
        attrs = dict(attrs, ctx=ctx)
    nds = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
    for i in grad:
        nds[i].attach_grad()
    with mx.autograd.record():
        out = getattr(mx.nd, name)(*nds, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    grads = []
    if grad:
        head = outs[0]
        cot = np.random.RandomState(seed).standard_normal(
            head.shape).astype(head.dtype)
        mx.autograd.backward([head], [mx.nd.array(cot, ctx=ctx,
                                                  dtype=cot.dtype)])
        grads = [nds[i].grad.asnumpy() for i in grad]
    return [o.asnumpy() for o in outs], [o.dtype for o in outs], grads


def check_op(name, arrays, attrs=None, grad=(), rtol=1e-5, atol=1e-6,
             values=True):
    """The op in both packages: same output dtypes and shapes, and (with
    ``values``) outputs and gradients within ``rtol`` / ``atol``."""
    attrs = attrs or {}
    jo, jd, jg = run_op(jmx, name, arrays, attrs, grad)
    to, td, tg = run_op(tmx, name, arrays, attrs, grad)
    narrow = {np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.float64): np.dtype(np.float32)}
    assert [narrow.get(np.dtype(d), np.dtype(d)) for d in td] == \
        [np.dtype(d) for d in jd], (name, td, jd)
    assert [o.shape for o in to] == [o.shape for o in jo], name
    if values:
        for t, j in zip(to, jo):
            np.testing.assert_allclose(t, j, rtol=rtol, atol=atol,
                                       err_msg=name)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol,
                                   err_msg=name + " grad")
    return to, jo


def rand(seed, shape, lo=-1.0, hi=1.0, dtype=np.float32):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(dtype)
