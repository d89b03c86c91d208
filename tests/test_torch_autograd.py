"""The port's imperative runtime (``autograd``, ``imperative``, the
``NDArray`` methods) held against ``mxnet_tpu``'s on the CPU.

Each scenario is one function of the package (``mx``) run in both: the
same numpy inputs, the same calls, and the numpy results compared within
rtol 1e-5 / atol 1e-6 (float32 sums in another order), or bit for bit
where no arithmetic differs. The semantics held: recording and training
are separate flags; an op outside ``record()`` builds no graph, even on
an array with an attached gradient; ``pause()`` inside ``record()``;
``grad_req`` write, add and null; ``head_grads``; a second ``backward``
without ``retain_graph`` raises and with it runs; ``mark_variables``;
the gradient written in place into the buffer ``attach_grad`` made, so a
kept ``.grad`` handle reads it; ``autograd.grad`` (and its
``create_graph`` refusal); ``autograd.Function``; in-place operators and
``out=`` on arrays in the graph; assignment into a recorded array
raising; the NDArray arithmetic, comparisons, indexing by an NDArray and
shape methods.
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
X = np.random.RandomState(0).uniform(-1, 1, (3, 4)).astype(np.float32)
W = np.random.RandomState(1).uniform(-1, 1, (4, 2)).astype(np.float32)


def both(scenario):
    got = scenario(tmx, tmx.cpu())
    want = scenario(jmx, jmx.cpu())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (bool, str)) or w is None:
            assert g == w
            continue
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
        assert np.asarray(g).dtype == np.asarray(w).dtype
    return got


def test_recording_and_training_are_separate_flags():
    def scenario(mx, ctx):
        ag = mx.autograd
        out = [ag.is_recording(), ag.is_training()]
        with ag.record():
            out += [ag.is_recording(), ag.is_training()]
            with ag.pause():
                out += [ag.is_recording(), ag.is_training()]
                with ag.train_mode():
                    out += [ag.is_recording(), ag.is_training()]
            with ag.predict_mode():
                out += [ag.is_recording(), ag.is_training()]
        with ag.record(train_mode=False):
            out += [ag.is_recording(), ag.is_training()]
        out += [ag.is_recording(), ag.is_training()]
        return out
    both(scenario)


def test_backward_writes_into_the_attached_buffer_in_place():
    def scenario(mx, ctx):
        x = mx.nd.array(X, ctx=ctx)
        w = mx.nd.array(W, ctx=ctx)
        x.attach_grad()
        w.attach_grad()
        kept = w.grad
        with mx.autograd.record():
            y = mx.nd.dot(x, w)
            loss = (mx.nd.tanh(y) * y).sum()
        loss.backward()
        return [loss.asnumpy(), x.grad.asnumpy(), kept.asnumpy(),
                kept is w.grad]
    both(scenario)


def test_ops_outside_record_build_no_graph():
    def scenario(mx, ctx):
        x = mx.nd.array(X, ctx=ctx)
        x.attach_grad()
        y = x * 2                      # outside record: no graph
        with mx.autograd.record():
            z = (y * 3).sum()
        try:
            z.backward()
            raised = False
        except Exception as e:        # MXNetError in both packages
            raised = type(e).__name__
        return [raised]
    both(scenario)


def test_pause_inside_record_and_head_grads():
    def scenario(mx, ctx):
        x = mx.nd.array(X, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            with mx.autograd.pause():
                c = y * 5              # a constant of the graph
            z = y * c + x
        z.backward(mx.nd.array(W.sum(1, keepdims=True).repeat(4, 1)
                               [:3], ctx=ctx))
        return [z.asnumpy(), x.grad.asnumpy()]
    both(scenario)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    def scenario(mx, ctx):
        x = mx.nd.array(X, ctx=ctx)
        w = mx.nd.array(W, ctx=ctx)
        x.attach_grad(grad_req=req)
        w.attach_grad()
        for _ in range(2):
            with mx.autograd.record():
                loss = mx.nd.dot(x, w).sum()
            loss.backward()
        return [x.grad.asnumpy(), w.grad.asnumpy()]
    both(scenario)


def test_a_second_backward_needs_retain_graph():
    def scenario(mx, ctx):
        x = mx.nd.array(X, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.exp(x).sum()
        y.backward(retain_graph=True)
        first = x.grad.asnumpy()
        y.backward()
        try:
            y.backward()
            raised = None
        except Exception as e:
            raised = type(e).__name__
        return [first, x.grad.asnumpy(), raised]
    got = both(scenario)
    assert got[2] == "MXNetError"


def test_mark_variables_and_autograd_grad():
    def scenario(mx, ctx):
        x = mx.nd.array(X, ctx=ctx)
        buf = mx.nd.zeros(X.shape, ctx=ctx)
        mx.autograd.mark_variables([x], [buf], "write")
        with mx.autograd.record():
            y = (mx.nd.sigmoid(x) * x).sum()
        y.backward(retain_graph=True)
        g = mx.autograd.grad(y, x)
        try:
            mx.autograd.grad(y, x, create_graph=True)
            raised = None
        except Exception as e:
            raised = type(e).__name__
        return [buf.asnumpy(), g.asnumpy(), raised]
    both(scenario)


def test_function_is_differentiable():
    def scenario(mx, ctx):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        x = mx.nd.array(X, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = Sigmoid()(x)
            z = (y * 3).sum()
        z.backward()
        return [y.asnumpy(), x.grad.asnumpy()]
    both(scenario)


def test_inplace_and_out_on_arrays_in_the_graph():
    def scenario(mx, ctx):
        x = mx.nd.array(X, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
            y += x
            y *= y
            z = mx.nd.zeros(X.shape, ctx=ctx)
            mx.nd.elemwise_add(y, x, out=z)
            loss = z.sum()
        loss.backward()
        try:
            with mx.autograd.record():
                q = x * 2
                q[0] = 1.0
            raised = None
        except Exception as e:
            raised = type(e).__name__
        return [z.asnumpy(), x.grad.asnumpy(), raised]
    got = both(scenario)
    assert got[2] == "MXNetError"


def test_ndarray_methods_match_the_reference():
    def scenario(mx, ctx):
        a = mx.nd.array(X, ctx=ctx)
        b = mx.nd.array(X[::-1] + 0.5, ctx=ctx)
        idx = mx.nd.array(np.array([2, 0], np.int32), ctx=ctx)
        out = [a + b, a - 2, 2 - a, a * b, a / 3, 3 / b, a % 0.3,
               b % mx.nd.zeros(b.shape, ctx=ctx), 2.0 % b, abs(a) ** 1.5,
               2 ** a, -a, a == b, a != 0.25, a > b, a >= 0, a < b,
               a <= 0.1, a[idx], a[1:3], a[1], a.T, a.transpose((1, 0)),
               a.swapaxes(0, 1), a.expand_dims(1), a.reshape((0, 2, -1)),
               a.reshape(-3), a[:1].squeeze(), a[:1].broadcast_to((3, 4)),
               a.tile((2, 1)), a.repeat(2, axis=0), a.flip(1),
               a.slice_axis(1, 1, 3), a.sum(), a.mean(axis=1), a.max(0),
               a.argmax(axis=1), a.clip(-0.5, 0.5), a.norm(),
               a.astype("int32"), a.abs(), mx.nd.moveaxis(a, 0, 1),
               mx.nd.concatenate([a, b], axis=1),
               mx.nd.full((2, 2), 7, ctx=ctx),
               mx.nd.arange(1, 7, 2, ctx=ctx), mx.nd.maximum(a, 0.2),
               mx.nd.minimum(0.1, a), mx.nd.power(b, 2)]
        for p in a.split(2, axis=1):
            out.append(p)
        c = a.copy()
        c += 1
        c -= b
        c /= 2
        c[0, 1] = 9.0
        c[idx] = 4.0
        out += [c, a.asscalar() if a.size == 1 else a[0, 0].asscalar(),
                a.as_in_context(ctx), a.detach()]
        return [o.asnumpy() if hasattr(o, "asnumpy") else np.float32(o)
                for o in out]
    both(scenario)
