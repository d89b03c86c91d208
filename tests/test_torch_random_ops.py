"""The port's sampling ops and stochastic graphs on the CPU.

torch's generators never draw jax's numbers, so the random ops are held
by their moments and by reproducibility, and the stochastic graphs bit
for bit where they draw nothing:

- Each of the 15 registrations of ``ops/random_ops.py`` through
  ``mx.nd``: its output dtype and shape as the reference's (float32 by
  default; ``_sample_multinomial``'s int32 against the reference), and its
  sample mean (and, for the continuous ones, variance) within 5 standard
  errors of the distribution's, from 20000 draws a case. ``shuffle`` is
  a permutation of its rows; ``_sample_multinomial`` with ``get_prob``
  returns the log-probability of its draws.
- ``mx.random.seed`` makes ``mx.nd.random.*``, ``mx.nd.Dropout`` and an
  ``Executor``'s Dropout draw the same numbers again.
- ``DataParallelTrainStep`` on an MLP with Dropout: at ``p=0`` bit for
  bit the step of the graph without it; at ``p=0.5`` the same
  ``numpy.random.seed`` gives the same params bit for bit, another seed
  other params; each step draws one ``numpy.random.randint`` as the
  reference's step does (the JAX step leaves numpy's RNG in the same
  state); and the fused and supervised steps keep it.
- A drawing node raises inside a CUDA-graph capture (faked here), and so
  does a Python ``Custom`` op: a replay would reuse the numbers.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel.tpu_step import DataParallelTrainStep as JaxStep

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.executor import GraphPlan, run_graph
from mxnet_tpu_torch.parallel import DataParallelTrainStep
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = tmx.cpu()
N = 20000


def _check_moments(x, mean, var=None):
    se = np.sqrt((var if var is not None else x.var()) / x.size)
    assert abs(x.mean() - mean) < 5 * se, (x.mean(), mean)
    if var is not None:
        # the variance of the sample variance of a normal-ish law
        assert abs(x.var() - var) < 5 * var * np.sqrt(2.0 / x.size) + \
            0.05 * var, (x.var(), var)


#: op, attrs, inputs (numpy), mean, variance (None: mean only)
SAMPLERS = [
    ("_random_uniform", {"low": -1.0, "high": 3.0}, [], 1.0, 16 / 12),
    ("_random_normal", {"loc": 0.5, "scale": 2.0}, [], 0.5, 4.0),
    ("_random_gamma", {"alpha": 2.0, "beta": 1.5}, [], 3.0, 4.5),
    ("_random_exponential", {"lam": 4.0}, [], 0.25, 1 / 16),
    ("_random_poisson", {"lam": 3.0}, [], 3.0, 3.0),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, [], 4.5, 11.25),
    ("_sample_uniform", {}, [np.full(N, 1.0), np.full(N, 2.0)], 1.5,
     1 / 12),
    ("_sample_normal", {}, [np.full(N, -1.0), np.full(N, 0.5)], -1.0,
     0.25),
    ("_sample_gamma", {}, [np.full(N, 3.0), np.full(N, 0.5)], 1.5, 0.75),
    ("_sample_exponential", {}, [np.full(N, 2.0)], 0.5, 0.25),
    ("_sample_poisson", {}, [np.full(N, 5.0)], 5.0, 5.0),
    ("_sample_negative_binomial", {}, [np.full(N, 2.0), np.full(N, 0.5)],
     2.0, 4.0),
    ("_sample_generalized_negative_binomial", {},
     [np.full(N, 2.0), np.full(N, 0.5)], 2.0, 4.0),
]


@pytest.mark.parametrize("name,attrs,inputs,mean,var", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_moments_and_dtype(name, attrs, inputs, mean, var):
    tmx.random.seed(11)
    arrays = [tmx.nd.array(a.astype(np.float32), ctx=CPU) for a in inputs]
    extra = {} if inputs else {"shape": (N,), "ctx": CPU}
    out = getattr(tmx.nd, name)(*arrays, **attrs, **extra)
    # the reference's dtype: each op's ``dtype`` attr, float32 by default
    assert out.dtype == np.float32 and out.shape == (N,)
    _check_moments(out.asnumpy().astype(np.float64), mean, var)


def test_multinomial_and_shuffle():
    tmx.random.seed(12)
    p = np.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], np.float32)
    s, lp = tmx.nd.random.multinomial(tmx.nd.array(p, ctx=CPU),
                                      shape=(N,), get_prob=True)
    js = jmx.nd.random.multinomial(jmx.nd.array(p), shape=(4,))
    assert s.dtype == js.dtype and s.shape == (2, N)
    draws = s.asnumpy()
    for row in range(2):
        freq = np.bincount(draws[row], minlength=3) / N
        assert np.abs(freq - p[row]).max() < 5 * np.sqrt(0.25 / N)
        np.testing.assert_allclose(lp.asnumpy()[row],
                                   np.log(p[row][draws[row]]), rtol=1e-5)
    x = tmx.nd.array(np.arange(40, dtype=np.float32).reshape(20, 2), ctx=CPU)
    y = tmx.nd.shuffle(x).asnumpy()
    assert sorted(y[:, 0].tolist()) == list(range(0, 40, 2))
    np.testing.assert_array_equal(y[:, 1], y[:, 0] + 1)


def test_seed_makes_the_draws_again():
    def draws():
        a = tmx.nd.random.uniform(shape=(5,), ctx=CPU).asnumpy()
        b = tmx.nd.random.normal(shape=(5,), ctx=CPU).asnumpy()
        with tmx.autograd.train_mode():
            d = tmx.nd.Dropout(tmx.nd.ones((64,), ctx=CPU)).asnumpy()
        sym = tmx.sym.Dropout(tmx.sym.Variable("x"), p=0.5)
        exe = sym.simple_bind(CPU, grad_req="null", x=(64,))
        exe.arg_dict["x"][:] = 1.0
        e = exe.forward(is_train=True)[0].asnumpy()
        p = exe.forward(is_train=False)[0].asnumpy()
        return a, b, d, e, p
    tmx.random.seed(5)
    first = draws()
    tmx.random.seed(5)
    second = draws()
    for x, y in zip(first, second):
        np.testing.assert_array_equal(x, y)
    assert (first[2] == 0).any() and (first[3] == 0).any()
    np.testing.assert_array_equal(first[4], np.ones(64, np.float32))


def _mlp(mx, p):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        h = mx.sym.Activation(mx.sym.FullyConnected(x, num_hidden=16,
                                                    name="fc1"),
                              act_type="relu")
        if p is not None:
            h = mx.sym.Dropout(h, p=p)
        out = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(out, name="softmax")


SHAPES = {"data": (8, 6), "softmax_label": (8,)}


def _params():
    rng = np.random.RandomState(4)
    return {"fc1_weight": rng.standard_normal((16, 6)) * 0.3,
            "fc1_bias": rng.standard_normal(16) * 0.1,
            "fc2_weight": rng.standard_normal((4, 16)) * 0.3,
            "fc2_bias": np.zeros(4)}


def _batches(n):
    rng = np.random.RandomState(5)
    return [{"data": rng.standard_normal((8, 6)).astype(np.float32),
             "softmax_label": rng.randint(0, 4, 8).astype(np.float32)}
            for _ in range(n)]


def _port_fit(p, np_seed, steps=3, **kw):
    step = DataParallelTrainStep(_mlp(tmx, p), lr=0.1, momentum=0.9,
                                 device="cpu", **kw)
    params = {k: v.astype(np.float32) for k, v in _params().items()}
    step.init_from(params, {}, SHAPES)
    np.random.seed(np_seed)
    for b in _batches(steps):
        step(b)
    return [step.params[k].detach().clone() for k in sorted(step.params)], \
        np.random.randint(0, 2 ** 31)


@pytest.mark.parametrize("kw", [{}, {"fused_optupdate": True},
                                {"supervise": True}])
def test_stochastic_train_step_is_reproducible_from_the_numpy_seed(kw):
    plain, _ = _port_fit(None, 0, **kw)
    zero, _ = _port_fit(0.0, 0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(plain, zero))
    a, after_a = _port_fit(0.5, 7, **kw)
    b, after_b = _port_fit(0.5, 7, **kw)
    c, _ = _port_fit(0.5, 8, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert after_a == after_b
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert not all(torch.equal(x, y) for x, y in zip(a, plain))


def test_train_step_draws_numpy_as_the_reference_step():
    """One ``randint`` a step: after 3 steps numpy's RNG is where the
    JAX step leaves it; a graph without Dropout draws nothing."""
    _, port_next = _port_fit(0.5, 21)
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jstep = JaxStep(_mlp(jmx, 0.5), mesh, lr=0.1, momentum=0.9)
    jstep.init_from({k: jmx.nd.array(v.astype(np.float32))
                     for k, v in _params().items()}, {}, SHAPES)
    np.random.seed(21)
    for b in _batches(3):
        jstep(b)
    assert port_next == np.random.randint(0, 2 ** 31)
    _, plain_next = _port_fit(None, 21)
    np.random.seed(21)
    assert plain_next == np.random.randint(0, 2 ** 31)


def test_drawing_nodes_and_custom_ops_refuse_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    sym = tmx.sym.Dropout(tmx.sym.Variable("x"), p=0.5)
    plan = GraphPlan(sym)
    x = {"x": torch.ones(4)}
    with pytest.raises(MXNetError, match="CUDA-graph capture"):
        run_graph(plan, x, {}, True, device=torch.device("cuda", 0))
    # predict mode draws nothing, so it may be captured
    run_graph(plan, x, {}, False, device=torch.device("cuda", 0))
    from mxnet_tpu_torch import operator

    class Same(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0])

    @operator.register("t_capture_same")
    class SameProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Same()

    with pytest.raises(MXNetError, match="CUDA-graph capture"):
        tmx.nd.Custom(tmx.nd.ones((2,), ctx=CPU), op_type="t_capture_same")


def test_module_fit_with_dropout_on_the_local_kvstore():
    """``Module`` with ``kvstore='local'`` runs the Dropout graph through
    its executors, drawing from ``mx.random``: one seed, the same params;
    ``p=0`` the graph without Dropout's."""
    def fit(p, seed):
        tmx.random.seed(seed)
        rng = np.random.RandomState(6)
        it = tmx.io.NDArrayIter(rng.standard_normal((16, 6)).astype(
            np.float32), rng.randint(0, 4, 16).astype(np.float32), 8)
        mod = tmx.mod.Module(_mlp(tmx, p), context=CPU)
        mod.fit(it, num_epoch=1, kvstore="local", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: tmx.nd.array(v.astype(np.float32), ctx=CPU)
                            for k, v in _params().items()}, aux_params={})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    a, b, c = fit(0.5, 1), fit(0.5, 1), fit(0.5, 2)
    zero, plain = fit(0.0, 1), fit(None, 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(zero[k], plain[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a)
