"""The metrics this slice ports (``F1``, ``Perplexity``, ``MAE``, ``MSE``,
``RMSE``, ``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss``),
held against ``mxnet_tpu``'s on the CPU: the same numpy batches go
through both packages' metric (by class and by ``create`` name), twice
with a ``reset`` between, and ``get`` must agree within rtol 1e-6
(float64 host sums in both). ``Torch`` and ``Caffe`` stay unported.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-6


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _batches(kind, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        if kind == "binary":
            label = rng.randint(0, 2, 8).astype(np.float32)
            pred = _softmax(rng.randn(8, 2))
        elif kind == "class":
            label = rng.randint(0, 5, 6).astype(np.float32)
            pred = _softmax(rng.randn(6, 5))
        elif kind == "sequence":
            # (N, T) labels with padding 0 against (N*T, V) probabilities
            label = rng.randint(0, 5, (2, 4)).astype(np.float32)
            pred = _softmax(rng.randn(8, 5))
        elif kind == "regression":
            label = rng.randn(6).astype(np.float32)
            pred = (label + 0.3 * rng.randn(6)).astype(np.float32)
        else:   # a loss output
            label = np.zeros(4, np.float32)
            pred = rng.rand(4).astype(np.float32)
        out.append(([label], [pred]))
    return out


#: (name or class name, kwargs, batch kind)
METRICS = [
    ("F1", {}, "binary"), ("F1", {"average": "micro"}, "binary"),
    ("Perplexity", {"ignore_label": None}, "class"),
    ("Perplexity", {"ignore_label": 0}, "sequence"),
    ("MAE", {}, "regression"), ("MSE", {}, "regression"),
    ("RMSE", {}, "regression"),
    ("NegativeLogLikelihood", {}, "class"), ("nll_loss", {}, "class"),
    ("PearsonCorrelation", {}, "regression"), ("Loss", {}, "loss"),
    ("ce_loss", {}, "loss")]


def _run(mx, name, kwargs, kind):
    if hasattr(mx.metric, name):
        metric = getattr(mx.metric, name)(**kwargs)
    else:
        metric = mx.metric.create(name, **kwargs)
    values = []
    for _ in range(2):
        for labels, preds in _batches(kind):
            metric.update([mx.nd.array(a, ctx=mx.cpu()) for a in labels],
                          [mx.nd.array(a, ctx=mx.cpu()) for a in preds])
        values.append(metric.get())
        metric.reset()
    values.append(metric.get())
    return values


@pytest.mark.parametrize("name,kwargs,kind", METRICS,
                         ids=["%s-%d" % (m[0], i) for i, m in
                              enumerate(METRICS)])
def test_metric_matches_the_reference(name, kwargs, kind):
    got = _run(tmx, name, kwargs, kind)
    want = _run(jmx, name, kwargs, kind)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=RTOL)


def test_create_names_and_the_unported_plugins():
    for name in ("f1", "perplexity", "mae", "mse", "rmse", "nll_loss",
                 "pearsoncorrelation", "loss"):
        assert tmx.metric.create(name).name == jmx.metric.create(name).name
    # the plugin names, ported since: Loss under their own names
    for name in ("torch", "caffe"):
        assert tmx.metric.create(name).name == jmx.metric.create(name).name
        assert isinstance(tmx.metric.create(name), tmx.metric.Loss)
