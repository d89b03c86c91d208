"""The reference's SSD training graph (``example/ssd``) through the port's
``Module.fit`` against ``mxnet_tpu``'s on the CPU.

The example's own files build the graph and its metric in each package
(``symbol/symbol_builder.py``'s ``get_symbol_train`` with
``common.multibox_layer``, ``train/metric.py``'s ``MultiBoxMetric``),
each loaded with ``mxnet_tpu`` bound to that package. The graph is a
narrow SSD: the VGG16-reduced backbone is replaced by three small conv
blocks (relu4_3 16 channels at 16x16, relu7 32 at 8x8), two scales with
``symbol_builder``'s first two sizes and ratios (1408 anchors), 3
classes plus background, the first scale L2-normalised with a scale
``Variable`` initialised by ``Constant(20)``. It keeps every piece
``get_symbol_train`` adds: ``MultiBoxTarget`` with hard-negative mining,
``SoftmaxOutput(multi_output, use_ignore, normalization="valid")``, a
smooth-L1 ``MakeLoss``, and the gradient-free ``cls_label`` and
``MultiBoxDetection`` heads (``MakeLoss(grad_scale=0)``).

Both packages start from the same numpy parameters and fit the
example's ``SyntheticDetIter`` batches (batch 4, 3x64x64, seed 0) for 3
steps of SGD with momentum (lr 0.004, momentum 0.9, wd 5e-4, the
example's settings), under ``kvstore="tpu_sync"`` (the fused step, #7's
wrapper on the port: its plain version on CPU tensors) and under
``"local"`` (the per-parameter updater), each held to the reference's
fused fit (its ``local`` path runs the same update; one reference fit
keeps the file's compile cost down). The final parameters agree within
rtol 1e-5 / atol 1e-6, each batch's two ``MultiBoxMetric`` values within
1e-5 relative, and the last step's detection output: ids equal, scores
and boxes within 1e-5.
"""
import contextlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD = os.path.join(REPO, "example", "ssd")
BATCH, SHAPE, CLASSES, STEPS = 4, (3, 64, 64), 3, 3
OPT = {"learning_rate": 0.004, "momentum": 0.9, "wd": 5e-4}
RTOL, ATOL = 1e-5, 1e-6


@contextlib.contextmanager
def _as_mxnet_tpu(mx):
    """``import mxnet_tpu`` (and ``mxnet_tpu.io``) resolve to ``mx``
    while the example's files load."""
    names = ("mxnet_tpu", "mxnet_tpu.io")
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update({"mxnet_tpu": mx, "mxnet_tpu.io": mx.io})
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _load(mx, tag):
    """The example's symbol package, metric and iterator modules, bound to
    ``mx``, under names of their own."""
    out = {}
    with _as_mxnet_tpu(mx):
        for key, path, pkg in (
                ("symbol", os.path.join(SSD, "symbol", "__init__.py"), True),
                ("metric", os.path.join(SSD, "train", "metric.py"), False),
                ("iterator", os.path.join(SSD, "dataset", "iterator.py"),
                 False)):
            name = "ssd_%s_%s" % (tag, key)
            spec = importlib.util.spec_from_file_location(
                name, path, submodule_search_locations=[os.path.dirname(
                    path)] if pkg else None)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            out[key] = mod
        for sub in ("symbol_builder", "vgg16_reduced", "common"):
            out[sub] = importlib.import_module("ssd_%s_symbol.%s" % (tag,
                                                                    sub))
    return out


def _small_backbone(mx):
    def get_symbol(num_classes=1000, **kwargs):
        body = mx.sym.Variable(name="data")
        taps = []
        for i, (filters, pool) in enumerate(((8, True), (16, True),
                                             (32, False))):
            if i == 2:
                body = mx.sym.Pooling(data=body, pool_type="max",
                                      kernel=(2, 2), stride=(2, 2),
                                      name="pool_b%d" % i)
            body = mx.sym.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                      num_filter=filters, name="conv_b%d" % i)
            body = mx.sym.Activation(data=body, act_type="relu",
                                     name="relu_b%d" % i)
            if pool:
                body = mx.sym.Pooling(data=body, pool_type="max",
                                      kernel=(2, 2), stride=(2, 2),
                                      name="pool_a%d" % i)
            taps.append(body)
        return taps[1], taps[2]
    return get_symbol


def narrow_ssd(mx, tag):
    """``get_symbol_train`` of the example over the small backbone, and
    the example's ``MultiBoxMetric`` class, both in ``mx``."""
    ex = _load(mx, tag)
    ex["vgg16_reduced"].get_symbol = _small_backbone(mx)
    sb = ex["symbol_builder"]
    with mx.name.NameManager():
        net = sb.get_symbol_train(
            CLASSES, num_filters=(16, 32), sizes=sb.DEFAULT_SIZES[:2],
            ratios=sb.DEFAULT_RATIOS[:2], normalization=(20, -1))
    return net, ex["metric"].MultiBoxMetric, ex["iterator"]


@pytest.fixture(scope="module")
def setting():
    """The graph in both packages, the example's synthetic batches and
    one set of numpy parameters."""
    jnet, jmetric, jiter = narrow_ssd(jmx, "ref")
    tnet, tmetric, _ = narrow_ssd(tmx, "port")
    assert tnet.tojson() == jnet.tojson()
    it = jiter.SyntheticDetIter(BATCH, data_shape=SHAPE,
                                num_classes=CLASSES, num_batches=STEPS,
                                seed=0)
    batches = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    shapes = {"data": (BATCH,) + SHAPE, "label": batches[0][1].shape}
    arg_shapes, _, aux_shapes = jnet.infer_shape(**shapes)
    assert not aux_shapes
    rng = np.random.RandomState(1)
    args = {}
    for name, shape in zip(jnet.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_scale"):
            args[name] = np.full(shape, 20.0, np.float32)
        elif name.endswith("_bias"):
            args[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            args[name] = rng.normal(0, (2.0 / fan_in) ** 0.5,
                                    shape).astype(np.float32)
    return {"nets": {jmx: jnet, tmx: tnet},
            "metrics": {jmx: jmetric, tmx: tmetric},
            "batches": batches, "args": args}


def _fit(mx, s, kvstore):
    """3 steps of ``Module.fit``: (params, each batch's metric values, the
    last training forward's detections, whether the fused step ran)."""
    data = np.concatenate([d for d, _ in s["batches"]])
    label = np.concatenate([lab for _, lab in s["batches"]])
    it = mx.io.NDArrayIter(data, label, BATCH, label_name="label")
    ctx = {} if mx is jmx else {"context": mx.cpu()}
    mod = mx.mod.Module(s["nets"][mx], label_names=("label",), **ctx)
    cpu = mx.cpu()
    values = []

    def batch_end(p):
        values.append(p.eval_metric.get()[1])

    mod.fit(it, eval_metric=s["metrics"][mx](), kvstore=kvstore,
            optimizer="sgd", optimizer_params=OPT,
            batch_end_callback=batch_end,
            arg_params={k: mx.nd.array(v, ctx=cpu)
                        for k, v in s["args"].items()},
            aux_params={}, num_epoch=1)
    fused = getattr(mod, "_fused_step", None) is not None
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return params, values, mod.get_outputs()[3].asnumpy(), fused


@pytest.fixture(scope="module")
def reference_fit(setting):
    """The reference's fit, once: its fused step (``tpu_sync``); its
    per-parameter ``local`` path runs the same update."""
    return _fit(jmx, setting, "tpu_sync")


@pytest.mark.parametrize("kvstore", ["tpu_sync", "local"])
def test_narrow_ssd_fit_matches_the_reference(setting, reference_fit,
                                              kvstore, monkeypatch):
    jparams, jvalues, jdet, jfused = reference_fit
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    tparams, tvalues, tdet, tfused = _fit(tmx, setting, kvstore)
    assert jfused and tfused == (kvstore == "tpu_sync")
    assert len(tvalues) == len(jvalues) == STEPS
    np.testing.assert_allclose(tvalues, jvalues, rtol=1e-5)
    assert sorted(tparams) == sorted(jparams)
    for k, want in jparams.items():
        np.testing.assert_allclose(tparams[k], want, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the fit moved every weight (the first scale's loc bias only by its
    # positives: its small anchors take none in these batches)
    still = [k for k in jparams
             if np.array_equal(jparams[k], setting["args"][k])]
    assert still == ["multibox_0_loc_pred_conv_bias"], still
    assert tdet.shape == (BATCH, 1408, 6)
    np.testing.assert_array_equal(tdet[..., 0], jdet[..., 0])
    np.testing.assert_allclose(tdet[..., 1:], jdet[..., 1:], rtol=1e-5,
                               atol=1e-5)
    assert (tdet[..., 0] >= 0).any() and (tdet[..., 0] == -1).any()
