"""The port's Module slice held against the JAX package on the CPU.

Every input is made from a numpy seed and goes through both packages.

- Executor: ``arg_arrays``/``grad_arrays``/``aux_arrays``,
  ``output_dict``, ``copy_params_from`` and ``reshape`` (arrays of an
  unchanged shape shared with the new executor). Symbol: composition by
  call, ``get_internals``, indexing, ``list_inputs`` and ``infer_type``
  (the symbol JSON of a composed graph equal byte for byte). NDArray:
  assignment and reading at an int, a slice and a numpy index. Outputs
  within float32's 2e-4 relative / 2e-4 absolute (the op tests'
  tolerance); names, shapes, dtypes and assignments identical.
- ``NDArrayIter``: batches, pads and indices for pad, discard and
  roll_over, with and without a seeded shuffle, identical.
- ``FactorScheduler``/``MultiFactorScheduler``: identical values.
- ``SGD``, SGD with momentum and ``Adam`` through ``Updater`` (clip, wd,
  rescale, an lr schedule, an ``__lr_mult__`` attribute): within 1 ulp
  of the reference after each of 3 updates (XLA may contract a multiply
  and an add into one FMA; torch's CPU kernels do not).
- ``Accuracy``, ``TopKAccuracy`` and ``CrossEntropy``, host updates and
  device updates: within 1e-6.
- ``Initializer`` routing and the ``Zero``/``One``/``Constant`` values
  identical; ``Xavier``'s shape and scale (torch's values, not jax's).
- ``save_checkpoint``: the symbol JSON and ``.params`` files byte for
  byte.
- ``Module.fit`` of the MLP and of LeNet, both packages from one
  ``.params`` file, ``kvstore`` ``local`` (the per-param updater through
  the store) and ``tpu_sync`` (the fused step; the port's with
  ``MXNET_TPU_FUSED_OPTUPDATE=1``, so kernel #7's wrapper, on CPU tensors
  its plain version) x SGD-momentum and Adam, 2 epochs: every batch's
  running accuracy and the validation accuracy identical, the running
  and validation cross-entropy within 1e-4 relative (observed 1.8e-5:
  sums of logs of float32 probabilities). The final params and aux
  states are held by |port - reference| divided by the leaf's own max
  abs: SGD within 1e-6, and 99% of every leaf's elements within 1e-6
  (observed 2.5e-7 and 2.4e-7); Adam on the MLP within 1e-4, 99% within
  1e-5 (observed 8.5e-6 and 1.2e-7). Adam on LeNet is held to 2e-3, 99%
  within 5e-5 (observed 8.4e-4 and 1.1e-5): at a few of conv2_weight's
  25000 elements, whose gradient is near zero, Adam's m / sqrt(v) turns
  a float32 difference of the convolution's backward (another summation
  order than XLA's) into a part of a step. The per-parameter update
  itself is held to 1 ulp above.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = ATOL = 2e-4
# Module.fit's final params: (max, 99th percentile) of |port - reference|
# over the leaf's own max abs; observed in the module docstring
PARAM_TOL = {"sgd": (1e-6, 1e-6), "adam": (1e-4, 1e-5)}
ADAM_CONV_TOL = (2e-3, 5e-5)
CE_RTOL = 1e-4
TINY = np.finfo(np.float32).tiny    # a leaf that is all zeros
CPU = tmx.cpu()


def _both(build):
    with jmx.name.NameManager():
        js = build(jmx)
    with tmx.name.NameManager():
        ts = build(tmx)
    return js, ts


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


# ------------------------------------------------------ Executor, Symbol ----

def _fc_tanh(mx):
    fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                               name="fc")
    return mx.sym.Activation(fc, act_type="tanh", name="act")


def test_executor_members_and_reshape_match_reference():
    rng = np.random.RandomState(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    js, ts = _both(_fc_tanh)
    results = []
    for mx, sym, ctx in ((jmx, js, jmx.cpu()), (tmx, ts, CPU)):
        exe = sym.simple_bind(ctx, data=(2, 4))
        assert [a.shape for a in exe.arg_arrays] == [(2, 4), (3, 4), (3,)]
        assert [g is None for g in exe.grad_arrays] == [False] * 3
        assert exe.aux_arrays == []
        exe.copy_params_from({"fc_weight": mx.nd.array(w, ctx=mx.cpu()),
                              "fc_bias": mx.nd.array(b, ctx=mx.cpu())})
        with pytest.raises(MXNetError if mx is tmx else Exception):
            exe.copy_params_from({"nope": mx.nd.array(b, ctx=mx.cpu())})
        exe.copy_params_from({"nope": mx.nd.array(b, ctx=mx.cpu())},
                             allow_extra_params=True)
        big = exe.reshape(data=(5, 4))
        assert big.arg_dict["fc_weight"] is exe.arg_dict["fc_weight"]
        assert big.arg_dict["data"] is not exe.arg_dict["data"]
        out = big.forward(is_train=False, data=mx.nd.array(x, ctx=mx.cpu()))[0]
        assert sorted(big.output_dict) == ["act_output"]
        results.append((out.asnumpy(), exe.outputs[0].shape))
    (want, want_shape), (got, got_shape) = results
    assert got_shape == want_shape == (2, 3)
    np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_symbol_compose_internals_and_indexing_match_reference():
    def build(mx):
        head = mx.sym.FullyConnected(mx.sym.Variable("x"), num_hidden=4,
                                     name="head")
        body = _fc_tanh(mx)
        return body(data=head, name="composed"), body, head

    (jc, jbody, jhead), (tc, tbody, thead) = _both(build)
    assert tc.tojson() == jc.tojson()
    assert tc.list_arguments() == jc.list_arguments()
    assert tc.list_inputs() == jc.list_inputs()
    # the original graphs are unchanged
    assert tbody.list_arguments() == jbody.list_arguments()
    ti, ji = tc.get_internals(), jc.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    for key in ("head_output", "fc_output", "x", 1, slice(1, 3)):
        assert ti[key].list_outputs() == ji[key].list_outputs()
    assert len(ti) == len(ji)
    assert [s.name for s in ti] == [s.name for s in ji]
    pos = tbody(thead)   # positional: the first free variable
    assert pos.list_arguments() == jbody(jhead).list_arguments()
    with pytest.raises(MXNetError):
        tc["nope"]


@pytest.mark.parametrize("dtype", [None, "float16"])
def test_infer_type_matches_reference(dtype):
    def build(mx):
        data = mx.sym.Variable("data")
        bn = mx.sym.BatchNorm(data, name="bn")
        return mx.models.lenet.get_symbol(num_classes=10)(data=bn)

    js, ts = _both(build)
    kw = {} if dtype is None else {"data": dtype}
    got = ts.infer_type(**kw)
    want = js.infer_type(**kw)
    assert got == want
    assert ts.infer_type(*([dtype] if dtype else [])) == want


def test_ndarray_indexing_matches_reference():
    rng = np.random.RandomState(1)
    base = rng.normal(size=(6, 3)).astype(np.float32)
    sel = np.array([4, 0, 2])
    outs = []
    for mx in (jmx, tmx):
        a = mx.nd.array(base, ctx=mx.cpu())
        a[1] = 2.0
        a[2:4] = np.ones((2, 3), np.float32) * 3
        a[np.array([5])] = mx.nd.array(-np.ones((1, 3), np.float32),
                                      ctx=mx.cpu())
        got = [a.asnumpy(), a[sel].asnumpy(), a[1:3].asnumpy(),
               a[0].asnumpy(), (a * 2 - 1).asnumpy(),
               (1 - a / 4).asnumpy(), (-a).asnumpy(),
               a.astype("float16").asnumpy(),
               mx.nd.concatenate([a[:2], a[4:]]).asnumpy(),
               mx.nd.ones((2, 2), ctx=mx.cpu()).asnumpy(), a.size]
        outs.append(got)
    for g, w in zip(*outs[::-1]):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------- io ----

@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_reference(handle, shuffle):
    rng = np.random.RandomState(2)
    data = rng.normal(size=(10, 2, 3)).astype(np.float32)
    label = rng.randint(0, 4, 10).astype(np.float32)
    runs = []
    for mx in (jmx, tmx):
        np.random.seed(7)
        it = mx.io.NDArrayIter(data, label, batch_size=4, shuffle=shuffle,
                               last_batch_handle=handle)
        seen = [[tuple(it.provide_data[0]), tuple(it.provide_label[0]),
                 np.dtype(it.provide_data[0].dtype)]]
        for _ in range(3):      # epochs: each reset reshuffles
            for batch in it:
                seen.append((batch.data[0].asnumpy(),
                             batch.label[0].asnumpy(), batch.pad,
                             list(batch.index)))
            it.reset()
        seen.append(np.random.rand())   # nothing else drew from the RNG
        runs.append(seen)
    want, got = runs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            assert g == w
    assert tmx.io.NDArrayIter(data, batch_size=4).next().data[0].context \
        == torch.device("cpu")


def test_lr_schedulers_match_reference():
    for make in (lambda m: m.FactorScheduler(step=3, factor=0.5,
                                             stop_factor_lr=1e-3,
                                             base_lr=0.1),
                 lambda m: m.MultiFactorScheduler(step=[2, 5, 9],
                                                  factor=0.3, base_lr=0.2)):
        j, t = make(jmx.lr_scheduler), make(tmx.lr_scheduler)
        counts = [1, 1, 2, 3, 4, 7, 7, 10, 30]
        assert [t(n) for n in counts] == [j(n) for n in counts]


# ------------------------------------------------------------ optimizer ----

@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, wd=1e-4)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                 clip_gradient=0.05, rescale_grad=1.0 / 32)),
    ("adam", dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.5,
                  rescale_grad=0.25)),
])
def test_updater_matches_reference_within_one_ulp(name, kw):
    rng = np.random.RandomState(3)
    shapes = {"fc_weight": (6, 5), "fc_bias": (6,)}
    weights = {n: rng.normal(size=s).astype(np.float32)
               for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) * 4
              for n, s in shapes.items()} for _ in range(3)]

    def build(mx):
        w = mx.sym.Variable("fc_weight", lr_mult=0.5)
        return mx.sym.FullyConnected(mx.sym.Variable("data"), weight=w,
                                     num_hidden=6, name="fc")

    js, ts = _both(build)
    runs = []
    for mx, sym in ((jmx, js), (tmx, ts)):
        opt = mx.optimizer.create(
            name, sym=sym, param_idx2name=dict(enumerate(shapes)),
            lr_scheduler=mx.lr_scheduler.FactorScheduler(step=2,
                                                         factor=0.5),
            **kw)
        opt.set_lr_mult({})
        upd = mx.optimizer.get_updater(opt)
        arrs = {n: mx.nd.array(v, ctx=mx.cpu()) for n, v in weights.items()}
        steps = []
        for g in grads:
            for i, n in enumerate(shapes):
                upd(i, mx.nd.array(g[n], ctx=mx.cpu()), arrs[n])
            steps.append({n: a.asnumpy() for n, a in arrs.items()})
        runs.append(steps)
    for want, got in zip(*runs):
        for n in shapes:
            assert _ulps(got[n], want[n]) <= 1, n


def test_unported_optimizer_and_metric_raise():
    with pytest.raises(MXNetError, match="ROADMAP A2"):
        tmx.optimizer.create("rmsprop")
    with pytest.raises(MXNetError, match="ROADMAP A2"):
        tmx.metric.create("torch")
    with pytest.raises(MXNetError, match="not registered"):
        tmx.optimizer.create("nonesuch")


# --------------------------------------------------------------- metric ----

def test_metrics_match_reference_host_and_device():
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(3):
        logits = rng.normal(size=(16, 7)).astype(np.float32)
        prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        batches.append((prob.astype(np.float32),
                        rng.randint(0, 7, 16).astype(np.float32)))
    values = []
    for mx in (jmx, tmx):
        got = []
        for device in (False, True):
            metric = mx.metric.create(["acc", "crossentropy", mx.metric.create(
                "top_k_accuracy", top_k=3)])
            for prob, label in batches:
                labels = [mx.nd.array(label, ctx=mx.cpu())]
                preds = [mx.nd.array(prob, ctx=mx.cpu())]
                if device:
                    assert metric.update_device(labels, preds)
                else:
                    metric.update(labels, preds)
            got.append(metric.get())
        values.append(got)
    (jh, jd), (th, td) = values
    for (names, vals), (wnames, wvals) in ((th, jh), (td, jd), (td, jh)):
        assert names == wnames == ["accuracy", "cross-entropy",
                                   "top_k_accuracy_3"]
        np.testing.assert_allclose(vals, wvals, rtol=1e-6, atol=0)


def test_metric_shape_errors_raise_like_the_reference():
    prob = np.full((4, 3), 1 / 3, np.float32)
    for labels, preds in (([np.zeros(4)] * 2, [prob]),
                          ([np.zeros(5)], [prob])):
        for name in ("acc", "crossentropy"):
            with pytest.raises((ValueError, AssertionError)):
                jmx.metric.create(name).update(
                    [jmx.nd.array(x) for x in labels],
                    [jmx.nd.array(x) for x in preds])
            for device in (False, True):
                metric = tmx.metric.create(name)
                update = metric.update_device if device else metric.update
                with pytest.raises(ValueError, match="Shape of labels"):
                    update([tmx.nd.array(x, ctx=CPU) for x in labels],
                           [tmx.nd.array(x, ctx=CPU) for x in preds])
                assert metric.num_inst == 0 and not metric._dev_pending


# ---------------------------------------------------------- initializer ----

def test_initializer_routing_and_constants_match_reference():
    names = {"fc_weight": (4, 3), "fc_bias": (4,), "bn_gamma": (4,),
             "bn_beta": (4,), "bn_moving_mean": (4,), "bn_moving_var": (4,),
             "q_min": (2,)}
    for make in (lambda m: m.init.Zero(), lambda m: m.init.One(),
                 lambda m: m.init.Constant(0.5),
                 lambda m: m.init.create("constant", value=-2.0)):
        for name, shape in names.items():
            arrs = []
            for mx in (jmx, tmx):
                a = mx.nd.array(np.full(shape, 7, np.float32), ctx=mx.cpu())
                make(mx)(mx.init.InitDesc(name), a)
                arrs.append(a.asnumpy())
            np.testing.assert_array_equal(arrs[1], arrs[0], err_msg=name)
    # a variable's __init__ attribute wins over the routing
    desc = tmx.init.InitDesc("fc_bias", {"__init__": tmx.init.One().dumps()})
    a = tmx.nd.zeros((3,), ctx=CPU)
    tmx.init.Zero()(desc, a)
    np.testing.assert_array_equal(a.asnumpy(), np.ones(3, np.float32))
    with pytest.raises(MXNetError, match="Unknown initialization"):
        tmx.init.Zero()(tmx.init.InitDesc("foo"), a)


@pytest.mark.parametrize("rnd_type,factor_type", [("gaussian", "in"),
                                                  ("uniform", "avg")])
def test_xavier_shape_and_scale(rnd_type, factor_type):
    shape = (256, 64, 3, 3)
    tmx.random.seed(11)
    a = tmx.nd.zeros(shape, ctx=CPU)
    tmx.init.Xavier(rnd_type=rnd_type, factor_type=factor_type,
                    magnitude=2)(tmx.init.InitDesc("c_weight"), a)
    fan_in, fan_out = 64 * 9, 256 * 9
    scale = np.sqrt(2.0 / {"in": fan_in, "avg": (fan_in + fan_out) / 2}[
        factor_type])
    v = a.asnumpy()
    assert v.shape == shape
    want_std = scale if rnd_type == "gaussian" else scale / np.sqrt(3)
    assert abs(v.std() / want_std - 1) < 0.02
    if rnd_type == "uniform":
        assert np.abs(v).max() <= scale
    tmx.random.seed(11)
    b = tmx.nd.zeros(shape, ctx=CPU)
    tmx.init.Xavier(rnd_type=rnd_type, factor_type=factor_type,
                    magnitude=2)(tmx.init.InitDesc("c_weight"), b)
    np.testing.assert_array_equal(b.asnumpy(), v)   # seeded


# ------------------------------------------------------------ checkpoint ----

def _lenet_params(sym, seed, shapes):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    # weights normal with variance 1 / fan_in, other params normal * 0.1
    args = {n: (rng.normal(size=s) * (np.prod(s[1:]) ** -0.5 if len(s) > 1
                                      else 0.1)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def test_save_checkpoint_bytes_match_reference(tmp_path):
    js, ts = _both(lambda mx: mx.models.resnet.get_symbol(
        num_classes=10, num_layers=8, image_shape="3,28,28"))
    args, aux = _lenet_params(js, 5, {"data": (2, 3, 28, 28),
                                      "softmax_label": (2,)})
    files = []
    for mx, sym, tag in ((jmx, js, "j"), (tmx, ts, "t")):
        prefix = str(tmp_path / tag)
        mx.model.save_checkpoint(prefix, 3, sym,
                                 {k: mx.nd.array(v, ctx=mx.cpu())
                                  for k, v in args.items()},
                                 {k: mx.nd.array(v, ctx=mx.cpu())
                                  for k, v in aux.items()})
        files.append([open(prefix + suffix, "rb").read()
                      for suffix in ("-symbol.json", "-0003.params")])
    assert files[0] == files[1]
    sym, a2, x2 = tmx.model.load_checkpoint(str(tmp_path / "j"), 3)
    assert sym.tojson() == ts.tojson()
    for k, v in args.items():
        np.testing.assert_array_equal(a2[k].asnumpy(), v)
    with pytest.raises(MXNetError, match="ROADMAP A8"):
        tmx.model.save_checkpoint(str(tmp_path / "b"), 1, ts, {}, {},
                                  background=True)


# -------------------------------------------------------------- Module.fit --

N_TRAIN, N_VAL, BATCH, EPOCHS = 96, 40, 32, 2


def _dataset():
    rng = np.random.RandomState(6)
    label = rng.randint(0, 10, N_TRAIN + N_VAL)
    img = rng.uniform(0, 0.2, (N_TRAIN + N_VAL, 1, 28, 28))
    for i, c in enumerate(label):   # class-dependent blobs
        img[i, 0, (c // 5) * 12 + 2:(c // 5) * 12 + 12,
            (c % 5) * 5 + 2:(c % 5) * 5 + 6] += 0.7
    return img.astype(np.float32), label.astype(np.float32)


def _fit(mx, network, kvstore, optimizer, param_file, record):
    img, label = _dataset()
    with mx.name.NameManager():
        sym = mx.models.get_symbol(network, num_classes=10)
    np.random.seed(9)
    train = mx.io.NDArrayIter(img[:N_TRAIN], label[:N_TRAIN], BATCH,
                              shuffle=True)
    val = mx.io.NDArrayIter(img[N_TRAIN:], label[N_TRAIN:], BATCH)
    arg_params, aux_params = mx.model.load_params(param_file)
    ctx = {} if mx is jmx else {"context": CPU}
    mod = mx.mod.Module(sym, **ctx)
    params = {"sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
              "adam": {"learning_rate": 0.002, "wd": 1e-4}}[optimizer]
    metric = mx.metric.create(["acc", "crossentropy"])
    scores = []

    def batch_end(p):
        record.append((p.epoch, p.nbatch) + tuple(
            v for _, v in p.eval_metric.get_name_value()))

    def eval_end(p):
        scores.append(p.eval_metric.get_name_value())

    kv = mx.kvstore.create(kvstore)
    mod.fit(train, eval_data=val, eval_metric=metric, kvstore=kv,
            optimizer=optimizer, optimizer_params=params,
            arg_params=arg_params, aux_params=aux_params,
            batch_end_callback=batch_end, eval_end_callback=eval_end,
            num_epoch=EPOCHS)
    arg, aux = mod.get_params()
    fused = getattr(mod, "_fused_step", None) is not None
    return ({k: v.asnumpy() for k, v in {**arg, **aux}.items()}, scores,
            fused)


@pytest.fixture(scope="module")
def param_files(tmp_path_factory):
    """One ``.params`` file per network, written by the reference."""
    out = {}
    d = tmp_path_factory.mktemp("fit")
    for network in ("mlp", "lenet"):
        with jmx.name.NameManager():
            sym = jmx.models.get_symbol(network, num_classes=10)
        args, aux = _lenet_params(sym, 8, {"data": (BATCH, 1, 28, 28),
                                           "softmax_label": (BATCH,)})
        path = str(d / (network + ".params"))
        jmx.model.save_params(path, {k: jmx.nd.array(v)
                                     for k, v in args.items()},
                              {k: jmx.nd.array(v) for k, v in aux.items()})
        out[network] = path
    return out


@pytest.mark.parametrize("network", ["mlp", "lenet"])
@pytest.mark.parametrize("kvstore", ["local", "tpu_sync"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_module_fit_matches_reference(network, kvstore, optimizer,
                                      param_files, monkeypatch):
    jrec, trec = [], []
    jparams, jscores, jfused = _fit(jmx, network, kvstore, optimizer,
                                    param_files[network], jrec)
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    tparams, tscores, tfused = _fit(tmx, network, kvstore, optimizer,
                                    param_files[network], trec)
    assert tfused == jfused == (kvstore == "tpu_sync")
    assert len(trec) == len(jrec) == EPOCHS * N_TRAIN // BATCH
    for got, want in zip(trec, jrec):
        assert got[:3] == want[:3], (got, want)     # epoch, batch, accuracy
        np.testing.assert_allclose(got[3], want[3], rtol=CE_RTOL)
    assert len(tscores) == len(jscores) == EPOCHS
    for got, want in zip(tscores, jscores):
        assert [n for n, _ in got] == [n for n, _ in want]
        assert got[0] == want[0]        # validation accuracy
        np.testing.assert_allclose(got[1][1], want[1][1], rtol=CE_RTOL)
    worst, p99 = 0.0, 0.0
    for k, want in jparams.items():
        err = np.abs(tparams[k] - want) / max(np.abs(want).max(), TINY)
        worst = max(worst, err.max())
        p99 = max(p99, np.quantile(err, 0.99))
    tol = ADAM_CONV_TOL if (optimizer, network) == ("adam", "lenet") \
        else PARAM_TOL[optimizer]
    assert worst <= tol[0] and p99 <= tol[1], \
        "max scaled param difference %g, 99th percentile %g" % (worst, p99)


def test_module_fit_logs_the_reference_lines(param_files, caplog):
    caplog.set_level("INFO")
    _fit(tmx, "mlp", "local", "sgd", param_files["mlp"], [])
    text = caplog.text
    for epoch in range(EPOCHS):
        for line in ("Train-accuracy=", "Train-cross-entropy=",
                     "Time cost=", "Validation-accuracy=",
                     "Validation-cross-entropy="):
            assert "Epoch[%d] %s" % (epoch, line) in text, line


def test_module_checkpoint_and_predict_round_trip(param_files, tmp_path):
    img, label = _dataset()
    with tmx.name.NameManager():
        sym = tmx.models.get_symbol("mlp", num_classes=10)
    arg, aux = tmx.model.load_params(param_files["mlp"])
    mod = tmx.mod.Module(sym, context=CPU)
    it = tmx.io.NDArrayIter(img[:50], label[:50], 16)
    mod.bind(it.provide_data, it.provide_label, for_training=False)
    mod.set_params(arg, aux)
    out = mod.predict(it)
    assert out.shape == (50, 10)    # the last batch's padding is dropped
    mod.save_checkpoint(str(tmp_path / "m"), 1)
    back = tmx.mod.Module.load(str(tmp_path / "m"), 1, context=CPU)
    back.bind(it.provide_data, it.provide_label, for_training=False)
    np.testing.assert_array_equal(back.predict(it).asnumpy(),
                                  out.asnumpy())
    assert json.loads(open(str(tmp_path / "m-symbol.json")).read())[
        "heads"] == json.loads(sym.tojson())["heads"]
    assert os.path.exists(str(tmp_path / "m-0001.params"))
