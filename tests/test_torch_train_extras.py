"""The port's remaining training pieces held against the JAX package on
the CPU.

- Initializers: ``Orthogonal`` (uniform and normal) and ``Bilinear`` bit
  for bit under one numpy seed; ``Mixed`` routes names as the reference
  does. ``MSRAPrelu`` draws from each package's own RNG (``Xavier``
  gaussian, as in the reference), so it is held by its parameters
  (``dumps`` identical) and by the sample standard deviation of a large
  draw (within 2% of sqrt(magnitude / fan)).
- Schedulers: ``PolyScheduler`` and ``CosineScheduler`` give the same
  values.
- Metrics: ``Torch`` and ``Caffe`` (``Loss`` under other names) give the
  same name and value.
- Iterators: ``ResizeIter`` (shorter and longer than its source),
  ``PrefetchingIter`` (two sources renamed; the end and an error are
  sticky), ``CSVIter`` (pad and discard) and ``MNISTIter`` (idx files,
  plain and gzipped, a seeded shuffle): the same batches.
- Record files: ``.rec`` and ``.idx`` written by either package are the
  other's byte for byte (a record holding the magic word at aligned
  offsets takes the multi-part path) and read back in the other;
  ``pack``/``unpack`` identical; ``pack_img`` raises (ROADMAP A9).
- ``FeedForward``: ``fit`` (2 epochs of SGD-momentum from one ``.params``
  file, a seeded shuffle), ``save``, ``load``, ``predict`` and ``score``
  on a small MLP, within ``test_torch_module.py``'s tolerance: each leaf
  within 1e-6 of its max abs, predictions within 1e-5.
"""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# -- initializers -----------------------------------------------------------

def _init_both(make, name, shape, seed=3):
    np.random.seed(seed)
    ja = jmx.nd.zeros(shape)
    make(jmx)(jmx.init.InitDesc(name), ja)
    np.random.seed(seed)
    ta = tmx.nd.zeros(shape, ctx=tmx.cpu())
    make(tmx)(tmx.init.InitDesc(name), ta)
    return ja.asnumpy(), ta.asnumpy()


@pytest.mark.parametrize("shape", [(6, 4), (4, 10), (3, 2, 3, 3)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_bit_for_bit(rand_type, shape):
    want, got = _init_both(
        lambda mx: mx.init.Orthogonal(scale=1.5, rand_type=rand_type),
        "fc_weight", shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (1, 3, 5, 5)])
def test_bilinear_bit_for_bit(shape):
    want, got = _init_both(lambda mx: mx.init.Bilinear(), "up_weight", shape)
    np.testing.assert_array_equal(got, want)


def test_msra_prelu_parameters_and_scale():
    for factor_type, slope in (("avg", 0.25), ("in", 0.0), ("out", 0.1)):
        j = jmx.init.MSRAPrelu(factor_type=factor_type, slope=slope)
        t = tmx.init.MSRAPrelu(factor_type=factor_type, slope=slope)
        assert t.dumps() == j.dumps()
        assert (t.rnd_type, t.factor_type, t.magnitude) == \
            (j.rnd_type, j.factor_type, j.magnitude)
    shape = (256, 128, 3, 3)
    tmx.random.seed(5)
    arr = tmx.nd.zeros(shape, ctx=tmx.cpu())
    tmx.init.MSRAPrelu(factor_type="in", slope=0.25)(
        tmx.init.InitDesc("conv_weight"), arr)
    want = np.sqrt(2.0 / (1 + 0.25 ** 2) / (128 * 9))
    assert abs(arr.asnumpy().std() / want - 1) < 0.02


def test_mixed_routes_like_the_reference():
    def make(mx):
        return mx.init.Mixed([".*bias", ".*up.*", ".*"],
                             [mx.init.Constant(0.5), mx.init.Bilinear(),
                              mx.init.Orthogonal()])
    for name, shape in (("fc_bias", (4,)), ("up_weight", (1, 1, 4, 4)),
                        ("fc_weight", (4, 6))):
        want, got = _init_both(make, name, shape)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(MXNetError, match="did not match"):
        tmx.init.Mixed(["^a$"], [tmx.init.Zero()])(
            "b", tmx.nd.zeros((1,), ctx=tmx.cpu()))


# -- schedulers and metrics ---------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("PolyScheduler", dict(max_update=10, base_lr=0.5, pwr=2)),
    ("CosineScheduler", dict(max_update=10, base_lr=0.5, final_lr=0.01))])
def test_schedulers_match_reference(name, kw):
    js = getattr(jmx.lr_scheduler, name)(**kw)
    ts = getattr(tmx.lr_scheduler, name)(**kw)
    assert [ts(n) for n in range(14)] == [js(n) for n in range(14)]


@pytest.mark.parametrize("name", ["torch", "caffe"])
def test_plugin_metrics_match_reference(name):
    rng = np.random.RandomState(1)
    jm, tm = jmx.metric.create(name), tmx.metric.create(name)
    for _ in range(3):
        pred = rng.rand(4, 3).astype(np.float32)
        jm.update(None, [jmx.nd.array(pred)])
        tm.update(None, [tmx.nd.array(pred, ctx=tmx.cpu())])
    assert tm.get()[0] == jm.get()[0] == name
    assert abs(tm.get()[1] - jm.get()[1]) <= 1e-6 * abs(jm.get()[1])


# -- iterators ----------------------------------------------------------------

def _batches(it, n=None):
    out = []
    for i, b in enumerate(it):
        if n is not None and i == n:
            break
        out.append(([d.asnumpy() for d in b.data],
                    [lb.asnumpy() for lb in (b.label or [])], b.pad))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(g, w)


def _arrays(seed=0, n=10):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


@pytest.mark.parametrize("size", [2, 7])
def test_resize_iter_matches_reference(size):
    x, y = _arrays()
    got, want = [], []
    for pkg, out in ((jmx, want), (tmx, got)):
        it = pkg.io.ResizeIter(pkg.io.NDArrayIter(x, y, batch_size=4), size)
        out += _batches(it)
        it.reset()
        out += _batches(it)
    _same_batches(got, want)


def test_prefetching_iter_matches_reference():
    x, y = _arrays()
    x2, _ = _arrays(1)
    got, want = [], []
    for pkg, out in ((jmx, want), (tmx, got)):
        it = pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, y, batch_size=4),
             pkg.io.NDArrayIter(x2, batch_size=4, data_name="aux")],
            rename_data=[{"data": "a"}, {"aux": "b"}])
        assert [d.name for d in it.provide_data] == ["a", "b"]
        out += _batches(it)
        with pytest.raises(StopIteration):
            it.next()   # the end is sticky
        it.reset()
        out += _batches(it)
    _same_batches(got, want)


class _Failing(tmx.io.DataIter):
    def __init__(self):
        super().__init__(2)
        self.provide_data = self.provide_label = []

    def next(self):
        raise ValueError("broken source")


def test_prefetching_iter_error_is_sticky():
    it = tmx.io.PrefetchingIter(_Failing())
    for _ in range(2):
        with pytest.raises(ValueError, match="broken source"):
            it.next()
    it._shutdown()


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_reference(tmp_path, round_batch):
    rng = np.random.RandomState(2)
    data = rng.rand(11, 6).astype(np.float32)
    label = rng.randint(0, 3, (11, 1)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=4,
              round_batch=round_batch)
    want = _batches(jmx.io.CSVIter(**kw))
    got = _batches(tmx.io.CSVIter(**kw))
    _same_batches(got, want)
    assert tmx.io.CSVIter(**kw).provide_data == \
        [tmx.io.DataDesc("data", (4, 2, 3))]


def _write_idx(path, array, gz):
    head = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz,flat", [(False, False), (True, True)])
def test_mnist_iter_matches_reference(tmp_path, gz, flat):
    rng = np.random.RandomState(4)
    sfx = ".gz" if gz else ""
    img, lbl = str(tmp_path / ("img" + sfx)), str(tmp_path / ("lbl" + sfx))
    _write_idx(img, rng.randint(0, 256, (20, 5, 5)), gz)
    _write_idx(lbl, rng.randint(0, 10, (20,)), gz)
    out = {}
    for pkg in (jmx, tmx):
        np.random.seed(8)
        it = pkg.io.MNISTIter(image=img, label=lbl, batch_size=8,
                              shuffle=True, flat=flat)
        out[pkg.__name__] = _batches(it)
    _same_batches(out["mxnet_tpu_torch"], out["mxnet_tpu"])


def test_unported_iterators_raise_a9():
    for name in ("ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"):
        with pytest.raises(MXNetError, match="ROADMAP A9"):
            getattr(tmx.io, name)


# -- record files -----------------------------------------------------------

def _records():
    rng = np.random.RandomState(6)
    magic = struct.pack("<I", 0xced7230a)
    return [b"", b"abc", rng.bytes(1001),
            b"head" + magic + b"mid!" + magic + b"tail",  # multi-part
            magic * 3, rng.bytes(4096) + magic]


def _write_rec(pkg, rec, idx):
    w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, r in enumerate(_records()):
        w.write_idx(i, r)
    w.close()


@pytest.mark.parametrize("writer,reader", [(jmx, tmx), (tmx, jmx)])
def test_record_files_cross_byte_for_byte(tmp_path, writer, reader):
    files = {}
    for pkg in (writer, reader):
        rec = str(tmp_path / (pkg.__name__ + ".rec"))
        idx = str(tmp_path / (pkg.__name__ + ".idx"))
        _write_rec(pkg, rec, idx)
        files[pkg.__name__] = (open(rec, "rb").read(), open(idx).read())
    assert files["mxnet_tpu"] == files["mxnet_tpu_torch"]
    rec = str(tmp_path / (writer.__name__ + ".rec"))
    idx = str(tmp_path / (writer.__name__ + ".idx"))
    r = reader.recordio.MXIndexedRecordIO(idx, rec, "r")
    for i in reversed(range(len(_records()))):
        assert r.read_idx(i) == _records()[i]
    r.close()
    seq = reader.recordio.MXRecordIO(rec, "r")
    assert [seq.read() for _ in _records()] == _records()
    assert seq.read() is None
    seq.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]])
def test_pack_unpack_match_reference(label):
    h = (0, label, 7, 9)
    jb = jmx.recordio.pack(jmx.recordio.IRHeader(*h), b"payload")
    tb = tmx.recordio.pack(tmx.recordio.IRHeader(*h), b"payload")
    assert tb == jb
    jh, js = jmx.recordio.unpack(jb)
    th, ts = tmx.recordio.unpack(tb)
    assert ts == js == b"payload"
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


def test_image_records_raise_a9():
    for call in (lambda: tmx.recordio.pack_img((0, 0, 0, 0), None),
                 lambda: tmx.recordio.unpack_img(b"")):
        with pytest.raises(MXNetError, match="ROADMAP A9"):
            call()


# -- FeedForward ------------------------------------------------------------

def _mlp(mx):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=16,
                                                    name="fc1"),
                              act_type="relu")
        out = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return mx.sym.SoftmaxOutput(out, name="softmax")


def test_feedforward_fit_save_load_predict(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.rand(40, 5).astype(np.float32)
    y = rng.randint(0, 3, 40).astype(np.float32)
    shapes, _, _ = _mlp(tmx).infer_shape(data=(8, 5))
    init = {n: rng.normal(0, 0.3, s).astype(np.float32)
            for n, s in zip(_mlp(tmx).list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    out = {}
    for pkg, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        args = {k: pkg.nd.array(v, **({"ctx": ctx} if pkg is tmx else {}))
                for k, v in init.items()}
        np.random.seed(5)
        model = pkg.model.FeedForward(
            _mlp(pkg), ctx=ctx, num_epoch=2, numpy_batch_size=8,
            arg_params=args, learning_rate=0.1, momentum=0.9)
        model.fit(X, y)
        prefix = str(tmp_path / pkg.__name__)
        model.save(prefix)
        loaded = pkg.model.FeedForward.load(prefix, 2, ctx=ctx,
                                            numpy_batch_size=8)
        pred = loaded.predict(X)
        acc = loaded.score(pkg.io.NDArrayIter(X, y, batch_size=8))
        out[pkg.__name__] = ({k: v.asnumpy()
                              for k, v in model.arg_params.items()},
                             pred, acc)
    (wp, wpred, wacc), (gp, gpred, gacc) = out["mxnet_tpu"], \
        out["mxnet_tpu_torch"]
    for k in wp:
        err = np.abs(gp[k] - wp[k]).max() / np.abs(wp[k]).max()
        assert err <= 1e-6, (k, err)
    assert gpred.shape == wpred.shape == (40, 3)
    np.testing.assert_allclose(gpred, wpred, rtol=0, atol=1e-5)
    assert gacc == wacc


def test_background_save_checkpoint_is_point_in_time(tmp_path):
    sym = _mlp(tmx)
    w = tmx.nd.ones((3, 16), ctx=tmx.cpu())
    prefix = str(tmp_path / "bg")
    handle = tmx.model.save_checkpoint(prefix, 1, sym, {"fc2_weight": w}, {},
                                       background=True)
    w[:] = 5.0
    handle.wait(timeout=30)
    assert handle.done()
    _, args, _ = tmx.model.load_checkpoint(prefix, 1)
    np.testing.assert_array_equal(args["fc2_weight"].asnumpy(),
                                  np.ones((3, 16), np.float32))
    cb = tmx.callback.do_checkpoint(prefix, background=True)
    for epoch in range(2):
        cb(epoch, sym, {"fc2_weight": w}, {})
    cb.wait(timeout=60)
    assert os.path.isfile(prefix + "-0002.params")
