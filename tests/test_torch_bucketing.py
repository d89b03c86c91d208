"""``mx.mod.BucketingModule`` of the port held against ``mxnet_tpu``'s on the
CPU.

A 1-layer LSTM language model (``mx.rnn.LSTMCell`` unrolled a bucket, as
the reference's ``example/rnn/lstm_bucketing.py`` builds it) fits 6
batches over 3 buckets from ``BucketSentenceIter`` in both packages, from
the same numpy weights, then 6 more after ``init_optimizer(force_init=
True)`` has replaced its optimizer (one module, so the reference compiles
its bucket programs once); the parameters after each fit agree within
rtol 1e-5 / atol 1e-6:

- Adam under ``kvstore='tpu_sync'``: the default bucket's module (whose
  ``init_optimizer`` ran) updates through the fused step, kernel #7's
  path, while the other buckets update through the shared per-parameter
  updater with Adam state of their own, in the reference as in the port.
  So the fit ends elsewhere than under ``local``, where every bucket
  shares one updater (ROADMAP §C records this fault of the reference;
  this test pins the port to it).
- Then SGD with momentum under ``local``.

Also: each bucket's update path, the shared optimizer objects, ``prepare``
binding a bucket without switching, ``get_params`` / ``set_params``
through the current bucket, ``install_monitor`` reaching every bucket,
and the device prefetch carrying ``bucket_key`` with its pinned ring
keyed by shape.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io_device
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
#: V = 4H and E = H give the 7 parameters 2 shapes, so the reference's
#: per-parameter updater compiles 2 programs an optimizer, not 7
V, E, H, BATCH = 24, 6, 6, 3
BUCKETS = [2, 3, 4]
OPTS = {"adam": {"learning_rate": 0.05},
        "sgd": {"learning_rate": 0.1, "momentum": 0.9}}


def _sym_gen(mx):
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=E,
                                 name="embed")
        cell = mx.rnn.LSTMCell(num_hidden=H, prefix="lstm_l0_")
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, H))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax",
                                    use_ignore=True, ignore_label=0)
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _sentences():
    """Two batches a bucket: 6 batches of 3."""
    rng = np.random.RandomState(0)
    return [list(rng.randint(1, V, n)) for n in BUCKETS for _ in range(6)]


def _weights():
    sym = _sym_gen(jmx)(max(BUCKETS))[0]
    shapes, _, _ = sym.infer_shape(data=(BATCH, max(BUCKETS)),
                                   softmax_label=(BATCH, max(BUCKETS)))
    rng = np.random.RandomState(3)
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


#: the fits, in order, on one module
FITS = (("tpu_sync", "adam"), ("local", "sgd"))


def _fit(mx, fits=FITS):
    """Each (kvstore, optimizer) of ``fits`` fits one epoch of 6 batches
    on one module -> (module, [(bucket keys, params, update paths)])."""
    it = mx.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=list(BUCKETS),
                                   invalid_label=0, shuffle_seed=1)
    mod = mx.mod.BucketingModule(_sym_gen(mx),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in _weights().items()},
                    aux_params={})
    out = []
    for kvstore, opt in fits:
        mod.init_optimizer(kvstore=kvstore, optimizer=opt,
                           optimizer_params=OPTS[opt], force_init=True)
        keys = []
        it.reset()
        for batch in it:
            keys.append(batch.bucket_key)
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        args, _ = mod.get_params()
        paths = {k: getattr(b, "_fused_step", None) is not None
                 for k, b in mod._buckets.items()}
        out.append((keys, {k: v.asnumpy() for k, v in args.items()}, paths))
    return mod, out


@pytest.fixture(scope="module")
def reference():
    return dict(zip(FITS, _fit(jmx)[1]))


@pytest.fixture(scope="module")
def port():
    mod, fits = _fit(tmx)
    return mod, dict(zip(FITS, fits))


@pytest.mark.parametrize("kvstore,opt", FITS)
def test_bucketed_fit_ends_with_the_reference_parameters(reference, port,
                                                         kvstore, opt):
    want_keys, want, want_paths = reference[(kvstore, opt)]
    mod, fits = port
    keys, got, paths = fits[(kvstore, opt)]
    assert keys == want_keys and len(set(keys)) == 3 and len(keys) == 6
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the update path of each bucket, the reference's: the default one's
    # fused step under tpu_sync, the shared per-parameter updater elsewhere
    assert paths == want_paths == {k: kvstore == "tpu_sync"
                                   and k == max(BUCKETS) for k in BUCKETS}
    default = mod._buckets[mod._default_bucket_key]
    for bucket in mod._buckets.values():
        assert bucket._optimizer is default._optimizer
        assert bucket._updater is default._updater


def test_tpu_sync_state_split_is_pinned(reference):
    """ROADMAP §C: under tpu_sync the default bucket's Adam state lives in
    the fused step and the others' in the updater, so the fit differs
    from the local one, whose buckets share one state, by far more than
    the parity tolerance, in both packages."""
    _, [(_, local, _)] = _fit(tmx, [("local", "adam")])
    _, fused, _ = reference[("tpu_sync", "adam")]
    gap = max(float(np.abs(local[k] - fused[k]).max()) for k in local)
    assert gap > 1e-2


def test_bucketing_module_surface(tmp_path):
    it = tmx.rnn.BucketSentenceIter(_sentences(), BATCH,
                                    buckets=list(BUCKETS), invalid_label=0,
                                    shuffle_seed=1)
    mod = tmx.mod.BucketingModule(_sym_gen(tmx), default_bucket_key=4,
                                  context=tmx.cpu())
    assert mod.data_names == ("data",)
    assert mod.output_names == ["softmax_output"]
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Xavier())
    batches = list(it)
    short = next(b for b in batches if b.bucket_key == 2)
    # prepare binds the bucket without switching to it
    mod.prepare(short)
    assert sorted(mod._buckets) == [2, 4] and mod._curr_bucket_key == 4
    mod.forward(short, is_train=False)
    assert mod._curr_bucket_key == 2
    assert mod.get_outputs()[0].shape == (BATCH * 2, V)
    # parameters go through the current bucket and sync on a switch
    args, aux = mod.get_params()
    args = {k: v * 0 + 0.01 for k, v in args.items()}
    mod.set_params(args, aux)
    mod.forward(next(b for b in batches if b.bucket_key == 3),
                is_train=False)
    assert mod._curr_bucket_key == 3
    np.testing.assert_array_equal(mod.get_params()[0]["pred_weight"]
                                  .asnumpy(), args["pred_weight"].asnumpy())
    mon = tmx.monitor.Monitor(1)
    mod.install_monitor(mon)
    assert all(m._monitor is mon for m in mod._buckets.values())
    # the optimizer state file goes through the current bucket's module
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        learning_rate=0.1, momentum=0.9))
    mod.forward(short, is_train=True)
    mod.backward()
    mod.update()
    fname = str(tmp_path / "x.states")
    mod.save_optimizer_states(fname)
    slots = {k: v.asnumpy() for k, v in
             mod._curr_module._updater.states.items()}
    mod._curr_module._updater.states = {}
    mod.load_optimizer_states(fname)
    restored = mod._curr_module._updater.states
    assert set(restored) == set(slots) and slots
    for k in slots:
        np.testing.assert_array_equal(restored[k].asnumpy(), slots[k])


def test_device_prefetch_carries_buckets_and_keys_its_ring_by_shape(
        monkeypatch):
    def bucket_iter():
        return tmx.rnn.BucketSentenceIter(_sentences(), BATCH,
                                          buckets=list(BUCKETS),
                                          invalid_label=0, shuffle_seed=1)
    plain = [(b.bucket_key, b.provide_data, b.data[0].asnumpy())
             for b in bucket_iter()]
    pre = io_device.DevicePrefetchIter(
        bucket_iter(), stage_fn=io_device.default_stage_fn(tmx.cpu()),
        depth=2)
    try:
        staged = [(b.bucket_key, b.provide_data, b.data[0].asnumpy())
                  for b in pre]
    finally:
        pre._shutdown()
    assert [s[:2] for s in staged] == [p[:2] for p in plain]
    for s, p in zip(staged, plain):
        np.testing.assert_array_equal(s[2], p[2])
    # the card's pinned ring: one buffer a (position, shape, dtype), so a
    # bucket change takes another buffer and the same bucket its own again
    empty = torch.empty
    monkeypatch.setattr(io_device.torch, "empty",
                        lambda *a, pin_memory=False, **k: empty(*a, **k))
    slot = {"bufs": {}, "event": None}
    two, three = torch.zeros(BATCH, 2), torch.zeros(BATCH, 3)
    b2 = io_device._PinnedRing.buffer(slot, 0, two)
    b3 = io_device._PinnedRing.buffer(slot, 0, three)
    assert b2.shape == two.shape and b3.shape == three.shape
    assert io_device._PinnedRing.buffer(slot, 0, two) is b2
    assert len(slot["bufs"]) == 2
