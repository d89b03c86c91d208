"""The port's serving engine, program cache and batcher held against the
JAX package on the CPU.

Every input is made from a numpy seed and goes through both packages;
both graphs are built in fresh ``NameManager`` scopes.

- ``InferenceEngine`` on an MLP with BatchNorm and on a two-convolution
  network (the reference fixtures' nets; no Dropout, which the port has
  not yet: ROADMAP A6): ``predict`` at N = bucket and bucket +- 1, from 1
  to above the largest bucket, within rtol 1e-5 / atol 1e-6 of the
  reference engine's (the reference's own contract,
  ``tests/python/unittest/test_serving.py``; float32 sums in another
  order); compile, hit and miss counters equal to the reference's, one
  compile per bucket; ``warmup`` builds every bucket and requests then
  build none; ``update_params`` builds nothing new and serves the new
  weights; ``predict_async`` (flushed on the calling thread, and on the
  worker) equal to ``predict``.
- ``Module.predict`` through the engine: the engine serves it (one
  program for full and padded batches) and its outputs are within rtol
  1e-5 of the reference's ``Module.predict``; a module whose score ran
  first keeps the executor path in both packages.
- ``DynamicBatcher`` (``async_worker=False`` and ``flush()``): the same
  request sizes and priorities give the same dispatched groups in the
  same order in both packages; an error reaches every waiter; an
  oversized request runs solo; expired and impossible deadlines shed as
  ``DeadlineExceeded``, counted alike.
- ``bucket_for``, ``pad_to_bucket``, the bulk knob and the profiler's
  ``latency_counters`` / ``percentile_from_counts`` /
  ``kernel_counters``: identical results.

Every wait on a future has a timeout.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import profiler as jprof
from mxnet_tpu.serving import (DeadlineExceeded as JDeadline,
                               DynamicBatcher as JBatcher,
                               InferenceEngine as JEngine)
from mxnet_tpu.serving import bucket_for as jbucket_for
from mxnet_tpu.serving import pad_to_bucket as jpad

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.serving import (DeadlineExceeded as TDeadline,
                                     DynamicBatcher as TBatcher,
                                     InferenceEngine as TEngine)
from mxnet_tpu_torch.serving import bucket_for as tbucket_for
from mxnet_tpu_torch.serving import pad_to_bucket as tpad
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
WAIT = 30.0          # seconds any future may take
CPU = tmx.cpu()


def _mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.BatchNorm(net, name="bn1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _convnet(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv0")
    net = mx.sym.Activation(net, act_type="relu", name="relu0")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                         name="pool0")
    net = mx.sym.Convolution(net, num_filter=16, kernel=(3, 3), pad=(1, 1),
                             name="conv1", no_bias=True)
    net = mx.sym.Flatten(net, name="flat0")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc0")
    return mx.sym.SoftmaxOutput(net, name="softmax")


NETS = {"mlp_bn": (_mlp, (6,)), "convnet": (_convnet, (3, 8, 8))}


def _both(build):
    with jmx.name.NameManager():
        js = build(jmx)
    with tmx.name.NameManager():
        ts = build(tmx)
    return js, ts


def _params(sym, row, rng, scale=0.3):
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(4,) + row)
    args = {n: rng.normal(0, scale, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rng.normal(0, 0.1, s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _jnd(d):
    return {k: jmx.nd.array(v) for k, v in d.items()}


def _engines(net, buckets, seed=0, **kw):
    build, row = NETS[net]
    js, ts = _both(build)
    rng = np.random.RandomState(seed)
    args, aux = _params(js, row, rng)
    je = JEngine(js, _jnd(args), _jnd(aux), ctx=jmx.cpu(), buckets=buckets,
                 **kw)
    te = TEngine(ts, args, aux, ctx=CPU, buckets=buckets, **kw)
    return je, te, row, rng


def _counters(eng):
    return (eng.compiles, eng.hits, eng.misses)


@pytest.mark.parametrize("net", sorted(NETS))
def test_engine_matches_reference_across_bucket_boundaries(net):
    buckets = (2, 4, 8)
    je, te, row, rng = _engines(net, buckets)
    sizes = sorted({max(1, b + d) for b in buckets for d in (-1, 0, 1)})
    for n in sizes:
        x = rng.normal(0, 1, (n,) + row).astype(np.float32)
        want = je.predict({"data": x})[0].asnumpy()
        got = te.predict({"data": x})[0].asnumpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg="batch %d" % n)
    # one program per bucket plus the exact shape above the top bucket
    assert _counters(te) == _counters(je) == (4, len(sizes) - 4, 4)


@pytest.mark.parametrize("net", sorted(NETS))
def test_warmup_builds_every_bucket_and_requests_build_none(net):
    je, te, row, rng = _engines(net, (1, 4, 8))
    shapes = {"data": (8,) + row}
    assert te.warmup(shapes) == je.warmup(shapes) == 3
    assert te.warmup() == je.warmup() == 0
    for n in (1, 3, 8):
        x = rng.normal(0, 1, (n,) + row).astype(np.float32)
        np.testing.assert_allclose(te.predict(x)[0].asnumpy(),
                                   je.predict(x)[0].asnumpy(), rtol=RTOL,
                                   atol=ATOL)
    assert _counters(te) == _counters(je) == (3, 3, 0)
    assert te.stats()["programs"] == 3 and te.captures == 0


def test_update_params_builds_nothing_and_serves_the_new_weights():
    je, te, row, rng = _engines("mlp_bn", (4,))
    x = rng.normal(0, 1, (3,) + row).astype(np.float32)
    te.predict(x)
    je.predict(x)
    new_args, new_aux = _params(je._symbol, row, np.random.RandomState(9))
    je.update_params(_jnd(new_args), _jnd(new_aux))
    te.update_params(new_args, new_aux)
    np.testing.assert_allclose(te.predict(x)[0].asnumpy(),
                               je.predict(x)[0].asnumpy(), rtol=RTOL,
                               atol=ATOL)
    assert _counters(te) == _counters(je) == (1, 1, 1)


@pytest.mark.parametrize("worker", [False, True], ids=["flush", "worker"])
def test_async_equals_sync(worker):
    je, te, row, rng = _engines("convnet", (2, 4, 8), async_worker=worker,
                                max_delay_ms=1.0)
    xs = [rng.normal(0, 1, (n,) + row).astype(np.float32)
          for n in (1, 2, 3, 1, 5)]
    try:
        futs = [te.predict_async({"data": x}) for x in xs]
        jfuts = [je.predict_async({"data": x}) for x in xs]
        if not worker:
            te.flush()
            je.flush()
        for x, f, jf in zip(xs, futs, jfuts):
            got = np.asarray(f.result_wait(WAIT)[0])
            np.testing.assert_allclose(got, te.predict(x)[0].asnumpy(),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got, np.asarray(jf.result_wait(
                WAIT)[0]), rtol=RTOL, atol=ATOL)
        st = te.stats()
        assert st["served"] == st["requests"] == len(xs)
        assert st["rows"] == sum(x.shape[0] for x in xs)
        if not worker:
            assert st["batches_run"] == je.stats()["batches_run"]
    finally:
        te.stop()
        je.stop()


def _module_pair(label):
    js, ts = _both(_mlp)
    rng = np.random.RandomState(7)
    args, aux = _params(js, (6,), rng)
    x = rng.normal(0, 1, (26, 6)).astype(np.float32)   # 26 = 2 * 10 + 6
    y = rng.randint(0, 3, (26,)).astype(np.float32) if label else None
    mods = []
    for mx, sym, ctx in ((jmx, js, jmx.cpu()), (tmx, ts, CPU)):
        def nd(d, mx=mx, ctx=ctx):
            return {k: mx.nd.array(v, ctx=ctx) for k, v in d.items()}
        mod = mx.mod.Module(sym, context=ctx)
        it = mx.io.NDArrayIter(x, y, batch_size=10,
                               label_name="softmax_label")
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label if label else None,
                 for_training=label)
        mod.init_params(arg_params=nd(args), aux_params=nd(aux))
        mods.append((mod, it))
    return mods


@pytest.mark.parametrize("label", [False, True], ids=["data", "labels"])
def test_module_predict_routes_through_the_engine(label):
    (jmod, jit), (tmod, tit) = _module_pair(label)
    tprof.compile_counters(reset=True)
    got = tmod.predict(tit)
    want = jmod.predict(jit)
    assert tmod._serving_engine is not None
    assert jmod._serving_engine is not None
    assert tmod._serving_engine.compiles == 1   # full and padded batches
    site = tprof.compile_counters()["sites"]["serving.softmax"]
    assert site["compiles"] == 1 and site["cache_hits"] == 2
    assert got.shape == want.shape == (26, 3)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    # a later predict refreshes the weights in place: nothing is built
    tmod.predict(tit)
    assert tmod._serving_engine.compiles == 1


def test_module_predict_after_score_keeps_the_executor_path():
    (jmod, jit), (tmod, tit) = _module_pair(True)
    jmod.score(jit, "acc")
    tmod.score(tit, "acc")
    got, want = tmod.predict(tit), jmod.predict(jit)
    assert tmod._serving_engine is None and jmod._serving_engine is None
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the batcher's scheduling, in both packages
# ---------------------------------------------------------------------------

def _recording_batchers(buckets, max_batch, **kw):
    out = []
    for cls in (JBatcher, TBatcher):
        calls = []

        def run(padded, n, calls=calls):
            calls.append((padded["x"].shape[0], n,
                          [int(v) for v in padded["x"][:n, 0]]))
            return [padded["x"] * 2.0]

        out.append((cls(run, buckets=buckets, max_batch=max_batch,
                        autostart=False, **kw), calls))
    return out


def test_batcher_groups_match_reference():
    sizes = (6, 3, 2, 1, 5, 4, 2, 8, 1, 7, 3)
    prios = (0, 0, 1, 0, 2, 0, 1, 0, 0, 3, 0)
    pairs = _recording_batchers((2, 4, 8), 8)
    reqs = []
    for b, _ in pairs:
        rs, row = [], 0
        for n, p in zip(sizes, prios):
            x = np.arange(row, row + n, dtype=np.float32).reshape(n, 1)
            rs.append(b.submit({"x": x}, priority=p))
            row += n
        b.flush()
        reqs.append(rs)
    (jb, jcalls), (tb, tcalls) = pairs
    assert tcalls == jcalls and len(tcalls) > 3
    assert tb.stats() == jb.stats()
    for jr, tr in zip(*reqs):
        np.testing.assert_array_equal(np.asarray(tr.result_wait(WAIT)[0]),
                                      np.asarray(jr.result_wait(WAIT)[0]))


def test_batcher_error_reaches_every_waiter():
    def run(padded, n):
        raise RuntimeError("the card fell over")

    b = TBatcher(run, buckets=(4,), max_batch=4, autostart=False)
    reqs = [b.submit({"x": np.zeros((1, 1), np.float32)}) for _ in range(3)]
    b.flush()
    for r in reqs:
        with pytest.raises(MXNetError, match="the card fell over"):
            r.result_wait(WAIT)


def test_batcher_oversized_request_runs_solo():
    pairs = _recording_batchers((4,), 4)
    for b, _ in pairs:
        r = b.submit({"x": np.arange(5, dtype=np.float32).reshape(5, 1)})
        b.flush()
        np.testing.assert_array_equal(
            np.asarray(r.result_wait(WAIT)[0]),
            2.0 * np.arange(5, dtype=np.float32).reshape(5, 1))
        with pytest.raises((MXNetError, jmx.base.MXNetError)):
            b.submit({"x": np.zeros((2, 1), np.float32),
                      "y": np.zeros((3, 1), np.float32)})
    assert pairs[0][1] == pairs[1][1] == [(5, 5, [0, 1, 2, 3, 4])]


def test_batcher_sheds_like_the_reference():
    """Queue wait past the deadline sheds at formation; a budget below the
    bucket's measured step time sheds at submit."""
    stats = []
    for cls, exc in ((JBatcher, JDeadline), (TBatcher, TDeadline)):
        b = cls(lambda padded, n: [padded["x"]], buckets=(4,), max_batch=4,
                autostart=False, step_time=lambda bucket: 0.05)
        late = [b.submit({"x": np.zeros((1, 1), np.float32)},
                         deadline_ms=60.0) for _ in range(2)]
        ok = b.submit({"x": np.zeros((1, 1), np.float32)})
        early = b.submit({"x": np.zeros((1, 1), np.float32)},
                         deadline_ms=10.0)
        with pytest.raises(exc, match="shed at submit"):
            early.result_wait(WAIT)
        time.sleep(0.08)
        b.flush()
        for r in late:
            with pytest.raises(exc):
                r.result_wait(WAIT)
        assert ok.result_wait(WAIT)[0].shape == (1, 1)
        stats.append(b.stats())
    assert stats[0] == stats[1]
    assert stats[1]["shed"] == 3 and stats[1]["served"] == 1


def test_bucket_for_pad_and_bulk_knob_match_reference():
    for n in range(1, 40):
        assert tbucket_for(n, (1, 4, 8, 16, 32)) == \
            jbucket_for(n, (1, 4, 8, 16, 32))
    with pytest.raises(MXNetError):
        tbucket_for(0, (1, 4))
    arrs = {"x": np.arange(6, dtype=np.float32).reshape(3, 2)}
    np.testing.assert_array_equal(tpad(arrs, 3, 5)["x"],
                                  jpad(arrs, 3, 5)["x"])
    assert tpad(arrs, 3, 3) is arrs
    b = TBatcher(lambda p, n: [p["x"]], buckets=(4, 16), autostart=False)
    assert b.max_batch == 16
    with tmx.engine.bulk(8):
        assert b.max_batch == 8
    with tmx.engine.bulk(64):
        assert b.max_batch == 16          # clamped to the top bucket
    with pytest.raises(ValueError):
        tmx.engine.set_bulk_size(-1)


def test_latency_and_kernel_counters_match_reference():
    for prof in (jprof, tprof):
        prof.latency_counters(reset=True, prefix="t.")
        for ns in (1e6,) * 90 + (1e9,) * 10 + (3.3e4, 7.7e7):
            prof.record_latency("t.x", ns)
        prof.record_latency("t.y", 2e5)
        prof.kernel_counters(reset=True)
        prof.record_kernel_roofline("k", 3.0, 4.0, "TFLOP/s")
    got = tprof.latency_counters(prefix="t.")
    assert got == jprof.latency_counters(prefix="t.")
    assert got["t.x"]["count"] == 102
    counts = tprof.latency_histogram("t.x")
    for q in (0.5, 0.95, 0.99):
        assert tprof.percentile_from_counts(counts, q) == \
            jprof.percentile_from_counts(counts, q)
    assert tprof.percentile_from_counts([0] * len(counts), 0.5) is None
    assert tprof.kernel_counters(reset=True) == \
        jprof.kernel_counters(reset=True)
    tprof.latency_counters(reset=True, prefix="t.x")
    assert list(tprof.latency_counters(prefix="t.")) == ["t.y"]
    for prof in (jprof, tprof):
        prof.latency_counters(reset=True, prefix="t.")


def test_engine_keeps_its_own_weights_and_results():
    """The engine serves copies of the weights it was given, and a result
    held across later requests keeps its values."""
    _, te, row, rng = _engines("mlp_bn", (4,))
    args = {n: t.clone() for n, t in te._params.items()}
    x = rng.normal(0, 1, (2,) + row).astype(np.float32)
    first = te.predict(x)[0]
    held = first.asnumpy()
    te.predict(rng.normal(0, 1, (4,) + row).astype(np.float32))
    np.testing.assert_array_equal(first.asnumpy(), held)
    te.update_params({n: t * 2 for n, t in args.items()})
    for n, t in args.items():
        assert torch.equal(te._params[n], t * 2)
