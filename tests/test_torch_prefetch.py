"""The device prefetch (``io_device.DevicePrefetchIter``) and the
resumable-iterator capability, held against the JAX package on the CPU.

- Order and epoch reset, the sticky end and the sticky error, the
  overlap of a slow iterator with a slow consumer, the counters: the
  reference's ``test_pipeline.py:70-140`` on the port's iterator.
- The capability: ``NDArrayIter.iter_checkpoint`` gives the reference's
  state dict on the same data and numpy seed, and a restore into a
  differently seeded iterator replays the same shuffle chain in both
  packages; ``DevicePrefetchIter`` forwards it, refuses a changed
  dataset, and refuses a capture mid-flight
  (``test_supervisor.py:419-460``).
- Staged batches are bit for bit the unwrapped ones, on fresh storage.
- ``Module.fit(kvstore='tpu_sync')`` wraps its iterator on the fused
  path (not with ``MXNET_DEVICE_PREFETCH=0``, nor on the per-parameter
  path), stops the stager when the fit ends, and a prefetched fit is bit
  for bit the fit without it.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, profiler
from mxnet_tpu_torch.io import DataBatch, DataIter, NDArrayIter
from mxnet_tpu_torch.io_device import DevicePrefetchIter, default_stage_fn
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = tmx.cpu()


def _stage():
    return default_stage_fn(CPU)


class _SlowIter(DataIter):
    """Batch i holds the value i; optional delay per batch; records when
    each batch was produced."""

    def __init__(self, num_batches, delay=0.0, batch_size=4):
        super().__init__(batch_size)
        self.num_batches = num_batches
        self.delay = delay
        self.cur = 0
        self.produced = []

    def reset(self):
        self.cur = 0

    def next(self):
        if self.cur >= self.num_batches:
            raise StopIteration
        if self.delay:
            time.sleep(self.delay)
        i = self.cur
        self.cur += 1
        self.produced.append((i, time.perf_counter()))
        data = tmx.nd.array(np.full((self.batch_size, 2), i, np.float32),
                            ctx=CPU)
        label = tmx.nd.array(np.full((self.batch_size,), i, np.float32),
                             ctx=CPU)
        return DataBatch(data=[data], label=[label], pad=0)


def _toy(n=64, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    return X, (X.sum(axis=1) > 0).astype(np.float32)


def test_ordering_and_epoch_reset():
    it = DevicePrefetchIter(_SlowIter(5), stage_fn=_stage())
    for _ in range(2):
        assert [int(b.data[0].asnumpy()[0, 0]) for b in it] == \
            [0, 1, 2, 3, 4]
        with pytest.raises(StopIteration):   # sticky, never a deadlock
            it.next()
        it.reset()


def test_overlaps_io_with_compute():
    d_io, d_compute, n = 0.03, 0.09, 8
    base = _SlowIter(n, delay=d_io)
    it = DevicePrefetchIter(base, stage_fn=_stage(), depth=2)
    consumed = []
    tic = time.perf_counter()
    for _ in it:
        time.sleep(d_compute)
        consumed.append((len(consumed), time.perf_counter()))
    wall = time.perf_counter() - tic
    assert wall < (d_io + d_compute) * n * 0.9
    assert any(base.produced[i + 2][1] < consumed[i][1]
               for i in range(n - 2))
    assert it.counters["staged"] == n
    assert it.counters["hits"] + it.counters["stalls"] == n


def test_sticky_error():
    class _Boom(_SlowIter):
        def next(self):
            if self.cur == 2:
                raise RuntimeError("decoder exploded")
            return super().next()

    it = DevicePrefetchIter(_Boom(5), stage_fn=_stage())
    it.next()
    it.next()
    with pytest.raises(RuntimeError, match="decoder exploded"):
        for _ in range(10):
            it.next()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="decoder exploded"):
        it.next()
    assert time.perf_counter() - t0 < 1.0
    it.reset()
    assert int(it.next().data[0].asnumpy()[0, 0]) == 0
    it._shutdown()


def test_staged_batches_are_the_host_batches_on_fresh_storage():
    X, y = _toy(20)
    base = NDArrayIter(X, y, batch_size=8)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in NDArrayIter(X, y, batch_size=8)]
    profiler.pipeline_counters(reset=True)
    got = list(DevicePrefetchIter(base, stage_fn=_stage()))
    assert len(got) == len(want) == 3
    for b, (d, l, pad) in zip(got, want):
        assert b._device_staged and b.pad == pad
        assert np.array_equal(b.data[0].asnumpy().view(np.uint32),
                              d.view(np.uint32))
        assert np.array_equal(b.label[0].asnumpy(), l)
    c = profiler.pipeline_counters()
    assert c["prefetch_hit"] + c["prefetch_stall"] == 3
    # fresh storage: a later write to the host batch changes nothing
    host = tmx.nd.array(X[:8], ctx=CPU)
    staged = _stage()(DataBatch(data=[host], label=[]))
    host[:] = 0.0
    assert np.array_equal(staged.data[0].asnumpy(), X[:8])


def _state_of(mx, seed):
    X, y = _toy()
    np.random.seed(seed)
    it = mx.io.NDArrayIter(X, y, batch_size=8, shuffle=True)
    for _ in it:
        pass
    return it.iter_checkpoint(), it


def _schedules(it, epochs):
    out = []
    for _ in range(epochs):
        out.append(np.concatenate([b.data[0].asnumpy()[:, 0] for b in it]))
        it.reset()
    return out


def test_iter_checkpoint_matches_reference_and_replays():
    jstate, jit = _state_of(jmx, 11)
    tstate, tit = _state_of(tmx, 11)
    assert tstate == jstate
    assert tmx.io.is_resumable(tit) and not tmx.io.is_resumable(object())
    # each restore sets numpy's shuffle chain back to the captured one
    jit.iter_restore(jstate)
    jit.reset()
    want = _schedules(jit, 3)
    tit.iter_restore(tstate)
    tit.reset()
    assert all(np.array_equal(a, b) for a, b in zip(_schedules(tit, 3),
                                                    want))
    X, y = _toy()
    np.random.seed(999)                   # another world
    b = tmx.io.NDArrayIter(X, y, batch_size=8, shuffle=True)
    b.iter_restore(tstate)
    b.reset()                             # the pending reset, replayed
    assert all(np.array_equal(x, w) for x, w in zip(_schedules(b, 3),
                                                    want))
    other = tmx.io.NDArrayIter(X[:32], y[:32], batch_size=8)
    with pytest.raises(MXNetError, match="dataset changed"):
        other.iter_restore(tstate)


def test_prefetch_forwards_the_capability_and_refuses_mid_flight():
    X, y = _toy()
    np.random.seed(3)
    it = DevicePrefetchIter(tmx.io.NDArrayIter(X, y, batch_size=8,
                                               shuffle=True),
                            stage_fn=_stage())
    assert tmx.io.is_resumable(it)
    for _ in it:                          # a whole epoch: a boundary
        pass
    state = it.iter_checkpoint()
    assert state["cursor"] >= len(X)
    it.iter_restore(state)
    it.reset()
    assert [b.data[0].shape for b in it] == [(8, 6)] * 8
    it.reset()
    it.next()                             # the stager reads ahead
    with pytest.raises(MXNetError, match="epoch boundary"):
        it.iter_checkpoint()
    it._shutdown()
    with pytest.raises(MXNetError, match="not resumable"):
        DevicePrefetchIter(_SlowIter(2), stage_fn=_stage()).iter_checkpoint()


def _fit(monkeypatch, prefetch, kvstore="tpu_sync"):
    if prefetch is not None:
        monkeypatch.setenv("MXNET_DEVICE_PREFETCH", prefetch)
    X, y = _toy()
    np.random.seed(5)
    it = tmx.io.NDArrayIter(X, y, batch_size=8, shuffle=True)
    with tmx.name.NameManager():
        d = tmx.sym.Variable("data")
        h = tmx.sym.Activation(tmx.sym.FullyConnected(d, num_hidden=8),
                               act_type="relu")
        sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(h, num_hidden=3),
                                    name="softmax")
    mod = tmx.mod.Module(sym, context=CPU)
    wrapped = []
    real = mod._wrap_train_iter

    def spy(train_data):
        wrapped.append(real(train_data))
        return wrapped[-1]

    mod._wrap_train_iter = spy
    tmx.random.seed(4)
    mod.fit(it, num_epoch=2, kvstore=kvstore,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.init.Xavier())
    params, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in params.items()}, wrapped[0], it


def test_fit_prefetch_is_bitwise_the_fit_without_it(monkeypatch):
    profiler.pipeline_counters(reset=True)
    with_pf, wrapper, base = _fit(monkeypatch, None)
    assert isinstance(wrapper, DevicePrefetchIter) and wrapper.base is base
    assert wrapper._thread is None        # stopped when the fit ended
    c = profiler.pipeline_counters()
    assert c["steps"] == 16 and c["prefetch_hit"] + c["prefetch_stall"] \
        == 16
    without, plain_it, base = _fit(monkeypatch, "0")
    assert plain_it is base
    for k in without:
        assert np.array_equal(with_pf[k].view(np.uint32),
                              without[k].view(np.uint32)), k
    _, local_it, base = _fit(monkeypatch, None, kvstore="local")
    assert local_it is base               # no fused step, no prefetch
