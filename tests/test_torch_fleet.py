"""The port's fleet tier (``serving/pool.py``, ``worker.py``,
``autoscaler.py`` and ModelServer's attach points) on the CPU, over real
sockets on 127.0.0.1 (port 0).

- ``add_replicas`` / ``remove_replicas``: ids past the registered ones,
  the last replica never removed, an unavailable replica routed around
  (the forced probe still routes when nothing is available).
- Membership with an in-process ``ReplicaWorker``: join through warmup
  and the half-open probe, remote answers bit for bit the gateway's
  local ones; SUSPECT and DEAD driven through ``FleetPool.scan(now=)``
  (no sleeps): a suspect's replicas are routed around and its next
  heartbeat recovers it; a dead worker detaches and traffic survives on
  the local floor; a dead worker rejoining under its id is readmitted;
  a rollover reaches the remote replica over the control channel; an
  unwarmed worker is refused.
- Across packages, both ways: a port ``ReplicaWorker`` joins a
  ``mxnet_tpu`` ``FleetPool`` and a ``mxnet_tpu`` worker joins the port's,
  each side reading the other's join, probe, heartbeat and rollover
  frames: admission through the probe, answers within 1e-5 of the
  reference server's max abs, SUSPECT then recovery and DEAD through
  ``scan(now=)``, one rollover fan-out.
- The autoscaler against the JAX package's on the same health sequences:
  the same decisions and counters for hysteresis, the windowed shed
  rate, cooldown, the hard floor, the cap and the min-worker restore.
- Exactly one test spawns a real worker process
  (``python -m mxnet_tpu_torch.serving.worker --builder
  test_torch_fleet:build_worker`` through ``LocalProcessLauncher``) and
  SIGKILLs it mid-traffic: every request resolves typed with zero
  failures, ``submitted == served + shed + failed`` on both sides, the
  pool marks it SUSPECT then DEAD, and ``Autoscaler(min_workers=1)``
  launches a replacement that is admitted.

This module is also the worker's builder: its imports stay on the port's
side (the JAX package is imported inside the tests that compare).
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.serving import (Autoscaler, DeadlineExceeded,
                                     FleetPool, LocalProcessLauncher,
                                     ModelServer, ReplicaWorker)
from mxnet_tpu_torch.serving.pool import RemoteReplica
from torch_one_thread import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WAIT = 10.0
HEARTBEAT_S = 0.25


def _net(prefix="fl"):
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=8, name=prefix + "_fc0")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=3, name=prefix + "_fc1")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _params(sym, seed=0):
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(4, 6))
    return {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _server(model="fl", warm=True, ctx=None, **kw):
    """The fleet's model on a ModelServer: ``ctx`` None is the card, as
    for every entry point of the port."""
    sym = _net(model)
    srv = ModelServer(**kw)
    srv.register(model, sym, _params(sym), ctx=ctx, buckets=(1, 4),
                 max_delay_ms=0.5,
                 warmup_shapes={"data": (4, 6)} if warm else None)
    return srv


def build_worker():
    """The worker processes' builder (``--builder
    test_torch_fleet:build_worker``): the gateway's model and weights,
    warmed, on the CPU."""
    torch.set_num_threads(1)
    return _server(ctx=tmx.cpu())


def _x(seed=None, n=4):
    if seed is None:
        return np.arange(n * 6, dtype=np.float32).reshape(n, 6) / (n * 6.0)
    return np.random.RandomState(seed).normal(0, 1, (n, 6)).astype(
        np.float32)


def _wait(cond, what, timeout=WAIT, tick=0.005):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(tick)


def _remote(gw):
    return [r for r in gw._models["fl"].versions[1]
            if isinstance(r.engine, RemoteReplica)]


def _accounted(c):
    return c["submitted"] == c["served"] + c["shed"] + c["failed"]


# ---------------------------------------------------------------------------
# ModelServer attach points
# ---------------------------------------------------------------------------

def test_add_then_remove_replicas():
    srv = _server(ctx=tmx.cpu(), warm=False)
    try:
        reps = srv.add_replicas("fl", [srv.engine("fl")])
        assert len(reps) == 1 and reps[0].engine.replica == 1
        assert len(srv._models["fl"].versions[1]) == 2
        assert srv.health()["models"]["fl"]["replicas"] == 2
        assert srv.remove_replicas("fl", reps) == 1
        assert len(srv._models["fl"].versions[1]) == 1
        with pytest.raises(MXNetError, match="no replicas"):
            srv.remove_replicas("fl", list(srv._models["fl"].versions[1]))
        with pytest.raises(MXNetError, match="unknown model"):
            srv.add_replicas("nope", [srv.engine("fl")])
    finally:
        srv.stop()


def test_unavailable_replica_is_routed_around():
    sym = _net()
    srv = ModelServer()
    srv.register("fl", sym, _params(sym), ctx=tmx.cpu(), replicas=2)
    try:
        reps = srv._models["fl"].versions[1]
        reps[0].available = False
        for _ in range(4):
            rep = srv._acquire("fl", None)
            assert rep is reps[1]
            srv._complete(rep, "success")
        h = srv.health()["models"]["fl"]
        assert h["replicas"] == 2 and h["replicas_available"] == 1
        reps[1].available = False          # nothing available: forced probe
        rep = srv._acquire("fl", None)
        assert rep in reps
        srv._complete(rep, "success")
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# membership (an in-process worker: real sockets, one process)
# ---------------------------------------------------------------------------

class _Fleet:
    def __init__(self, worker_id="w-test", **pool_kw):
        self.gw = _server(ctx=tmx.cpu())
        self.pool = FleetPool(self.gw, port=0, heartbeat_s=HEARTBEAT_S,
                              connect_deadline_s=1.5, **pool_kw).start()
        self.worker = self.start_worker(worker_id)
        assert self.worker.joined.wait(WAIT), "worker never admitted"

    def start_worker(self, worker_id, warm=True, **kw):
        return ReplicaWorker(("127.0.0.1", self.pool.port),
                             _server(ctx=tmx.cpu(), warm=warm), port=0,
                             worker_id=worker_id, heartbeat_s=HEARTBEAT_S,
                             **kw).start()

    def close(self):
        self.worker.stop()
        self.pool.stop()
        self.gw.stop()


@pytest.fixture
def fleet():
    f = _Fleet()
    yield f
    f.close()


def test_join_probe_and_bit_identity(fleet):
    tprof.fleet_counters(reset=True)
    gw, pool, worker = fleet.gw, fleet.pool, fleet.worker
    assert worker.stats["probes"] == 1 and worker.warmed()
    remote = _remote(gw)
    assert len(remote) == 1
    for seed in (None, 1, 2):
        x = _x(seed)
        want = gw.engine("fl").predict({"data": x})[0].asnumpy()
        got = remote[0].engine.predict_async({"data": x}).result_wait(WAIT)
        np.testing.assert_array_equal(got[0], want)
        np.testing.assert_array_equal(
            remote[0].engine.predict({"data": x})[0], want)
    h = pool.health()
    assert h["workers"]["w-test"]["state"] == "alive"
    assert h["workers_alive"] == 1 and h["models"]["fl"]["replicas"] == 2
    st = gw.stats()["fl"]["versions"]["1"]
    assert st[1]["remote"] is True and st[1]["ctx"].startswith("remote:")


def test_suspect_is_routed_around_then_recovers(fleet):
    gw, pool = fleet.gw, fleet.pool
    handle = pool._workers["w-test"]
    remote = _remote(gw)
    assert pool.scan(now=handle.last_hb + pool._suspect_after_s + 0.01) == 1
    assert handle.state == "suspect"
    assert not any(r.available for r in remote)
    for _ in range(3):
        rep = gw._acquire("fl", None)
        assert not isinstance(rep.engine, RemoteReplica)
        gw._complete(rep, "success")
    # the worker is alive: its next heartbeat brings it back
    _wait(lambda: handle.state == "alive", "recovery")
    assert all(r.available for r in remote)
    assert pool.stats()["recoveries"] == 1


def test_dead_worker_detaches_and_traffic_survives(fleet):
    gw, pool, worker = fleet.gw, fleet.pool, fleet.worker
    worker._stop_evt.set()                  # no more heartbeats
    handle = pool._workers["w-test"]
    now = handle.last_hb + pool._dead_after_s + 0.01
    pool.scan(now=now)                      # -> suspect
    pool.scan(now=now)                      # still stale -> dead
    assert handle.state == "dead" and not _remote(gw)
    futs = [gw.predict_async("fl", {"data": _x(i)}, deadline_ms=5000.0)
            for i in range(8)]
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(
            f.result_wait(WAIT)[0],
            gw.engine("fl").predict({"data": _x(i)})[0].asnumpy())
    c = gw.stats()["fl"]["counters"]
    assert _accounted(c) and c["failed"] == 0
    assert pool.stats()["deads"] == 1


def test_dead_worker_rejoins_and_is_readmitted(fleet):
    gw, pool = fleet.gw, fleet.pool
    fleet.worker.stop()
    handle = pool._workers["w-test"]
    now = handle.last_hb + pool._dead_after_s + 0.01
    pool.scan(now=now)
    pool.scan(now=now)
    assert handle.state == "dead"
    fleet.worker = fleet.start_worker("w-test")    # the same id
    assert fleet.worker.joined.wait(WAIT), "readmission failed"
    assert pool.stats()["rejoins"] == 1 and fleet.worker.stats["probes"] == 1
    _wait(lambda: len(_remote(gw)) == 1, "the replica re-attached")
    x = _x(5)
    got = _remote(gw)[0].engine.predict_async({"data": x}).result_wait(WAIT)
    np.testing.assert_array_equal(
        got[0], gw.engine("fl").predict({"data": x})[0].asnumpy())


def test_rollover_fans_out_over_the_control_channel(fleet):
    gw, worker = fleet.gw, fleet.worker
    x = _x(7)
    local = gw.engine("fl")
    old = local.predict({"data": x})[0].asnumpy()
    new_params = {k: torch.from_numpy(v)
                  for k, v in _params(_net(), seed=42).items()}
    gw.rollover("fl", new_params)           # blocks on the worker's ack
    assert worker.stats["rollovers"] == 1
    new = local.predict({"data": x})[0].asnumpy()
    assert not np.array_equal(new, old)
    got = _remote(gw)[0].engine.predict_async({"data": x}).result_wait(WAIT)
    np.testing.assert_array_equal(got[0], new)


def test_unwarmed_worker_is_refused():
    gw = _server(ctx=tmx.cpu())
    pool = FleetPool(gw, port=0, heartbeat_s=HEARTBEAT_S).start()
    worker = ReplicaWorker(("127.0.0.1", pool.port),
                           _server(ctx=tmx.cpu(), warm=False), port=0,
                           worker_id="w-cold", heartbeat_s=HEARTBEAT_S,
                           rejoin_backoff_s=30.0).start()
    try:
        assert not worker.warmed()
        _wait(lambda: pool.stats()["rejects"] >= 1, "the refusal")
        assert not worker.joined.is_set() and "w-cold" not in pool.workers()
        assert not _remote(gw)
    finally:
        worker.stop()
        pool.stop()
        gw.stop()


def test_pool_thresholds_are_validated():
    gw = _server(ctx=tmx.cpu(), warm=False)
    try:
        with pytest.raises(MXNetError, match="suspect"):
            FleetPool(gw, port=0, heartbeat_s=1.0, suspect_after_s=5.0,
                      dead_after_s=2.0)
    finally:
        gw.stop()


# ---------------------------------------------------------------------------
# across packages: a port worker in a reference fleet, and the reverse
# ---------------------------------------------------------------------------

TOL = 1e-5


def _ref_server(warm=True):
    """The fleet's model on a ``mxnet_tpu`` ModelServer, the same
    weights as :func:`_server`'s."""
    import mxnet_tpu as jmx
    from mxnet_tpu.serving import ModelServer as JServer
    with tmx.name.NameManager():
        weights = _params(_net())
    with jmx.name.NameManager():
        data = jmx.sym.Variable("data")
        net = jmx.sym.FullyConnected(data, num_hidden=8, name="fl_fc0")
        net = jmx.sym.Activation(net, act_type="relu")
        net = jmx.sym.FullyConnected(net, num_hidden=3, name="fl_fc1")
        sym = jmx.sym.SoftmaxOutput(net, name="softmax")
    srv = JServer()
    srv.register("fl", sym, {k: jmx.nd.array(v) for k, v in weights.items()},
                 ctx=jmx.cpu(), buckets=(1, 4), max_delay_ms=0.5,
                 warmup_shapes={"data": (4, 6)} if warm else None)
    return srv


def _remote_any(gw):
    return [r for reps in gw._models["fl"].versions.values() for r in reps
            if type(r.engine).__name__ == "RemoteReplica"]


def _host(value):
    return value.asnumpy() if hasattr(value, "asnumpy") else np.asarray(value)


def _close_to(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("direction", ["port_worker_ref_pool",
                                       "ref_worker_port_pool"])
def test_fleet_across_packages(direction):
    """The control channel's join, probe, heartbeat and rollover frames
    and the dispatch plane, read by the other package: admission through
    the half-open probe, answers within TOL of the reference server's,
    SUSPECT then recovery and DEAD through ``scan(now=)``, one rollover
    fan-out."""
    from mxnet_tpu.serving import FleetPool as JPool
    from mxnet_tpu.serving import ReplicaWorker as JWorker
    ref = _ref_server()
    if direction == "port_worker_ref_pool":
        gw, pool_cls = ref, JPool
        worker_cls, worker_srv = ReplicaWorker, _server(ctx=tmx.cpu())
    else:
        gw, pool_cls = _server(ctx=tmx.cpu()), FleetPool
        worker_cls, worker_srv = JWorker, _ref_server()
    pool = pool_cls(gw, port=0, heartbeat_s=HEARTBEAT_S,
                    connect_deadline_s=1.5).start()
    worker = worker_cls(("127.0.0.1", pool.port), worker_srv, port=0,
                        worker_id="w-x", heartbeat_s=HEARTBEAT_S).start()
    try:
        assert worker.joined.wait(WAIT), "worker never admitted"
        assert worker.stats["probes"] == 1 and worker.stats["joins"] == 1
        remote = _remote_any(gw)
        assert len(remote) == 1
        for seed in (None, 1, 2):
            x = _x(seed)
            want = _host(ref.engine("fl").predict({"data": x})[0])
            got = remote[0].engine.predict_async({"data": x}).result_wait(
                WAIT)
            _close_to(got[0], want)
            _close_to(_host(gw.predict("fl", {"data": x})[0]), want)
        h = pool.health()
        assert h["workers"]["w-x"]["state"] == "alive"
        assert h["workers_alive"] == 1

        # the rollover's weights cross the control channel as host values
        new = _params(_net(), seed=42)
        if gw is ref:
            import mxnet_tpu as jmx
            gw.rollover("fl", {k: jmx.nd.array(v) for k, v in new.items()})
        else:
            gw.rollover("fl", {k: torch.from_numpy(v) for k, v in new.items()})
        assert worker.stats["rollovers"] == 1
        x = _x(7)
        want = _host(gw.engine("fl").predict({"data": x})[0])
        got = remote[0].engine.predict_async({"data": x}).result_wait(WAIT)
        _close_to(got[0], want)

        # SUSPECT is routed around; the worker's next heartbeat recovers it
        handle = pool._workers["w-x"]
        assert pool.scan(now=handle.last_hb + pool._suspect_after_s
                         + 0.01) == 1
        assert handle.state == "suspect"
        assert not any(r.available for r in remote)
        _wait(lambda: handle.state == "alive", "recovery")
        assert pool.stats()["recoveries"] == 1

        # no more heartbeats: DEAD detaches, traffic survives locally
        worker._stop_evt.set()
        now = handle.last_hb + pool._dead_after_s + 0.01
        pool.scan(now=now)
        pool.scan(now=now)
        assert handle.state == "dead" and not _remote_any(gw)
        for i in range(4):
            fut = gw.predict_async("fl", {"data": _x(i)}, deadline_ms=5000.0)
            _close_to(_host(fut.result_wait(WAIT)[0]),
                      _host(gw.engine("fl").predict({"data": _x(i)})[0]))
        c = gw.stats()["fl"]["counters"]
        assert _accounted(c) and c["failed"] == 0
        assert pool.stats()["deads"] == 1
    finally:
        worker.stop()
        pool.stop()
        gw.stop()
        worker_srv.stop()
        if gw is not ref:
            ref.stop()


# ---------------------------------------------------------------------------
# autoscaler, decision for decision against the reference's
# ---------------------------------------------------------------------------

class _FakeLauncher:
    def __init__(self, alive=1):
        self._alive = alive
        self.launched = 0
        self.terminated = 0

    def launch(self):
        self._alive += 1
        self.launched += 1
        return object()

    def terminate_one(self):
        if self._alive <= 0:
            return None
        self._alive -= 1
        self.terminated += 1
        return object()

    def alive_count(self):
        return self._alive


def _health(q95=0.0, submitted=0, shed=0, avail=3):
    return {"ok": True, "models": {"m": {
        "queue_wait_p95_ms": q95, "submitted": submitted, "shed": shed,
        "replicas_available": avail}}}


SCENARIOS = {
    "hysteresis": (dict(max_workers=4, up_queue_ms=100.0, hysteresis=2,
                        cooldown_s=0.0), 1, [_health(q95=500.0)] * 3),
    "shed_window": (dict(min_workers=1, hysteresis=1, cooldown_s=0.0,
                         up_queue_ms=1e9, up_shed_rate=0.1), 1,
                    [_health(submitted=100), _health(submitted=200,
                                                     shed=50),
                     _health(submitted=300, shed=100)]),
    "cooldown": (dict(hysteresis=1, cooldown_s=1000.0, up_queue_ms=100.0),
                 1, [_health(q95=500.0)] * 3),
    "floor": (dict(hysteresis=1, cooldown_s=0.0, down_queue_ms=50.0), 3,
              [_health(q95=0.0, avail=1)] * 2),
    "down": (dict(min_workers=1, hysteresis=1, cooldown_s=0.0,
                  down_queue_ms=50.0), 3, [_health(q95=0.0, avail=4)] * 3),
    "min_restore": (dict(min_workers=2, hysteresis=5, cooldown_s=0.0), 0,
                    [_health()] * 3),
    "cap": (dict(max_workers=2, hysteresis=1, cooldown_s=0.0,
                 up_queue_ms=100.0), 2, [_health(q95=500.0)] * 2),
    "no_signal": (dict(hysteresis=1, cooldown_s=0.0, down_queue_ms=50.0), 3,
                  [_health(q95=None, submitted=10),
                   _health(q95=None, submitted=20)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_decides_as_the_reference(name):
    from mxnet_tpu.serving import Autoscaler as JAutoscaler
    kw, alive, seq = SCENARIOS[name]
    runs = []
    for cls in (JAutoscaler, Autoscaler):
        launcher = _FakeLauncher(alive=alive)
        it = iter(seq)
        asc = cls(lambda: next(it), launcher, **kw)
        decisions = [asc.tick(now=1000.0 + i) for i in range(len(seq))]
        runs.append((decisions, asc.stats, launcher.launched,
                     launcher.terminated))
    assert runs[0] == runs[1]
    want = {"hysteresis": [None, "up", None], "cooldown": ["up", None, None],
            "floor": [None, None], "cap": [None, None],
            "min_restore": ["up", "up", None]}.get(name)
    if want is not None:
        assert runs[1][0] == want


def test_autoscaler_validates_and_counts_fleet_events():
    with pytest.raises(MXNetError):
        Autoscaler(lambda: _health(), _FakeLauncher(), min_workers=3,
                   max_workers=1)
    with pytest.raises(MXNetError):
        Autoscaler(lambda: _health(), _FakeLauncher(), hysteresis=0)
    tprof.fleet_counters(reset=True)
    asc = Autoscaler(lambda: _health(q95=500.0), _FakeLauncher(),
                     hysteresis=1, cooldown_s=0.0, up_queue_ms=100.0)
    assert asc.tick() == "up"
    assert tprof.fleet_counters()["scale_ups"] == 1


# ---------------------------------------------------------------------------
# a real worker process, SIGKILLed mid-traffic, replaced by the autoscaler
# ---------------------------------------------------------------------------

def test_real_worker_killed_mid_traffic_loses_nothing_and_is_replaced():
    gw = _server(ctx=tmx.cpu(), dispatch_retries=3)
    pool = FleetPool(gw, port=0, heartbeat_s=HEARTBEAT_S,
                     connect_deadline_s=1.0).start()
    env = {"PYTHONPATH": os.pathsep.join([HERE, ROOT]),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    launcher = LocalProcessLauncher(
        "127.0.0.1:%d" % pool.port, "test_torch_fleet:build_worker", env=env,
        extra_args=["--heartbeat-s", str(HEARTBEAT_S)])
    tprof.fleet_counters(reset=True)
    try:
        proc = launcher.launch()
        _wait(lambda: pool.stats()["workers_alive"] == 1, "the join", 60.0,
              0.02)
        wid = next(iter(pool.workers()))
        assert len(_remote(gw)) == 1
        x = _x(3)
        want = gw.engine("fl").predict({"data": x})[0].asnumpy()
        got = _remote(gw)[0].engine.predict_async(
            {"data": x}).result_wait(WAIT)
        np.testing.assert_array_equal(got[0], want)
        base = gw.stats()["fl"]["counters"]["submitted"]
        futs = []
        for i in range(120):
            if i == 40:
                proc.send_signal(signal.SIGKILL)
            futs.append(gw.predict_async("fl", {"data": x},
                                         deadline_ms=8000.0))
        assert proc.wait(WAIT) == -signal.SIGKILL
        # the floor of one worker: the autoscaler launches a replacement,
        # which starts while the old worker's requests are checked
        asc = Autoscaler(pool.health, launcher, min_workers=1,
                         max_workers=2, cooldown_s=0.0)
        assert launcher.alive_count() == 0
        assert asc.tick() == "up" and launcher.launches == 2
        served = shed = failed = 0
        for f in futs:
            try:
                np.testing.assert_array_equal(f.result_wait(30.0)[0], want)
                served += 1
            except DeadlineExceeded:
                shed += 1
            except MXNetError:
                failed += 1
        assert served + shed + failed == len(futs) and failed == 0
        c = gw.stats()["fl"]["counters"]
        assert c["submitted"] - base == len(futs) and _accounted(c)
        handle = pool._workers[wid]
        _wait(lambda: handle.state != "alive", "the suspicion")
        assert handle.state in ("suspect", "dead")
        pool.scan(now=time.monotonic() + pool._dead_after_s + 1.0)
        assert handle.state == "dead" and not _remote(gw)
        fleet = tprof.fleet_counters()
        assert fleet["joins"] == 1 and fleet["suspects"] == 1 \
            and fleet["deads"] == 1
        # (the replacement cannot have joined yet: its imports alone take
        # seconds, and the scan above would have aged it too)
        _wait(lambda: pool.stats()["workers_alive"] == 1, "the replacement",
              60.0, 0.02)
        new = _remote(gw)
        assert len(new) == 1 and new[0].engine._worker.worker_id != wid
        got = new[0].engine.predict_async({"data": x}).result_wait(WAIT)
        np.testing.assert_array_equal(got[0], want)
    finally:
        pool.stop()
        gw.stop()
        launcher.stop_all(timeout=WAIT)
