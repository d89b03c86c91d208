"""The port's ServingFrontDoor and ServingClient held against the JAX
package's, on the CPU, over real sockets on 127.0.0.1 (port 0).

- Cross-package, both ways: a port ``ServingClient`` served by a
  ``mxnet_tpu`` ``ServingFrontDoor`` and a ``mxnet_tpu`` client served by
  a port front door, both servers holding the same seeded MLP weights:
  every answer within 1e-5 of the reference's max abs of the in-process
  reference answer; ``health()`` over the wire has the reference's keys,
  at the top and per model, both ways.
- Decode streams through the port's front door (the tiny transformer on
  the plain tier, ``params_from_jax`` from the numpy weights the
  reference's engine also gets) give the reference ``DecodeEngine``'s
  ``generate`` tokens; a stream whose transport breaks mid-generation
  resumes by id and delivers seq_nos 1..N exactly once.
- Exactly once: a connection killed with an admitted request resolves it
  by id from the orphan store, once; the orphan TTL and a finished
  stream's TTL expire through ``_sweep_orphans_locked(now)``, no sleeps;
  ``submitted == served + shed + failed`` at the end of each scenario.
- Per-peer eviction after repeated mid-frame failures, refused at accept
  until the cooldown ends; a tampered frame is rejected before decode and
  counted; a pickle peer is served while compat is on and refused when
  it is off; drain resolves what it admitted, then refuses, and waits
  for a reply the writer is sending before it closes the connection.
- Deadline propagation: a budget the wire already spent sheds at the
  door; control verbs (health, list_models, ping, an unknown verb).

Every socket wait has a timeout of at most 10 s.
"""
import importlib
import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.serving import DecodeEngine as JDecodeEngine
from mxnet_tpu.serving import ModelServer as JServer
from mxnet_tpu.serving import ServingClient as JClient
from mxnet_tpu.serving import ServingFrontDoor as JFrontDoor

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.serving import (DecodeEngine, ModelServer,
                                     ServingClient, ServingFrontDoor)
from mxnet_tpu_torch.serving import wire
from torch_one_thread import one_torch_thread  # noqa: F401

jt = importlib.import_module("mxnet_tpu.models.transformer")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
WAIT = 10.0
KEY = "frontdoor-key"
PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [2, 7]]
NEW = 12


def _net(mx, prefix):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name=prefix + "_fc0")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name=prefix + "_fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _weights(sym, seed=0):
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(4, 6))
    return {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _port_server(async_worker=True, model="fd"):
    with tmx.name.NameManager():
        sym = _net(tmx, model)
    srv = ModelServer()
    srv.register(model, sym, _weights(sym), ctx=tmx.cpu(), buckets=(1, 4),
                 max_delay_ms=0.5, async_worker=async_worker,
                 warmup_shapes={"data": (4, 6)})
    return srv


def _lm_configs():
    kw = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32,
              max_len=64, block_k=16)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _lm_params(cfg, seed=3):
    rng = np.random.RandomState(seed)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers

    def rand(*shape, loc=0.0, scale=0.3):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": rand(cfg.vocab_size, d), "pos_embed": rand(cfg.max_len, d),
        "ln_f_scale": rand(d, loc=1.0, scale=0.1), "ln_f_bias": rand(d),
        "layers": {
            "wq": rand(L, d, d), "wk": rand(L, d, d), "wv": rand(L, d, d),
            "wo": rand(L, d, d), "w1": rand(L, d, f), "b1": rand(L, f),
            "w2": rand(L, f, d), "b2": rand(L, d),
            "ln1_scale": rand(L, d, loc=1.0, scale=0.1),
            "ln1_bias": rand(L, d),
            "ln2_scale": rand(L, d, loc=1.0, scale=0.1),
            "ln2_bias": rand(L, d)}}


@pytest.fixture(scope="module")
def servers():
    """The port's and the reference's servers from one set of weights,
    each behind its own front door; the port's also serves the tiny
    transformer as decode model "lm"."""
    with tmx.name.NameManager():
        tsym = _net(tmx, "fd")
    with jmx.name.NameManager():
        jsym = _net(jmx, "fd")
    weights = _weights(tsym)
    tsrv = ModelServer()
    tsrv.register("fd", tsym, weights, ctx=tmx.cpu(), buckets=(1, 4),
                  max_delay_ms=0.5, warmup_shapes={"data": (4, 6)})
    jsrv = JServer()
    jsrv.register("fd", jsym, {k: jmx.nd.array(v)
                               for k, v in weights.items()},
                  ctx=jmx.cpu(), buckets=(1, 4), max_delay_ms=0.5,
                  warmup_shapes={"data": (4, 6)})
    jcfg, tcfg = _lm_configs()
    np_params = _lm_params(jcfg)
    model = tt.TransformerDecodeModel(
        tcfg, params=tt.params_from_jax(np_params, torch.device("cpu")),
        device="cpu")
    engines = [DecodeEngine(name="lm%d" % i, num_blocks=64, batch_size=3,
                            max_seq_len=64, prefill_buckets=(16,),
                            **model.engine_kwargs()) for i in range(2)]
    for eng in engines:
        tsrv.register_decode("lm", eng)
    tfd = ServingFrontDoor(tsrv, port=0, auth_key=KEY).start()
    jfd = JFrontDoor(jsrv, port=0, auth_key=KEY).start()
    yield {"port": tsrv, "ref": jsrv, "port_fd": tfd, "ref_fd": jfd,
           "jcfg": jcfg, "np_params": np_params, "engines": engines}
    tfd.drain(timeout=WAIT)
    jfd.drain(timeout=WAIT)
    tsrv.stop()
    jsrv.stop()


def _x(seed, n=4):
    return np.random.RandomState(seed).normal(0, 1, (n, 6)).astype(
        np.float32)


def _ref_answer(jsrv, x):
    return np.asarray(jsrv.predict("fd", {"data": x})[0])


def _accounted(st):
    return st["submitted"] == st["served"] + st["shed"] + st["failed"]


def _wait(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(0.005)


def _model_keys(health):
    return set(health), set(next(iter(health["models"].values())))


def test_port_client_against_reference_frontdoor(servers):
    cli = ServingClient("127.0.0.1", servers["ref_fd"].port, auth_key=KEY,
                        connect_deadline_s=WAIT)
    try:
        for seed, n in ((0, 4), (1, 1), (2, 3)):
            x = _x(seed, n)
            want = _ref_answer(servers["ref"], x)
            got = cli.predict({"data": x}, model="fd", timeout=WAIT)[0]
            assert isinstance(got, np.ndarray) and got.shape == want.shape
            assert np.abs(got - want).max() <= TOL * np.abs(want).max()
            port = servers["port"].predict("fd", {"data": x})[0].asnumpy()
            assert np.abs(port - want).max() <= TOL * np.abs(want).max()
        fut = cli.predict_async({"data": torch.from_numpy(_x(4))},
                                model="fd", deadline_ms=5000.0)
        got = fut.result_wait(WAIT)[0]
        want = _ref_answer(servers["ref"], _x(4))
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
        assert fut.timings["trace"] == fut.trace
        assert _model_keys(cli.health(timeout=WAIT)) == \
            _model_keys(servers["ref"].health())
    finally:
        cli.close()
    assert _accounted(servers["ref_fd"].stats())


def test_reference_client_against_port_frontdoor(servers):
    cli = JClient("127.0.0.1", servers["port_fd"].port, auth_key=KEY,
                  connect_deadline_s=WAIT)
    try:
        for seed, n in ((0, 4), (5, 2)):
            x = _x(seed, n)
            want = _ref_answer(servers["ref"], x)
            got = np.asarray(cli.predict({"data": x}, model="fd",
                                         timeout=WAIT)[0])
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.abs(got - want).max() <= TOL * np.abs(want).max()
        timings = cli.predict_async({"data": _x(6)}, model="fd")
        timings.result_wait(WAIT)
        assert {"trace", "wire_ms", "queue_ms", "device_ms",
                "total_ms"} <= set(timings.timings)
        assert _model_keys(cli.health(timeout=WAIT)) == \
            _model_keys(servers["ref"].health())
        models = cli.list_models(timeout=WAIT)
        assert models["fd"]["default_version"] == "1"
        assert set(models) == {"fd"}
    finally:
        cli.close()
    assert _accounted(servers["port_fd"].stats())


def test_health_has_the_reference_keys_and_windows_queue_wait(servers):
    tsrv = servers["port"]
    tsrv.health()                                 # open a window
    assert tsrv.health()["models"]["fd"]["queue_wait_p95_ms"] is None
    tsrv.predict_async("fd", {"data": _x(9)}).result_wait(WAIT)
    h = tsrv.health()
    assert _model_keys(h) == _model_keys(servers["ref"].health())
    m = h["models"]["fd"]
    assert m["queue_wait_p95_ms"] is not None and m["replicas"] == 1
    assert m["replicas_available"] == 1 and m["breaker_states"] == ["closed"]
    assert tsrv.health()["models"]["fd"]["queue_wait_p95_ms"] is None


def test_decode_streams_give_the_reference_tokens(servers):
    jcfg = servers["jcfg"]
    jparams = jax.tree_util.tree_map(jax.numpy.asarray,
                                     servers["np_params"])
    jmodel = jt.TransformerDecodeModel(jcfg, params=jparams, flash="off")
    jeng = JDecodeEngine(jmodel.params, name="jfd", num_blocks=64,
                         batch_size=3, max_seq_len=64,
                         prefill_buckets=(16,), kv_shape=jmodel.kv_shape,
                         prefill_fn=jmodel.prefill_fn,
                         step_fn=jmodel.step_fn)
    try:
        want = [jeng.generate(p, max_new_tokens=NEW, timeout=60.0)
                for p in PROMPTS]
    finally:
        jeng.stop()
    cli = ServingClient("127.0.0.1", servers["port_fd"].port, auth_key=KEY,
                        connect_deadline_s=WAIT)
    try:
        streams = [cli.decode_async(p, model="lm", max_new_tokens=NEW)
                   for p in PROMPTS]
        got = [s.result_wait(WAIT) for s in streams]
        assert [list(s) for s in streams] == got
    finally:
        cli.close()
    assert got == want
    assert all(len(t) == NEW for t in got)
    st = servers["port_fd"].stats()
    assert st["stream_frames"] >= NEW * len(PROMPTS) and _accounted(st)
    assert all(e.stats()["kv"]["blocks_live"] == 0
               for e in servers["engines"])


def test_broken_stream_resumes_with_exactly_the_missing_suffix(servers):
    fd = servers["port_fd"]
    cli = ServingClient("127.0.0.1", fd.port, auth_key=KEY,
                        connect_deadline_s=WAIT)
    seen, broke = [], threading.Event()

    def on_token(stream, seq_no, token):
        seen.append(seq_no)
        if seq_no == 4 and not broke.is_set():
            broke.set()
            cli._pool[0].break_transport()

    resumes = fd.stats()["stream_resumes"]
    try:
        stream = cli.decode_async(PROMPTS[2], model="lm",
                                  max_new_tokens=24, on_token=on_token)
        got = stream.result_wait(WAIT)
    finally:
        cli.close()
    assert broke.is_set() and seen == list(range(1, 25))
    engine = servers["engines"][0]
    assert got == engine.generate(PROMPTS[2], max_new_tokens=24,
                                  timeout=WAIT)
    assert cli.stats["stream_resumes"] == 1
    assert fd.stats()["stream_resumes"] == resumes + 1


class _Raw:
    """A previous-protocol (pickle) speaker for frame-level tests."""

    def __init__(self, port, key=None):
        self.key = key
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=WAIT)
        self.sock.settimeout(WAIT)
        hello = wire.recv_msg(self.sock, auth_key=key)
        assert hello[0] == "hello"
        self.conn_id = hello[1]
        self.seq = 0

    def rid(self):
        self.seq += 1
        return "c%d-%d" % (self.conn_id, self.seq)

    def send(self, msg):
        wire.send_msg(self.sock, msg, auth_key=self.key)

    def recv(self):
        return wire.recv_msg(self.sock, auth_key=self.key)

    def spec(self, x, deadline_ms=None, t_send=None, model="fd"):
        return {"model": model, "version": None, "arrays": {"data": x},
                "deadline_ms": deadline_ms, "priority": 0, "trace": None,
                "t_send": time.time() if t_send is None else t_send}

    def close(self):
        self.sock.close()


def _closed(raw):
    """True when the gateway closed the raw connection on us."""
    try:
        return raw.recv() is None
    except (OSError, wire.FrameError):
        return True


def test_killed_connection_resolves_by_id_exactly_once():
    srv = _port_server(async_worker=False)      # runs only at flush
    fd = ServingFrontDoor(srv, port=0, orphan_ttl_s=60.0).start()
    try:
        raw = _Raw(fd.port)
        x = np.full((2, 6), 3.0, np.float32)
        rid = raw.rid()
        raw.send(("predict", rid, raw.spec(x)))
        _wait(lambda: fd.stats()["pending"] == 1, "admission")
        raw.close()                             # the connection dies
        raw2 = _Raw(fd.port)
        raw2.send(("resolve", raw2.rid(), [rid]))
        assert raw2.recv()[2][rid] == ("pending",)
        srv.engine("fd").flush()
        _wait(lambda: fd.stats()["orphaned"] == 1, "the orphaned reply")
        with fd._lock:        # the store holds host values, no tensors
            held = fd._orphans[rid][1]
        assert [type(v) for v in held[2]] == [np.ndarray]
        reply_rid = raw2.rid()
        raw2.send(("resolve", reply_rid, [rid, "c999-1"]))
        reply = raw2.recv()
        assert reply[:2] == ("resolved", reply_rid)
        outcome = reply[2][rid]
        assert outcome[:2] == ("served", rid)
        np.testing.assert_array_equal(
            outcome[2][0], srv.predict("fd", {"data": x})[0].asnumpy())
        assert reply[2]["c999-1"] == ("unknown",)
        raw2.send(("resolve", raw2.rid(), [rid]))   # handed out once
        assert raw2.recv()[2][rid] == ("unknown",)
        raw2.close()
        st = fd.stats()
        assert st["orphan_resolved"] == 1 and st["served"] == 1
        assert _accounted(st) and st["legacy_peers"] == 2
    finally:
        fd.drain(timeout=WAIT)
        srv.stop()


def test_client_fails_over_and_resolves_by_id_never_resends():
    srv = _port_server(async_worker=False)
    fd = ServingFrontDoor(srv, port=0).start()
    cli = ServingClient("127.0.0.1", fd.port, connect_deadline_s=WAIT)
    try:
        x = np.full((1, 6), 2.0, np.float32)
        fut = cli.predict_async({"data": x}, model="fd")
        _wait(lambda: fd.stats()["pending"] == 1, "admission")
        with fd._lock:
            conn = next(iter(fd._conns))
        fd._close_conn(conn)
        _wait(lambda: fd.stats()["orphaned"] == 0 and cli.stats[
            "failovers"] == 1, "the client's failover")
        srv.engine("fd").flush()
        out = fut.result_wait(WAIT)
        np.testing.assert_array_equal(
            out[0], srv.predict("fd", {"data": x})[0].asnumpy())
        assert cli.stats["resolved_remote"] == 1
        st = fd.stats()
        assert st["submitted"] == 1 and _accounted(st)
    finally:
        cli.close()
        fd.drain(timeout=WAIT)
        srv.stop()


def test_orphan_and_stream_ttl_expire_by_the_clock(servers):
    srv = servers["port"]
    fd = ServingFrontDoor(srv, port=0, orphan_ttl_s=30.0).start()
    try:
        raw = _Raw(fd.port)
        raw.send(("predict", raw.rid(), raw.spec(_x(3))))
        raw.send(("decode", raw.rid(),
                  {"model": "lm", "tokens": PROMPTS[0],
                   "max_new_tokens": 4, "deadline_ms": None, "priority": 0,
                   "trace": None, "t_send": time.time()}))
        verbs = set()
        while not {"served", "sdone"} <= verbs:
            verbs.add(raw.recv()[0])
        # a close mid-frame: the peer may not have read its replies, so
        # the served one moves from the sent-ring to the orphan store
        raw.sock.sendall(b"\x05\x00")
        raw.close()
        _wait(lambda: fd.stats()["orphaned"] == 1, "the orphan")
        st = fd.stats()
        assert st["orphans_held"] == 1 and st["streams_held"] == 1
        with fd._lock:
            fd._sweep_orphans_locked(time.monotonic())  # not yet due
        assert fd.stats()["orphans_held"] == 1
        with fd._lock:
            fd._sweep_orphans_locked(time.monotonic() + 31.0)
        st = fd.stats()
        assert st["orphans_held"] == 0 and st["orphan_expired"] == 1
        assert st["streams_held"] == 0 and st["streams_expired"] == 1
        assert _accounted(st)
    finally:
        fd.drain(timeout=WAIT)


def test_peer_eviction_until_the_cooldown_ends(servers):
    fd = ServingFrontDoor(servers["port"], port=0, evict_threshold=2,
                          evict_cooldown_ms=60000.0).start()
    try:
        for _ in range(2):
            raw = _Raw(fd.port)
            raw.sock.sendall(struct.pack("<Q", 1 << 59))   # oversized
            assert _closed(raw)
            raw.close()
        _wait(lambda: fd.stats()["evictions"] == 1, "the eviction")
        sock = socket.create_connection(("127.0.0.1", fd.port),
                                        timeout=WAIT)
        sock.settimeout(WAIT)
        assert wire.recv_msg(sock) is None              # refused
        sock.close()
        assert fd.stats()["refused_evicted"] == 1
        with fd._lock:                                  # the cooldown ends
            fd._strikes["127.0.0.1"][1] = time.monotonic() - 1.0
        raw = _Raw(fd.port)
        raw.send(("ping", raw.rid()))
        assert raw.recv()[0] == "pong"
        raw.close()
    finally:
        fd.drain(timeout=WAIT)


class _Boom:
    def __reduce__(self):
        return (pytest.fail, ("a tampered frame was unpickled",))


def test_tampered_frame_is_rejected_before_decode_and_counted(servers):
    fd = servers["port_fd"]
    before = fd.stats()["auth_rejected"]
    raw = _Raw(fd.port, key=KEY.encode())
    sealed = wire._seal(pickle.dumps(_Boom()), KEY.encode())
    tampered = bytes([sealed[0] ^ 0xFF]) + sealed[1:]
    raw.sock.sendall(struct.pack("<Q", len(tampered)) + tampered)
    assert _closed(raw)
    raw.close()
    _wait(lambda: fd.stats()["auth_rejected"] == before + 1, "the count")
    # a keyless client fails its handshake typed
    with pytest.raises(MXNetError):
        ServingClient("127.0.0.1", fd.port, connect_deadline_s=2.0,
                      auth_key="").ping(timeout=WAIT)
    with fd._lock:          # the strikes above must not evict other tests
        fd._strikes.clear()


@pytest.mark.parametrize("compat", [True, False], ids=["compat", "strict"])
def test_pickle_peer_served_only_under_compat(servers, compat):
    fd = ServingFrontDoor(servers["port"], port=0,
                          wire_compat=compat).start()
    try:
        x = _x(11)
        want = servers["port"].predict("fd", {"data": x})[0].asnumpy()
        raw = _Raw(fd.port)
        rid = raw.rid()
        raw.send(("predict", rid, raw.spec(x)))
        reply = raw.recv()
        raw.close()
        st = fd.stats()
        if compat:
            assert reply[:2] == ("served", rid)
            np.testing.assert_array_equal(reply[2][0], want)
            assert st["legacy_peers"] == 1
        else:
            assert reply is None and st["submitted"] == 0
            assert st["frames"] == 0
        cli = ServingClient("127.0.0.1", fd.port, connect_deadline_s=WAIT)
        try:
            np.testing.assert_array_equal(
                cli.predict({"data": x}, model="fd", timeout=WAIT)[0], want)
        finally:
            cli.close()
        assert fd.stats()["negotiated_safe"] == 1
    finally:
        fd.drain(timeout=WAIT)


def test_deadline_spent_on_the_wire_sheds_at_the_door(servers):
    from mxnet_tpu_torch import profiler as tprof
    fd = ServingFrontDoor(servers["port"], port=0).start()
    try:
        tprof.latency_counters(reset=True, prefix="serving.fd.wire")
        raw = _Raw(fd.port)
        rid = raw.rid()
        raw.send(("predict", rid, raw.spec(_x(12), deadline_ms=500.0,
                                           t_send=time.time() - 1.0)))
        reply = raw.recv()
        assert reply[:2] == ("shed", rid) and "wire transfer" in reply[2]
        raw.send(("ping", raw.rid()))
        assert raw.recv()[0] == "pong"
        raw.send(("frobnicate", "c0-9"))
        assert raw.recv() == ("failed", "c0-9", "unknown verb 'frobnicate'")
        raw.send(("list_models", raw.rid()))
        assert set(raw.recv()[2]) == {"fd"}
        raw.close()
        st = fd.stats()
        assert st["wire_shed"] == 1 and st["shed"] == 1 and _accounted(st)
        wire_hist = tprof.latency_counters(prefix="serving.fd.wire")
        assert wire_hist["serving.fd.wire"]["count"] >= 1
    finally:
        fd.drain(timeout=WAIT)


def test_drain_waits_for_a_reply_the_writer_is_sending():
    """A reply the writer has taken off its queue but not yet written still
    reaches the client: drain waits for the send to return before it
    closes the socket. (The reference's drain reads only the queue's
    emptiness and cuts such a reply: ROADMAP C.) The writer is held in
    its send by a 400 ms delay at the ``frontdoor.reply`` fault site."""
    from mxnet_tpu_torch.resilience import faults
    srv = _port_server()
    fd = ServingFrontDoor(srv, port=0).start()
    cli = ServingClient("127.0.0.1", fd.port, connect_deadline_s=WAIT)
    faults.configure("frontdoor.reply:verb=served:times=1:delay=400")
    try:
        fut = cli.predict_async({"data": np.zeros((1, 6), np.float32)},
                                model="fd")
        _wait(lambda: fd.stats()["served"] == 1, "the request served")
        assert fd.drain(timeout=WAIT)
        assert faults.stats()["frontdoor.reply"] == 1
        out = fut.result_wait(WAIT)
        assert np.asarray(out[0]).shape == (1, 3)
        st = fd.stats()
        assert st["pending"] == 0 and _accounted(st)
    finally:
        faults.configure(None)
        cli.close()
        srv.stop()


def test_drain_resolves_what_it_admitted_then_refuses():
    srv = _port_server()
    fd = ServingFrontDoor(srv, port=0).start()
    cli = ServingClient("127.0.0.1", fd.port, connect_deadline_s=WAIT)
    try:
        futs = [cli.predict_async({"data": np.zeros((1, 6), np.float32)},
                                  model="fd") for _ in range(16)]
        _wait(lambda: fd.stats()["served"] + fd.stats()["pending"] >= 1,
              "a request admitted")
        assert fd.drain(timeout=WAIT)
        served = refused = 0
        for f in futs:
            try:
                f.result_wait(WAIT)
                served += 1
            except MXNetError as e:
                assert "draining" in str(e) or "closed" in str(e) \
                    or "connection" in str(e), e
                refused += 1
        assert served >= 1 and served + refused == 16
        st = fd.stats()
        assert st["pending"] == 0 and _accounted(st)
        sock = socket.socket()
        sock.settimeout(WAIT)
        try:
            sock.connect(("127.0.0.1", fd.port))
            assert wire.recv_msg(sock) is None
        except OSError:
            pass                         # the listener is gone: refused
        finally:
            sock.close()
    finally:
        cli.close()
        srv.stop()
