"""The port's ModelServer held against the JAX package's on the CPU.

Each scenario runs on both packages' servers from the same numpy
weights and requests; both graphs are built in fresh ``NameManager``
scopes.

- Routing: ``models``/``versions``/``default_version``, the default alias
  (the first version registered, ``set_default_version``, the newest
  remaining one after ``unregister``), an unknown model or version
  raising; each answer within rtol 1e-5 / atol 1e-6 of the reference's
  (float32 sums in another order).
- The circuit breaker under ``serving.dispatch`` faults on replica 0
  (threshold 2, a 250 ms cooldown): the same open / half-open / closed
  states after each step as the reference's, every request served on
  replica 1 while replica 0 is sick, exact accounting (submitted ==
  served + shed + failed, zero failed), and the healed replica
  readmitted by its half-open probe.
- ``rollover`` builds nothing (the programs' counters stay), relabels the
  version and serves the new weights.
- ``submit_decode``: a pin picks the replica the reference picks
  (``crc32`` of the pin), no pin the least-loaded one; a stream through
  the server equals the same prompt through the ``DecodeEngine`` alone.
- Impossible deadlines shed as ``DeadlineExceeded`` and are counted.
- Hedging (``hedge_ms=20``, port only): requests that a 500 ms
  ``serving.dispatch`` delay holds on replica 0 are answered by their
  hedge on replica 1, each counted once.
- ``stats`` has the reference's keys at every level (the port adds
  ``captures`` to each replica's), and ``reload_from`` of a directory
  with no committed checkpoint loads nothing in both.

Every wait on a future has a timeout.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.serving import DeadlineExceeded as JDeadline
from mxnet_tpu.serving import ModelServer as JServer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serving import DeadlineExceeded as TDeadline
from mxnet_tpu_torch.serving import DecodeEngine, tiny_lm_params
from mxnet_tpu_torch.serving import ModelServer as TServer
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6
WAIT = 30.0
# the breaker's cooldown outlasts a drain of the sick phase on a loaded
# host, so each phase sees the states it is meant to
COOLDOWN_MS = 250.0
PAST_COOLDOWN = 0.3
PKGS = ((jmx, JServer, jfaults, JDeadline, jmx.cpu()),
        (tmx, TServer, tfaults, TDeadline, tmx.cpu()))


def _net(mx, prefix):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name=prefix + "_fc0")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name=prefix + "_fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _syms(prefix):
    out = []
    for mx, *_ in PKGS:
        with mx.name.NameManager():
            out.append(_net(mx, prefix))
    return out


def _weights(sym, rng):
    shapes, _, _ = sym.infer_shape(data=(4, 6))
    return {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _nd(mx, ctx, d):
    return {k: mx.nd.array(v, ctx=ctx) for k, v in d.items()}


def _out(res):
    return np.asarray(res[0].asnumpy() if hasattr(res[0], "asnumpy")
                      else res[0])


def test_version_routing_and_default_alias():
    rng = np.random.RandomState(2)
    syms = _syms("ver")
    p1, p2 = _weights(syms[0], rng), _weights(syms[0], rng)
    x = rng.normal(0, 1, (2, 6)).astype(np.float32)
    answers = []
    for (mx, server, _, _, ctx), sym in zip(PKGS, syms):
        srv = server()
        try:
            for v, p in ((1, p1), (2, p2)):
                srv.register("ver", sym, _nd(mx, ctx, p), version=v,
                             ctx=ctx, buckets=(4,), async_worker=False)
            assert srv.models() == ["ver"] and srv.versions("ver") == [1, 2]
            assert srv.default_version("ver") == 1
            got = [_out(srv.predict("ver", {"data": x})),
                   _out(srv.predict("ver", {"data": x}, version=2))]
            srv.set_default_version("ver", 2)
            got.append(_out(srv.predict("ver", {"data": x})))
            with pytest.raises(Exception, match="no version"):
                srv.predict("ver", {"data": x}, version=9)
            with pytest.raises(Exception, match="unknown model"):
                srv.predict("nope", {"data": x})
            with pytest.raises(Exception, match="already registered"):
                srv.register("ver", sym, _nd(mx, ctx, p1), version=2,
                             ctx=ctx, async_worker=False)
            srv.unregister("ver", version=2)
            assert srv.versions("ver") == [1]
            assert srv.default_version("ver") == 1
            answers.append(got)
        finally:
            srv.stop()
    (j1, j2, jd), (t1, t2, td) = answers
    assert not np.array_equal(t1, t2)
    np.testing.assert_array_equal(td, t2)
    for got, want in ((t1, j1), (t2, j2), (td, jd)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _chaos_server(server, mx, ctx, sym, p):
    srv = server(breaker_threshold=2, breaker_cooldown_ms=COOLDOWN_MS,
                 hedge_ms=False)
    srv.register("cm", sym, _nd(mx, ctx, p), ctx=ctx, replicas=2,
                 buckets=(4,), async_worker=False,
                 warmup_shapes={"data": (4, 6)})
    return srv


def _drain(srv, rounds=3):
    for _ in range(rounds):
        for rep in (0, 1):
            srv.engine("cm", replica=rep).flush()


def _breakers(srv):
    return [r["breaker"]["state"]
            for r in srv.stats()["cm"]["versions"]["1"]]


def test_breaker_opens_probes_and_closes_like_reference():
    rng = np.random.RandomState(1)
    syms = _syms("cm")
    p = _weights(syms[0], rng)
    x = rng.normal(0, 1, (1, 6)).astype(np.float32)
    trails, outs = [], []
    for (mx, server, faults, _, ctx), sym in zip(PKGS, syms):
        srv = _chaos_server(server, mx, ctx, sym, p)
        trail = []
        try:
            futs = [srv.predict_async("cm", {"data": x}) for _ in range(4)]
            _drain(srv)
            trail.append(_breakers(srv))
            faults.configure(
                "serving.dispatch:replica=0:mode=async:raise=OSError,sick")
            futs += [srv.predict_async("cm", {"data": x})
                     for _ in range(12)]
            _drain(srv)
            trail.append(_breakers(srv))
            time.sleep(PAST_COOLDOWN)      # the cooldown passes; still sick
            futs += [srv.predict_async("cm", {"data": x})
                     for _ in range(4)]
            _drain(srv)
            trail.append(_breakers(srv))
            faults.reset()                 # the replica heals
            time.sleep(PAST_COOLDOWN)
            futs += [srv.predict_async("cm", {"data": x})
                     for _ in range(12)]
            _drain(srv)
            trail.append(_breakers(srv))
            assert all(f.done() and f.error is None for f in futs)
            c = srv.stats()["cm"]["counters"]
            assert c["submitted"] == c["served"] == 32 and c["failed"] == 0
            assert c["breaker_opens"] == 2 and c["dispatch_retries"] >= 3
            trails.append(trail)
            outs.append(np.asarray(futs[-1].result_wait(WAIT)[0]))
        finally:
            faults.reset()
            srv.stop()
    assert trails[1] == trails[0] == [
        ["closed", "closed"], ["open", "closed"], ["open", "closed"],
        ["closed", "closed"]]
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def test_rollover_builds_nothing_and_serves_the_new_weights():
    rng = np.random.RandomState(3)
    syms = _syms("ro")
    p1, p2 = _weights(syms[0], rng), _weights(syms[0], rng)
    x = rng.normal(0, 1, (3, 6)).astype(np.float32)
    got = []
    for (mx, server, _, _, ctx), sym in zip(PKGS, syms):
        srv = server()
        try:
            srv.register("ro", sym, _nd(mx, ctx, p1), ctx=ctx, replicas=2,
                         buckets=(4,), async_worker=False,
                         warmup_shapes={"data": (4, 6)})
            before = [srv.engine("ro", replica=r).compiles for r in (0, 1)]
            old = _out(srv.predict("ro", {"data": x}))
            assert srv.rollover("ro", _nd(mx, ctx, p2), version=2) == 2
            assert srv.versions("ro") == [2]
            assert srv.default_version("ro") == 2
            assert [srv.engine("ro", replica=r).compiles
                    for r in (0, 1)] == before == [1, 1]
            new = [_out(srv.predict("ro", {"data": x})) for _ in range(2)]
            np.testing.assert_array_equal(new[0], new[1])
            assert not np.allclose(new[0], old)
            got.append((old, new[0]))
        finally:
            srv.stop()
    for a, b in zip(got[1], got[0]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


class _StubDecode:
    """A decode replica that records what reached it."""

    def __init__(self, idx, load):
        self.idx, self.load, self.seen = idx, load, []

    def submit(self, tokens, **kw):
        self.seen.append(list(tokens))
        return self.idx

    def stats(self):
        return {"active": self.load, "waiting": 0}

    def stop(self):
        pass


def test_submit_decode_pins_like_the_reference():
    pins = list(range(25)) + ["req-%d" % i for i in range(25)]
    picks = []
    for _, server, *_ in PKGS:
        srv = server(hedge_ms=False)
        for i, load in enumerate((3, 1, 2)):
            srv.register_decode("lm", _StubDecode(i, load))
        picks.append([srv.submit_decode("lm", [1, 2], pin=p) for p in pins]
                     + [srv.submit_decode("lm", [3])])
        assert srv.decode_models() == ["lm"]
        srv.unregister_decode("lm")
        with pytest.raises(Exception, match="unknown decode model"):
            srv.submit_decode("lm", [1])
        srv.stop()
    assert picks[1] == picks[0]
    assert set(picks[1][:-1]) == {0, 1, 2} and picks[1][-1] == 1


def test_submit_decode_stream_equals_the_engine_alone():
    srv = TServer(hedge_ms=False)
    engines = [DecodeEngine(tiny_lm_params(seed=s), name="lm%d" % s,
                            device="cpu", batch_size=2, num_blocks=32,
                            block_size=8, max_seq_len=64)
               for s in (0, 0)]
    try:
        for eng in engines:
            srv.register_decode("lm", eng)
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        stream = srv.submit_decode("lm", prompt, pin="seq-7",
                                   max_new_tokens=6)
        got = stream.result_wait(WAIT)
        import zlib
        pinned = engines[zlib.crc32(b"seq-7") % 2]
        other = engines[1 - zlib.crc32(b"seq-7") % 2]
        # an engine counts a stream just after resolving it
        deadline = time.monotonic() + WAIT
        while pinned.stats()["served"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pinned.stats()["served"] == 1 and \
            other.stats()["served"] == 0
        assert got == other.generate(prompt, max_new_tokens=6,
                                     timeout=WAIT)
        st = srv.decode_stats()["lm"]
        assert len(st) == 2 and {"served", "kv", "programs"} <= set(st[0])
    finally:
        srv.stop()


def test_impossible_deadlines_shed_and_are_counted():
    rng = np.random.RandomState(4)
    syms = _syms("sh")
    p = _weights(syms[0], rng)
    x = rng.normal(0, 1, (1, 6)).astype(np.float32)
    counters = []
    for (mx, server, _, deadline, ctx), sym in zip(PKGS, syms):
        srv = server(hedge_ms=False)
        try:
            srv.register("sh", sym, _nd(mx, ctx, p), ctx=ctx, buckets=(4,),
                         async_worker=False)
            ok = srv.predict_async("sh", {"data": x})
            late = [srv.predict_async("sh", {"data": x}, deadline_ms=5.0)
                    for _ in range(3)]
            time.sleep(0.02)
            srv.engine("sh").flush()
            assert ok.result_wait(WAIT)[0].shape == (1, 3)
            for f in late:
                with pytest.raises(deadline):
                    f.result_wait(WAIT)
            counters.append(srv.stats()["sh"]["counters"])
        finally:
            srv.stop()
    assert counters[1] == counters[0]
    assert counters[1]["shed"] == 3 and counters[1]["served"] == 1


def test_stats_keys_match_reference_and_reload_raises():
    rng = np.random.RandomState(5)
    syms = _syms("st")
    p = _weights(syms[0], rng)
    x = rng.normal(0, 1, (2, 6)).astype(np.float32)
    stats = []
    for (mx, server, _, _, ctx), sym in zip(PKGS, syms):
        srv = server(hedge_ms=False)
        try:
            srv.register("st", sym, _nd(mx, ctx, p), ctx=ctx, buckets=(4,),
                         async_worker=False)
            f = srv.predict_async("st", {"data": x})
            srv.engine("st").flush()
            f.result_wait(WAIT)
            srv.predict("st", {"data": x})
            stats.append(srv.stats()["st"])
        finally:
            srv.stop()
    want, got = stats
    assert set(got) == set(want)
    assert got["counters"] == want["counters"]
    assert set(got["latency"]) == set(want["latency"])
    rep_got, rep_want = got["versions"]["1"][0], want["versions"]["1"][0]
    assert set(rep_got) - set(rep_want) == {"captures"}
    assert set(rep_want) <= set(rep_got)
    assert {k: rep_got[k] for k in ("compiles", "hits", "misses", "served",
                                    "batches_run")} == \
        {k: rep_want[k] for k in ("compiles", "hits", "misses", "served",
                                  "batches_run")}
    for server_cls in (JServer, TServer):
        assert server_cls().reload_from("st", "/nonexistent") is None


def test_hedge_duplicates_a_straggler_onto_the_other_replica():
    """With ``hedge_ms`` a request still unanswered after the delay runs
    again on the other replica; the first answer wins, and the accounting
    counts each request once."""
    rng = np.random.RandomState(6)
    sym = _syms("hd")[1]
    p = _weights(sym, rng)
    x = rng.normal(0, 1, (1, 6)).astype(np.float32)
    srv = TServer(hedge_ms=20.0)
    try:
        srv.register("hd", sym, _nd(tmx, tmx.cpu(), p), ctx=tmx.cpu(),
                     replicas=2, buckets=(4,), max_delay_ms=0.0,
                     warmup_shapes={"data": (4, 6)})
        want = _out(srv.predict("hd", {"data": x}))
        tfaults.configure("serving.dispatch:replica=0:mode=async:delay=500")
        futs = [srv.predict_async("hd", {"data": x}) for _ in range(4)]
        for f in futs:
            np.testing.assert_array_equal(np.asarray(f.result_wait(WAIT)[0]),
                                          want)
        c = srv.stats()["hd"]["counters"]
        assert c["hedges"] >= 1 and c["hedge_wins"] >= 1
        assert c["submitted"] == c["served"] == 5 and c["failed"] == 0
    finally:
        tfaults.reset()
        srv.stop()
