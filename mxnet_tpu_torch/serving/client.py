"""ServingClient — the cross-process caller of a ServingFrontDoor.

Counterpart of ``mxnet_tpu/serving/client.py``; it talks to a port
gateway or a reference one. The cheap half of the serving split
(arXiv:1605.08695's client/master asymmetry; `serving/frontdoor.py`
documents the wire protocol): a client process holds a small pool of
TCP connections, ships request batches as length-prefixed frames, and
gets back typed outcomes — served outputs (numpy arrays; bfloat16 as a
CPU tensor), the typed `DeadlineExceeded` for sheds, or a failure
message. Request arrays may be numpy arrays, NDArrays or torch tensors
on any device: they travel as their host values.

Retry semantics (the port's `resilience.RetryPolicy`, mirroring the
dist_async push-never-retries split):

* **connect** retries under the unified exponential-backoff policy
  (``site="frontdoor.connect"``) — the gateway may still be binding when
  clients start;
* a request whose send FAILED is safe to resubmit on a fresh connection:
  `sendall` raised, so the server saw at most a partial frame and
  discarded it (`wire.FrameError`) — the request was never admitted;
* a request whose bytes were FULLY sent is **never blindly retried** —
  the server may have admitted (and even served) the original. After a
  reconnect the client sends ``("resolve", ...)`` with the
  server-assigned request ids: a retained outcome resolves the future
  with the REAL result, ``unknown`` proves the request was never
  admitted (safe to resubmit), ``pending`` waits and asks again.
  Exactly-once by construction, like the kvstore's idempotent-pull-only
  retry.

Deadline propagation: ``deadline_ms`` is tracked against the CLIENT's
clock from submit; each (re)send ships only the REMAINING budget plus
the send wall-clock, and the server subtracts the measured transfer —
so queue wait at the gateway accrues against the true end-to-end budget
no matter how many resubmits happened. Every request carries a trace id
(caller-supplied or generated) that comes back in the reply's timing
breakdown (``wire_ms``/``queue_ms``/``device_ms``/``total_ms``).

Streaming decode generalizes exactly-once to STREAMS: a
``decode`` request answers with incremental ``("stok", rid, seq_no,
token)`` frames and one terminal ``("sdone", rid, outcome, info)``.
On a connection loss the resolve protocol answers ``("stream", hwm,
terminal)`` for a stream id; the client re-attaches by ORIGINAL rid
with ``("sresume", ..., {"rid", "have"})`` and the gateway replays
exactly the frames past ``have`` — contiguous-seq_no dedup on this
side makes the hand-off lose and duplicate nothing.

    client = ServingClient("127.0.0.1", port)
    out = client.predict({"data": batch}, model="resnet")
    fut = client.predict_async({"data": rows}, model="resnet",
                               deadline_ms=25, priority=1)
    rows_out = fut.result_wait(1.0)     # raises DeadlineExceeded on shed
    for tok in client.decode_async([1, 2, 3], model="lm"):
        ...                             # tokens as they generate
    client.health()                     # the autoscaling signal
    client.close()
"""
from __future__ import annotations

import socket
import threading
import time
import uuid

import numpy as _np
import torch

from ..base import MXNetError, get_env
from ..resilience.retry import RetryPolicy
from . import wire as _wire
from .batcher import DeadlineExceeded
from .codec import host_value
from .frontdoor import DEFAULT_PORT

__all__ = ["ServingClient", "ClientRequest", "ClientStream"]


def _host_array(value):
    """One request array as the wire carries it: a host numpy array (a
    bfloat16 tensor stays a CPU tensor)."""
    value = host_value(value)
    return value if isinstance(value, torch.Tensor) else _np.asarray(value)


class ClientRequest:
    """Future-like handle with the same surface as the in-process
    request objects (``done()`` / ``result_wait(timeout)`` /
    ``add_done_callback(fn)``), plus the reply's server-side timing
    breakdown under ``timings`` and the request's ``trace`` id."""

    __slots__ = ("rid", "trace", "model", "result", "error", "timings",
                 "resubmits", "_event", "_cb_lock", "_callbacks",
                 "_deadline", "_priority", "_version", "_arrays",
                 "_send_wall", "_t_submit", "_t_done")

    def __init__(self, rid, trace, model, version, arrays, deadline,
                 priority):
        self.rid = rid
        self.trace = trace
        self.model = model
        self.result = None
        self.error = None
        self.timings = None
        self.resubmits = 0
        self._event = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks = []
        self._deadline = deadline      # absolute monotonic or None
        self._priority = priority
        self._version = version
        self._arrays = arrays
        self._send_wall = None
        self._t_submit = time.monotonic()
        self._t_done = None

    # latency surface, mirroring the in-process request objects so a
    # RemoteReplica's inner future decomposes the same way at the
    # gateway (serving/pool.py): t_dispatch is back-derived from the
    # server-reported device time — everything before the worker's
    # device slot (client queueing, wire, worker queue) counts as queue
    @property
    def t_submit(self):
        return self._t_submit

    @property
    def t_done(self):
        return self._t_done

    @property
    def t_dispatch(self):
        if self._t_done is None:
            return None
        device_ms = (self.timings or {}).get("device_ms")
        if device_ms is None:
            return None
        return self._t_done - device_ms / 1e3

    # -- future surface ------------------------------------------------
    def done(self):
        return self._event.is_set()

    def result_wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise MXNetError("inference request timed out")
        if self.error is not None:
            raise self.error
        return self.result

    def add_done_callback(self, fn):
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, result=None, error=None, timings=None):
        with self._cb_lock:
            if self._event.is_set():
                return              # exactly-once: a late resolve is a no-op
            self.result = result
            self.error = error
            self.timings = timings
            self._t_done = time.monotonic()
            self._arrays = None     # no resubmit after resolution: release
            #                         the request payload (bench loops hold
            #                         thousands of futures)
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass  # an observer must never poison the delivery path

    def _remaining_ms(self):
        if self._deadline is None:
            return None
        return (self._deadline - time.monotonic()) * 1000.0

    def _spec(self):
        """The wire payload for one (re)send: remaining budget + fresh
        send wall-clock, so every attempt propagates the TRUE budget."""
        self._send_wall = time.time()
        return {"model": self.model, "version": self._version,
                "arrays": self._arrays, "deadline_ms": self._remaining_ms(),
                "priority": self._priority, "trace": self.trace,
                "t_send": self._send_wall}


class ClientStream(ClientRequest):
    """Streaming decode handle: tokens arrive incrementally under
    ``tokens`` (and via the optional ``on_token(stream, seq_no, token)``
    callback, or by iterating the stream); the terminal outcome lands
    through the same future surface as :class:`ClientRequest` —
    ``result_wait`` returns the full token list, raises the typed
    `DeadlineExceeded` on a shed (including a mid-generation one).

    Exactly-once over streams: every token frame carries ``(rid,
    seq_no)`` and the client only appends the next contiguous seq_no —
    duplicates from a resume replay are dropped here, and the terminal
    frame's token count is cross-checked so a gap becomes a TYPED
    failure, never silent loss."""

    __slots__ = ("tokens", "_max_new", "_on_token", "_tok_cv")

    def __init__(self, rid, trace, model, prompt, deadline, priority,
                 max_new_tokens=None, on_token=None):
        # prompt tokens are host ints, normalized once at submission
        flat = _np.asarray(host_value(prompt)).reshape(-1)
        super().__init__(rid, trace, model, None,
                         [int(t) for t in flat], deadline, priority)
        self.tokens = []
        self._max_new = max_new_tokens
        self._on_token = on_token
        self._tok_cv = threading.Condition()

    def _spec(self):
        self._send_wall = time.time()
        return {"model": self.model, "tokens": self._arrays,
                "max_new_tokens": self._max_new,
                "deadline_ms": self._remaining_ms(),
                "priority": self._priority, "trace": self.trace,
                "t_send": self._send_wall}

    def _token(self, seq_no, token):
        """One ``("stok", rid, seq_no, token)`` frame (reader thread).
        seq_no is 1-based and appended only when contiguous."""
        seq_no = int(seq_no)
        cb = None
        with self._tok_cv:
            if seq_no != len(self.tokens) + 1:
                return      # duplicate (resume replay overlap) — or a
                #             gap, which the terminal count-check below
                #             converts into a typed failure
            self.tokens.append(int(token))
            self._tok_cv.notify_all()
            cb = self._on_token
        if cb is not None:
            try:
                cb(self, seq_no, int(token))
            except Exception:
                pass  # an observer must never poison token delivery

    def _finish_served(self, info):
        """Terminal ``served``: cross-check the server's token count
        against what was delivered before declaring success."""
        info = info if isinstance(info, dict) else {}
        expect = info.get("tokens")
        with self._tok_cv:
            have = len(self.tokens)
        if expect is not None and int(expect) != have:
            self._resolve(error=MXNetError(
                "stream %s terminal reports %s tokens but %d were "
                "delivered — frames lost despite resume" %
                (self.rid, expect, have)))
        else:
            self._resolve(result=list(self.tokens), timings=info)

    def _resolve(self, result=None, error=None, timings=None):
        super()._resolve(result=result, error=error, timings=timings)
        with self._tok_cv:
            self._tok_cv.notify_all()   # wake iterators on any terminal

    def __iter__(self):
        """Yield tokens as they arrive; ends at the terminal frame.
        A shed/failed terminal ends iteration silently — call
        ``result_wait(0)`` afterwards for the typed outcome."""
        i = 0
        while True:
            with self._tok_cv:
                while i >= len(self.tokens) and not self._event.is_set():
                    self._tok_cv.wait(0.2)
                if i < len(self.tokens):
                    tok = self.tokens[i]
                elif self._event.is_set():
                    return
                else:
                    continue
            yield tok
            i += 1


class _ClientConn:
    """One pooled connection: socket + reply-demultiplexing reader."""

    __slots__ = ("client", "sock", "conn_id", "seq", "send_lock",
                 "pending", "pending_lock", "alive", "reader", "stop_evt",
                 "codec", "hb")

    def __init__(self, client, sock, conn_id, codec=_wire.CODEC_PICKLE):
        self.client = client
        self.sock = sock
        self.conn_id = conn_id
        self.codec = codec          # negotiated on THIS connection
        self.seq = 0
        self.send_lock = threading.Lock()
        self.pending = {}       # rid -> ClientRequest (or control future)
        self.pending_lock = threading.Lock()
        self.alive = True
        self.stop_evt = threading.Event()
        self.reader = threading.Thread(target=self._read_loop,
                                       name="mx-serving-client-read",
                                       daemon=True)
        # watchdog supervision: the reader mostly idles in recv
        # (exempt from stall judgment); a death without running its
        # transport-loss recovery IS a watchdog death worth a counter
        from ..resilience.watchdog import watchdog as _watchdog
        self.hb = _watchdog().register("mx-serving-client-read",
                                       thread=self.reader)
        self.reader.start()

    def next_rid(self):
        with self.send_lock:
            self.seq += 1
            return "c%d-%d" % (self.conn_id, self.seq)

    def inflight(self):
        with self.pending_lock:
            return len(self.pending)

    def send(self, frame):
        """One frame out; raises on transport failure (the caller owns
        the resubmit-vs-resolve decision)."""
        with self.send_lock:
            _wire.send_msg(self.sock, frame,
                           auth_key=self.client._auth_key,
                           codec=self.codec,
                           limits=self.client._codec_limits)

    def register(self, rid, fut):
        with self.pending_lock:
            self.pending[rid] = fut

    def unregister(self, rid):
        with self.pending_lock:
            return self.pending.pop(rid, None)

    # shutdown THEN close: a bare close() on a socket another thread is
    # blocked in recv() on neither wakes that thread nor promptly FINs
    # the peer — one shared definition in wire.teardown
    _teardown = staticmethod(_wire.teardown)

    def close(self):
        self.alive = False
        self.stop_evt.set()
        self._teardown(self.sock)

    def break_transport(self):
        """Mark the transport dead WITHOUT setting stop_evt — the
        difference matters: ``close()`` is the user's shutdown and
        suppresses recovery, while a broken transport must let the
        reader wake (shutdown raises EOF under its recv), see a
        transport death, and run the client's resolve-by-id recovery
        for every OTHER request still pending on this connection."""
        self.alive = False
        self._teardown(self.sock)

    # ------------------------------------------------------------------
    def _read_loop(self):
        while not self.stop_evt.is_set():
            self.hb.idle()  # blocked in recv = waiting for work
            try:
                # tick-aware: an idle-timeout before any frame byte just
                # re-checks stop_evt; a timeout INSIDE a frame is a
                # stalled-peer FrameError, never a silent desync. A
                # safe-negotiated connection refuses pickle replies —
                # the client never unpickles gateway bytes either.
                msg = _wire.recv_msg_tick(
                    self.sock, auth_key=self.client._auth_key,
                    allow_pickle=self.codec == _wire.CODEC_PICKLE,
                    limits=self.client._codec_limits)
            except (_wire.FrameError, OSError):
                msg = None
            if msg is _wire.TICK:
                continue
            if msg is None:
                break
            self.hb.beat()
            self._dispatch(msg)
        self.hb.close()  # loop exit (close or transport death) is an
        # outcome the recovery below handles — not a silent watchdog death
        if not self.stop_evt.is_set():     # transport death, not close()
            self.alive = False
            with self.pending_lock:
                lost = dict(self.pending)
                self.pending.clear()
            if lost:
                self.client._recover(self, lost)

    def _dispatch(self, msg):
        verb = msg[0]
        rid = msg[1] if len(msg) > 1 else None
        if verb == "stok":
            # incremental token frame: the stream STAYS registered (the
            # terminal sdone pops it) — get, not pop
            with self.pending_lock:
                fut = self.pending.get(rid)
            if fut is not None:
                fut._token(msg[2], msg[3])
            return
        fut = self.unregister(rid)
        if fut is None:
            return                  # late reply for an already-failed-over rid
        if verb == "sdone":
            outcome = msg[2]
            info = msg[3] if len(msg) > 3 else None
            if outcome == "served" and isinstance(fut, ClientStream):
                fut._finish_served(info)
            elif outcome == "shed":
                fut._resolve(error=DeadlineExceeded(str(info)))
            else:
                fut._resolve(error=MXNetError(str(info)))
        elif verb == "served":
            fut._resolve(result=msg[2], timings=msg[3])
        elif verb == "shed":
            fut._resolve(error=DeadlineExceeded(msg[2]))
        elif verb == "failed":
            fut._resolve(error=MXNetError(msg[2]))
        elif verb in ("resolved", "health", "models", "pong"):
            fut._resolve(result=msg[2] if len(msg) > 2 else None)
        else:
            fut._resolve(error=MXNetError("unknown reply verb %r"
                                          % (verb,)))


class _ControlFuture:
    """Minimal future for control round-trips (resolve/health/...)."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None

    def _resolve(self, result=None, error=None, timings=None):
        self.result = result
        self.error = error
        self.event.set()

    def wait(self, timeout):
        if not self.event.wait(timeout):
            raise MXNetError("front door control round-trip timed out")
        if self.error is not None:
            raise self.error
        return self.result


class ServingClient:
    """Pooled-connection client of a :class:`ServingFrontDoor`.

    Parameters
    ----------
    host, port : gateway address (port defaults to
        ``MXNET_SERVING_PORT``).
    pool_size : int
        Connections to spread concurrent requests over (default 1;
        submissions pick the least-loaded live connection).
    connect_deadline_s : float
        Wall-clock budget for establishing (or re-establishing) one
        connection under the retry policy.
    resubmits : int
        How many times one request may be RE-submitted after a
        transport failure (applies to the never-admitted cases: failed
        sends and ``unknown`` resolve outcomes; an admitted request is
        resolved, never resubmitted).
    auth_key : str or bytes, optional
        Shared HMAC frame-auth key (default: ``MXNET_SERVING_AUTH_KEY``,
        read once here). Must match the front door's key — the server
        rejects unauthenticated frames before unpickling, and this
        client rejects unauthenticated replies the same way.
    """

    def __init__(self, host="127.0.0.1", port=None, pool_size=1,
                 connect_deadline_s=30.0, resubmits=2, auth_key=None,
                 wire_mode=None):
        self._auth_key = _wire.normalize_auth_key(auth_key)
        # wire codec, read ONCE (zero-overhead contract).
        # "safe" (default): send a proto-2 hello, skip the gateway's
        # legacy pickle bootstrap UNDECODED, and require a safe
        # hello_ack — this client never unpickles network bytes.
        # "pickle": the previous protocol byte-for-byte (what a v-old
        # client is; also the escape hatch against a v-old gateway).
        self._wire_mode = _wire.resolve_wire_mode(wire_mode)
        from . import codec as _codec
        self._codec_limits = _codec.Limits()
        self._host = host
        self._port = int(port) if port is not None else int(get_env(
            "MXNET_SERVING_PORT", DEFAULT_PORT, int))
        self._pool_size = max(1, int(pool_size))
        self._resubmits = max(0, int(resubmits))
        self._connect_retry = RetryPolicy(
            attempts=1000, base_delay_s=0.05, cap_delay_s=0.5,
            deadline_s=float(connect_deadline_s), retryable=OSError,
            site="frontdoor.connect")
        self._lock = threading.Lock()
        self._pool = []
        self._closed = False
        self.stats = {"submitted": 0, "resubmits": 0, "resolved_remote": 0,
                      "recovered_unknown": 0, "failovers": 0,
                      "stream_resumes": 0}

    # ------------------------------------------------------------------
    # connections
    # ------------------------------------------------------------------
    def _connect(self):
        sock = self._connect_retry.call(
            socket.create_connection, (self._host, self._port),
            timeout=300.0)
        try:
            if self._wire_mode == _wire.CODEC_PICKLE:
                conn_id, codec = self._handshake_legacy(sock)
            else:
                conn_id, codec = self._handshake_safe(sock)
        except BaseException:
            _wire.teardown(sock)
            raise
        return _ClientConn(self, sock, conn_id, codec=codec)

    def _handshake_legacy(self, sock):
        """Protocol 1, byte-for-byte: read the pickle hello, speak
        pickle. What a previous-version client does — kept as the
        explicit escape hatch (``MXNET_SERVING_WIRE=pickle``) and as
        the rolling-upgrade test double."""
        hello = _wire.recv_msg(sock, auth_key=self._auth_key)
        if not (isinstance(hello, tuple) and hello
                and hello[0] == "hello"):
            raise MXNetError("front door handshake failed: expected "
                             "hello, got %r" % (hello,))
        return int(hello[1]), _wire.CODEC_PICKLE

    def _handshake_safe(self, sock):
        """Protocol 2: offer (protos, codecs) in a safe-codec hello and
        adopt the gateway's pick from the hello_ack. The gateway's
        legacy bootstrap hello (pickle, sent first for v-old clients)
        is SKIPPED by magic-sniff without ever being unpickled; the
        hello_ack re-states the conn id. Unknown ack keys are ignored
        (forward compat)."""
        _wire.send_msg(
            sock, ("hello", {"protos": list(_wire.SUPPORTED_PROTOS),
                             "codecs": [_wire.CODEC_SAFE],
                             "lib": "mxnet_tpu_torch"}),
            auth_key=self._auth_key, codec=_wire.CODEC_SAFE,
            limits=self._codec_limits)
        prev_timeout = sock.gettimeout()
        sock.settimeout(min(10.0, self._connect_retry.deadline_s or 10.0))
        try:
            for _ in range(4):          # bounded pre-ack frame skip
                try:
                    payload = _wire.recv_payload(sock,
                                                 auth_key=self._auth_key)
                except socket.timeout:
                    raise MXNetError(
                        "gateway did not answer the safe-wire handshake "
                        "— previous-protocol gateway? (set "
                        "MXNET_SERVING_WIRE=pickle to speak proto 1)")
                if payload is None:
                    raise MXNetError("gateway hung up during the "
                                     "safe-wire handshake")
                from . import codec as _codec
                if not _codec.sniff(payload):
                    continue            # the legacy bootstrap hello: skip
                msg = _codec.decode(payload, self._codec_limits)
                break
            else:
                raise MXNetError("no hello_ack within the handshake "
                                 "frame budget")
        finally:
            sock.settimeout(prev_timeout)
        if isinstance(msg, tuple) and msg and msg[0] == "hello_reject":
            raise MXNetError("gateway refused the wire handshake: %s"
                             % (msg[2] if len(msg) > 2 else msg,))
        if not (isinstance(msg, tuple) and len(msg) >= 3
                and msg[0] == "hello_ack"):
            raise MXNetError("front door handshake failed: expected "
                             "hello_ack, got %r" % (msg,))
        info = msg[2] if isinstance(msg[2], dict) else {}
        codec = str(info.get("codec") or _wire.CODEC_SAFE)
        return int(msg[1]), codec

    def _acquire(self):
        """Least-loaded live pooled connection, growing the pool lazily
        up to ``pool_size``; dead connections are replaced."""
        with self._lock:
            if self._closed:
                raise MXNetError("ServingClient is closed")
            self._pool = [c for c in self._pool if c.alive]
            if len(self._pool) < self._pool_size:
                grow = True
            else:
                grow = False
                conn = min(self._pool, key=_ClientConn.inflight)
        if grow:
            conn = self._connect()
            with self._lock:
                if self._closed:
                    conn.close()
                    raise MXNetError("ServingClient is closed")
                self._pool = [c for c in self._pool if c.alive]
                if len(self._pool) >= self._pool_size:
                    # lost the grow race to a concurrent submitter: the
                    # pool is full again — keep the documented cap, use
                    # a pooled connection instead of the fresh one
                    pooled = min(self._pool, key=_ClientConn.inflight)
                    conn.close()
                    conn = pooled
                else:
                    self._pool.append(conn)
        return conn

    def close(self):
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()

    def fail_over(self):
        """Break every pooled connection's TRANSPORT without closing the
        client: each reader wakes, sees a transport death, and runs the
        resolve-by-id recovery for its in-flight requests — exactly what
        a fleet gateway needs when it declares a worker DEAD on missed
        heartbeats while the dispatch sockets still look alive (a wedged
        process ACKs TCP long after it stopped serving). New submissions
        reconnect through the normal pool path."""
        with self._lock:
            pool = list(self._pool)
        for conn in pool:
            conn.break_transport()

    # ------------------------------------------------------------------
    # predict
    # ------------------------------------------------------------------
    @staticmethod
    def _normalize(data):
        """Host arrays for the wire — a dict, a single array, or a
        positional list (the gateway's engine maps names). Tensors and
        NDArrays travel as their host values (`codec.host_value`)."""
        if isinstance(data, dict):
            return {k: _host_array(v) for k, v in data.items()}
        if isinstance(data, (list, tuple)):
            return [_host_array(v) for v in data]
        return _host_array(data)

    def predict_async(self, data, model, version=None, deadline_ms=None,
                      priority=0, trace_id=None):
        """Ship one request; returns a :class:`ClientRequest` future.
        ``deadline_ms`` is the END-TO-END budget from this call: wire
        transfer, gateway queue wait and device time all accrue against
        it (a shed comes back as the typed `DeadlineExceeded`)."""
        deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1000.0
        trace = trace_id or uuid.uuid4().hex[:12]
        req = ClientRequest(None, trace, model, version,
                            self._normalize(data), deadline, int(priority))
        self.stats["submitted"] += 1
        self._submit(req)
        return req

    def predict(self, data, model, version=None, deadline_ms=None,
                priority=0, timeout=None, trace_id=None):
        """Synchronous predict over the wire; returns the output list."""
        return self.predict_async(data, model, version=version,
                                  deadline_ms=deadline_ms,
                                  priority=priority,
                                  trace_id=trace_id).result_wait(timeout)

    # ------------------------------------------------------------------
    # stateful decode (streaming)
    # ------------------------------------------------------------------
    def decode_async(self, tokens, model, max_new_tokens=None,
                     deadline_ms=None, priority=0, trace_id=None,
                     on_token=None):
        """Submit one prompt for streaming decode; returns a
        :class:`ClientStream`. Tokens arrive incrementally (iterate the
        stream, watch ``stream.tokens``, or pass ``on_token``);
        ``result_wait`` blocks for the terminal outcome and returns the
        full generated token list. ``deadline_ms`` is the end-to-end
        budget for the WHOLE generation — a sequence that runs past it
        is shed mid-stream with the tokens so far retained."""
        deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1000.0
        trace = trace_id or uuid.uuid4().hex[:12]
        stream = ClientStream(None, trace, model, tokens, deadline,
                              int(priority), max_new_tokens=max_new_tokens,
                              on_token=on_token)
        self.stats["submitted"] += 1
        self._submit(stream)
        return stream

    def decode(self, tokens, model, max_new_tokens=None, deadline_ms=None,
               priority=0, timeout=None, trace_id=None):
        """Synchronous decode over the wire; returns the token list."""
        return self.decode_async(tokens, model,
                                 max_new_tokens=max_new_tokens,
                                 deadline_ms=deadline_ms, priority=priority,
                                 trace_id=trace_id).result_wait(timeout)

    def _resume_stream(self, stream):
        """Re-attach a live stream after a connection loss: register the
        ORIGINAL rid on a fresh connection and ask the gateway to replay
        everything past our high-water mark. The gateway's frame history
        plus our contiguous-seq_no dedup make the hand-off exactly-once
        in both directions."""
        attempts = 0
        while True:
            if stream.done():
                return
            try:
                conn = self._acquire()
            except BaseException as e:
                stream._resolve(error=e if isinstance(e, Exception)
                                else MXNetError(str(e)))
                if not isinstance(e, Exception):
                    raise
                return
            conn.register(stream.rid, stream)
            with stream._tok_cv:
                have = len(stream.tokens)
            try:
                conn.send(("sresume", conn.next_rid(),
                           {"rid": stream.rid, "have": have}))
                self.stats["stream_resumes"] += 1
                return
            except OSError as e:
                conn.unregister(stream.rid)
                conn.break_transport()
                attempts += 1
                if attempts > self._resubmits:
                    stream._resolve(error=MXNetError(
                        "stream resume failed after %d attempts: %s"
                        % (attempts, e)))
                    return

    def _submit(self, req):
        """(Re)send one request. Failed SENDS resubmit on a fresh
        connection (never admitted); a fully-sent request is owned by
        the resolve protocol from here on."""
        attempts = 0
        while True:
            rem = req._remaining_ms()
            if rem is not None and rem <= 0.0:
                req._resolve(error=DeadlineExceeded(
                    "request shed client-side: deadline budget consumed "
                    "before a send succeeded"))
                return
            try:
                conn = self._acquire()
            except BaseException as e:
                req._resolve(error=e if isinstance(e, Exception)
                             else MXNetError(str(e)))
                if not isinstance(e, Exception):
                    raise
                return
            rid = conn.next_rid()
            req.rid = rid
            conn.register(rid, req)
            verb = "decode" if isinstance(req, ClientStream) else "predict"
            try:
                conn.send((verb, rid, req._spec()))
                return
            except OSError as e:
                # sendall raised: at most a partial frame reached the
                # server and was discarded as a FrameError — never
                # admitted, safe to resubmit. break_transport (NOT
                # close) so the reader still runs recovery for the
                # OTHER requests pending on this connection.
                conn.unregister(rid)
                conn.break_transport()
                attempts += 1
                if attempts > self._resubmits:
                    req._resolve(error=MXNetError(
                        "front door send failed after %d attempts: %s"
                        % (attempts, e)))
                    return
                req.resubmits += 1
                self.stats["resubmits"] += 1

    # ------------------------------------------------------------------
    # transport-death recovery (reader thread)
    # ------------------------------------------------------------------
    def _recover(self, dead_conn, lost):
        """The connection died with fully-sent requests outstanding.
        NOT blindly retried: ask the server what became of each id;
        only proven-unknown requests resubmit."""
        self.stats["failovers"] += 1
        with self._lock:
            closed = self._closed
        control = dict(lost)
        requests = {rid: f for rid, f in control.items()
                    if isinstance(f, ClientRequest)}
        for rid, fut in control.items():
            if not isinstance(fut, ClientRequest):
                fut._resolve(error=MXNetError(
                    "front door connection lost mid-control-round-trip"))
        if not requests:
            return
        if closed:
            for fut in requests.values():
                fut._resolve(error=MXNetError(
                    "client closed with requests in flight"))
            return
        outcomes = {}
        # the resolve budget must outlive any request still LEGALLY in
        # flight: failing a pending request while the server may yet
        # serve it would race its own (orphaned) result. Deadline-less
        # requests get a fixed window; everything is capped so a wedged
        # gateway cannot pin this reader thread forever.
        now = time.monotonic()
        budget = now + 30.0
        for fut in requests.values():
            if fut._deadline is not None:
                budget = max(budget, fut._deadline + 5.0)
        budget = min(budget, now + 300.0)
        attempt = 0
        try:
            while True:
                pending_rids = [r for r in requests if r not in outcomes]
                if not pending_rids:
                    break
                res = self._control("resolve", pending_rids, timeout=10.0)
                still_pending = False
                for rid, outcome in (res or {}).items():
                    if outcome and outcome[0] == "pending":
                        still_pending = True
                    else:
                        outcomes[rid] = outcome
                if not still_pending or time.monotonic() > budget:
                    break
                attempt += 1
                time.sleep(min(0.05 * attempt, 0.5))
        except Exception as e:
            for rid, fut in requests.items():
                if rid not in outcomes:
                    fut._resolve(error=MXNetError(
                        "connection lost and the outcome could not be "
                        "resolved: %s" % e))
        for rid, fut in requests.items():
            outcome = outcomes.get(rid)
            if outcome is None:
                # already failed in the except path above, or the
                # resolve budget expired with the request still pending
                # server-side — resolve TYPED rather than leave the
                # future hanging forever (_resolve is exactly-once, so
                # the already-failed case is a no-op)
                fut._resolve(error=MXNetError(
                    "connection lost; request still pending server-side "
                    "when the resolve budget expired"))
                continue
            verb = outcome[0]
            if verb == "served":
                self.stats["resolved_remote"] += 1
                fut._resolve(result=outcome[2], timings=outcome[3])
            elif verb == "shed":
                self.stats["resolved_remote"] += 1
                fut._resolve(error=DeadlineExceeded(outcome[2]))
            elif verb == "failed":
                self.stats["resolved_remote"] += 1
                fut._resolve(error=MXNetError(outcome[2]))
            elif verb == "stream":
                # the gateway still holds the stream (live or terminal):
                # re-attach by original id — sresume replays every frame
                # past our high-water mark, then the terminal
                self.stats["resolved_remote"] += 1
                self._resume_stream(fut)
            elif verb == "unknown":
                if isinstance(fut, ClientStream) and fut.tokens:
                    # a stream that already delivered tokens can NOT be
                    # resubmitted (a fresh sequence would regenerate
                    # from scratch — duplicate tokens); unknown here
                    # means the gateway's stream TTL expired
                    fut._resolve(error=MXNetError(
                        "connection lost; stream unknown to the server "
                        "with %d tokens already delivered (stream TTL "
                        "expired?)" % len(fut.tokens)))
                    continue
                # proven never-admitted: the one case a fully-sent
                # request may go out again (mirrors push-never-retries:
                # push retries only when the server provably never saw
                # the original)
                if fut.resubmits < self._resubmits:
                    fut.resubmits += 1
                    self.stats["recovered_unknown"] += 1
                    self.stats["resubmits"] += 1
                    self._submit(fut)
                else:
                    fut._resolve(error=MXNetError(
                        "connection lost; request unknown to the server "
                        "and resubmit budget exhausted"))
            else:
                fut._resolve(error=MXNetError(
                    "unresolvable outcome %r" % (verb,)))

    # ------------------------------------------------------------------
    # control verbs
    # ------------------------------------------------------------------
    def _control(self, verb, payload=None, timeout=10.0):
        conn = self._acquire()
        fut = _ControlFuture()
        rid = conn.next_rid()
        conn.register(rid, fut)
        try:
            frame = (verb, rid) if payload is None else (verb, rid, payload)
            conn.send(frame)
        except OSError as e:
            conn.unregister(rid)
            conn.break_transport()
            raise MXNetError("front door %s round-trip failed: %s"
                             % (verb, e)) from e
        return fut.wait(timeout)

    def health(self, timeout=10.0):
        """`ModelServer.health()` over the wire — per-model queue-wait
        p95, shed rate, breaker states, in-flight counts (the
        autoscaling signal; zero-deadline control verb)."""
        return self._control("health", timeout=timeout)

    def list_models(self, timeout=10.0):
        """Registered models/versions/default aliases over the wire."""
        return self._control("list_models", timeout=timeout)

    def ping(self, timeout=10.0):
        self._control("ping", timeout=timeout)
        return True
