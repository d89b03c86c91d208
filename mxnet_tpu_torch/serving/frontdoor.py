"""ServingFrontDoor — the cross-process TCP gateway over a ModelServer.

Counterpart of ``mxnet_tpu/serving/frontdoor.py``, speaking its wire:
a reference client is served by a port gateway and a port client by a
reference one. Without it every request must come from inside the
ModelServer's own Python process. The device-owning process is a
server; clients are cheap, remote, and many (the serving shape of the
TensorFlow distributed runtime, arXiv:1605.08695, and the MXNet
parameter-server design, arXiv:1512.01274). One acceptor thread plus
per-connection reader/writer threads feed the existing SLA batcher: the
gateway adds a network leg, never a second queueing discipline.

Replies carry the engines' outputs, device tensors on the card: each
connection's writer thread copies them to the host
(:func:`~.codec.host_value`) just before it encodes the frame, and a
dead connection's reply is copied before it enters the orphan store;
never under the batcher's, the registry's or the gateway's locks.

Wire protocol (`serving/wire.py` framing):

* server -> client on connect: ``("hello", conn_id)`` — the
  SERVER-assigned connection id that makes every request id
  (``"c<conn_id>-<seq>"``) globally unique without coordination, and the
  handle the resolve protocol keys on after a reconnect.
* ``("predict", rid, spec)`` where ``spec`` carries ``model``,
  ``version``, ``arrays`` (dict name -> np array), ``deadline_ms`` (the
  REMAINING end-to-end budget at client send time), ``priority``,
  ``trace`` (request trace id) and ``t_send`` (client wall clock).
  **Deadline propagation**: the server subtracts the measured transfer
  time (server receive wall clock minus ``t_send``, clamped at 0 for
  clock skew) from the budget before submitting, so queue wait accrues
  against the TRUE end-to-end budget — a request that spent its budget
  on the wire sheds immediately instead of occupying a bucket slot.
  The transfer time records into the always-on latency histograms as
  ``serving.<model>.wire``; together with the batcher's ``.queue`` /
  ``.device`` / ``.total`` keys, per-model tails decompose into network
  vs queue vs device.
* typed responses: ``("served", rid, outputs, timings)`` /
  ``("shed", rid, message)`` (the client re-raises the typed
  `DeadlineExceeded`) / ``("failed", rid, message)``.
* zero-deadline control verbs answered from the reader thread's queue
  position, never the batcher: ``("health", rid)`` ->
  ``("health", rid, ModelServer.health())`` (the autoscaling signal) and
  ``("list_models", rid)`` -> ``("models", rid, payload)``.
* ``("resolve", rid, [rids])`` -> ``("resolved", rid, {rid: outcome})``
  — the exactly-once half of the client's retry story (see
  `serving/client.py`): a request whose bytes were fully sent is never
  blindly retried; after a reconnect the client asks the server what
  became of it. Outcomes: the original typed reply (the request's
  connection died before delivery — the reply is retained in the orphan
  store for ``MXNET_SERVING_FRONTDOOR_ORPHAN_TTL_S``), ``("pending",)``
  (still in flight), or ``("unknown",)`` (never admitted — safe to
  resubmit).
* streaming decode (stateful serving): ``("decode", rid,
  spec)`` where ``spec`` carries ``model``, ``tokens`` (prompt ids),
  ``max_new_tokens``, ``deadline_ms``/``priority``/``trace``/``t_send``
  as for predict. Replies stream: ``("stok", rid, seq_no, token)`` per
  generated token (seq_no 1-based, contiguous) and one terminal
  ``("sdone", rid, outcome, info)`` — outcome ``served`` (info: trace +
  token count), ``shed`` (typed deadline/cache-pressure shed, possibly
  MID-generation), or ``failed``. Exactly-once generalizes to streams:
  the gateway retains every frame of a live stream (and a finished
  stream's history for the orphan TTL); ``resolve`` answers
  ``("stream", high_water, terminal_or_None)`` for a stream id, and
  ``("sresume", rid, {"rid": orig, "have": n})`` re-attaches the stream
  to a new connection, replaying exactly the frames past ``n``. Decode
  dispatch pins a sequence to one engine replica by request id (KV
  state lives there) and is structurally outside the hedging path.

Operational surface (the repo's contract for a subsystem):

* ``fault_point`` hooks: ``frontdoor.accept`` / ``frontdoor.read`` /
  ``frontdoor.reply``;
* watchdog heartbeats on the acceptor and every reader/writer thread;
* per-connection breaker-style eviction: a peer that repeatedly breaks
  frames mid-stream (``MXNET_SERVING_FRONTDOOR_EVICT_THRESHOLD``
  consecutive strikes) is disconnected and refused at accept for
  ``MXNET_SERVING_FRONTDOOR_EVICT_COOLDOWN_MS`` — one misbehaving
  client costs itself, never the gateway;
* graceful drain on SIGTERM (``install_sigterm_drain`` /
  :meth:`drain`): stop accepting, resolve every in-flight request and
  flush its reply, then close. Server-side accounting
  (``submitted == served + shed + failed``) holds across connection
  kills because outcomes are counted when the FUTURE resolves, not when
  the reply is delivered — an orphaned result is still a served request.

Trust model: the wire defaults to the safe non-executable codec
(``MXNET_SERVING_WIRE=safe`` —
``serving/codec.py``: tagged plain-data encodings with every resource
cap enforced before allocation), negotiated per connection via hello
frames (proto 2). Previous-protocol pickle peers keep being served
while ``MXNET_SERVING_WIRE_COMPAT`` is on (rolling upgrade); switch it
off post-migration and the gateway never runs ``pickle.loads`` on
network bytes. HMAC auth (``MXNET_SERVING_AUTH_KEY``) composes in
front of either codec: MAC verified first, then decode. Bind
127.0.0.1 unless the network is trusted
(``MXNET_SERVING_FRONTDOOR_BIND``).
"""
from __future__ import annotations

import logging
import queue as _queue
import signal as _signal
import socket
import threading
import time

import torch

from ..base import MXNetError, get_env
from ..resilience import faults as _faults
from . import wire as _wire
from .batcher import DeadlineExceeded
from .codec import host_value

__all__ = ["ServingFrontDoor"]

_log = logging.getLogger(__name__)

DEFAULT_PORT = 9611


# how many recently-SENT replies each connection retains for the
# resolve protocol: TCP accepts sends into a half-dead connection's
# buffer without error (a partitioned or just-killed client), so "the
# send succeeded" proves nothing about delivery — on connection death
# the ring moves to the orphan store, and a reconnecting client's
# resolve gets the real outcome instead of "unknown" (which would
# invite a duplicate resubmit of an already-served request)
_SENT_RING = 64


class _Conn:
    """One accepted client connection: socket + reader/writer threads.
    All sends to the peer go through ``send_q`` (the writer thread is
    the ONLY sender — replies from batcher done-callbacks, control
    replies from the reader, and drain notices never interleave
    mid-frame)."""

    __slots__ = ("sock", "peer", "conn_id", "send_q", "stop_evt",
                 "alive", "reader", "writer", "sent_ring", "codec",
                 "proto")

    def __init__(self, sock, peer, conn_id):
        self.sock = sock
        self.peer = peer            # client host string (eviction key)
        self.conn_id = conn_id
        self.send_q = _queue.Queue()
        self.stop_evt = threading.Event()
        self.alive = True
        self.reader = None
        self.writer = None
        # wire codec for THIS connection: None until the first frame
        # decides it — a ("hello", offer) negotiates (proto 2), any
        # other first frame marks a previous-protocol pickle peer
        # (proto 1, rolling-upgrade tolerance)
        self.codec = None
        self.proto = 1
        import collections
        self.sent_ring = collections.deque(maxlen=_SENT_RING)


def _replies_done(conn):
    """No reply of ``conn`` queued or being sent."""
    with conn.send_q.mutex:
        return conn.send_q.unfinished_tasks == 0


class _Pending:
    __slots__ = ("conn", "model", "rid")

    def __init__(self, conn, model, rid):
        self.conn = conn
        self.model = model
        self.rid = rid


class _Stream:
    """Gateway-side state of one decode stream: the frame
    history IS the exactly-once story. Every token frame ever produced
    for the stream is retained (in order — index ``i`` holds seq_no
    ``i+1``) until the stream expires, so a reconnecting client can
    resume from any high-water mark: resolve answers ``("stream", hwm,
    terminal)`` and ``sresume`` replays exactly the suffix the client
    lacks. ``conn`` is the CURRENT delivery target (None while
    detached); the terminal reply parks here too — streams never use
    the per-request orphan store."""

    __slots__ = ("rid", "model", "conn", "trace", "frames", "terminal",
                 "expiry", "engine_stream")

    def __init__(self, rid, model, conn, trace):
        self.rid = rid
        self.model = model
        self.conn = conn
        self.trace = trace
        self.frames = []        # ("stok", rid, seq_no, token), in order
        self.terminal = None    # ("sdone", rid, outcome, info) once done
        self.expiry = None      # monotonic TTL once terminal
        self.engine_stream = None


class ServingFrontDoor:
    """Host one ModelServer behind a TCP port for many client processes.

    Parameters
    ----------
    server : ModelServer
        The in-process serving tier every request submits into.
    host : str, optional
        Listen interface (default ``MXNET_SERVING_FRONTDOOR_BIND``,
        127.0.0.1 — see the trust model in the module docstring).
    port : int, optional
        Listen port (default ``MXNET_SERVING_PORT``, 9611). Pass 0 for
        an OS-assigned port; :attr:`port` reports the bound value after
        :meth:`start`.
    evict_threshold, evict_cooldown_ms, orphan_ttl_s, max_frame_mb :
        Operational knobs; each defaults to its
        ``MXNET_SERVING_FRONTDOOR_*`` env var.
    auth_key : str or bytes, optional
        Shared HMAC-SHA256 frame-auth key (default: the
        ``MXNET_SERVING_AUTH_KEY`` env var, read ONCE here). When set,
        every frame is verified BEFORE unpickling; an unauthenticated
        or tampered frame is rejected as an eviction strike
        (``auth_rejected`` counter).
    """

    def __init__(self, server, host=None, port=None, backlog=16,
                 evict_threshold=None, evict_cooldown_ms=None,
                 orphan_ttl_s=None, max_frame_mb=None, auth_key=None,
                 wire_mode=None, wire_compat=None):
        self._server = server
        self._auth_key = _wire.normalize_auth_key(auth_key)
        # wire codec policy, read ONCE here (zero-overhead contract):
        # mode governs what this gateway PREFERS to speak; compat is the
        # rolling-upgrade tolerance — whether previous-protocol pickle
        # peers are still admitted
        self._wire_mode = _wire.resolve_wire_mode(wire_mode)
        self._wire_compat = _wire.wire_compat_from_env() \
            if wire_compat is None else bool(wire_compat)
        from . import codec as _codec
        self._codec_limits = _codec.Limits()
        self._host = host if host is not None else get_env(
            "MXNET_SERVING_FRONTDOOR_BIND", "127.0.0.1")
        self.port = int(port) if port is not None else int(get_env(
            "MXNET_SERVING_PORT", DEFAULT_PORT, int))
        self._backlog = int(backlog)
        if evict_threshold is None:
            evict_threshold = get_env(
                "MXNET_SERVING_FRONTDOOR_EVICT_THRESHOLD", 3, int)
        if evict_cooldown_ms is None:
            evict_cooldown_ms = get_env(
                "MXNET_SERVING_FRONTDOOR_EVICT_COOLDOWN_MS", 5000.0, float)
        if orphan_ttl_s is None:
            orphan_ttl_s = get_env(
                "MXNET_SERVING_FRONTDOOR_ORPHAN_TTL_S", 60.0, float)
        if max_frame_mb is None:
            max_frame_mb = get_env(
                "MXNET_SERVING_FRONTDOOR_MAX_FRAME_MB",
                _wire.DEFAULT_MAX_FRAME_BYTES / 2.0 ** 20, float)
        if int(evict_threshold) < 1:
            raise MXNetError("evict_threshold must be >= 1, got %s"
                             % evict_threshold)
        self._evict_threshold = int(evict_threshold)
        self._evict_cooldown_s = float(evict_cooldown_ms) / 1000.0
        self._orphan_ttl_s = float(orphan_ttl_s)
        self._max_frame = int(float(max_frame_mb) * 2 ** 20)

        self._lock = threading.Lock()
        self._listen_sock = None
        self._acceptor = None
        self._stop_evt = threading.Event()
        self._draining = False
        self._started = False
        self._conn_seq = 0
        self._conns = set()
        self._pending = {}          # rid -> _Pending
        self._idle_cv = threading.Condition(self._lock)  # pending drained
        self._orphans = {}          # rid -> (expiry_monotonic, reply tuple)
        self._streams = {}          # rid -> _Stream (decode)
        self._strikes = {}          # peer host -> [strikes, refuse_until]
        self._counters = {
            "connections": 0, "refused_evicted": 0, "evictions": 0,
            "frames": 0, "submitted": 0, "served": 0, "shed": 0,
            "failed": 0, "wire_shed": 0, "refused_draining": 0,
            "orphaned": 0, "orphan_resolved": 0, "orphan_expired": 0,
            "control": 0, "auth_rejected": 0,
            "negotiated_safe": 0, "negotiated_pickle": 0,
            "legacy_peers": 0, "hello_rejected": 0,
            "stream_frames": 0, "stream_resumes": 0,
            "stream_resume_unknown": 0, "streams_expired": 0}
        self._prev_sigterm = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        """Bind, listen, and start the acceptor thread. Returns self so
        ``ServingFrontDoor(server, port=0).start()`` chains."""
        with self._lock:
            if self._started:
                raise MXNetError("front door already started")
            self._started = True
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self._host, self.port))
        srv.listen(self._backlog)
        srv.settimeout(0.5)
        self.port = srv.getsockname()[1]    # resolve port=0
        self._listen_sock = srv
        # watchdog heartbeats register INSIDE each loop (the poller
        # pattern): one heartbeat per live thread, closed on its own
        # clean exit
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="mx-frontdoor-accept",
            daemon=True)
        self._acceptor.start()
        _log.info("serving front door listening on %s:%d",
                  self._host, self.port)
        return self

    def install_sigterm_drain(self, timeout=None):
        """Install a SIGTERM handler that drains the front door (stop
        accepting, resolve in-flight, flush replies, close) before
        chaining to the previously installed handler — the serving
        analog of the checkpoint manager's preemption flush."""
        if threading.current_thread() is not threading.main_thread():
            raise MXNetError("signal handlers install from the main "
                             "thread only")

        def _handler(signum, frame):
            _log.warning("SIGTERM: draining serving front door")
            try:
                self.drain(timeout=timeout)
            finally:
                prev = self._prev_sigterm
                if callable(prev):
                    prev(signum, frame)
                elif prev == _signal.SIG_DFL:
                    _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
                    _signal.raise_signal(_signal.SIGTERM)

        self._prev_sigterm = _signal.signal(_signal.SIGTERM, _handler)

    def drain(self, timeout=30.0):
        """Graceful shutdown: stop accepting new connections, REFUSE new
        predicts with a typed failure, wait for every in-flight request
        to resolve and its reply to flush, then close every connection.
        Idempotent. Returns True when everything resolved inside
        ``timeout``."""
        with self._lock:
            already = self._draining
            self._draining = True
        if not already:
            self._stop_evt.set()
            sock = self._listen_sock
            if sock is not None:
                # shutdown wakes the acceptor blocked in accept() at
                # once (a bare close leaves it to its poll tick)
                _wire.teardown(sock)
        acceptor = self._acceptor
        if acceptor is not None and acceptor.is_alive() \
                and acceptor is not threading.current_thread():
            acceptor.join(timeout=5.0)
        deadline = None if timeout is None else time.monotonic() + timeout
        clean = self._wait_inflight(deadline)
        clean = self._wait_replies_flushed(deadline) and clean
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            self._close_conn(conn, join=True)
        return clean

    stop = drain

    def _wait_inflight(self, deadline):
        with self._idle_cv:
            while self._pending:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle_cv.wait(timeout=min(0.2, remaining)
                                   if remaining is not None else 0.2)
        return True

    def _wait_replies_flushed(self, deadline):
        """Every live connection's replies written: none queued and none
        in the writer's hands (a reply taken off the queue counts until
        its send returns, ``task_done``), so closing the socket after this
        never cuts a reply the writer is sending."""
        while True:
            with self._lock:
                conns = list(self._conns)
            if all(_replies_done(c) or not c.alive for c in conns):
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.01)

    # ------------------------------------------------------------------
    # acceptor
    # ------------------------------------------------------------------
    def _accept_loop(self):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("frontdoor:accept",
                                  thread=threading.current_thread())
        try:
            while not self._stop_evt.is_set():
                hb.idle()
                try:
                    sock, addr = self._listen_sock.accept()
                except socket.timeout:
                    # the accept poll tick doubles as the TIME-DRIVEN
                    # orphan sweep: TTL enforcement
                    # must not depend on new traffic arriving — an idle
                    # gateway would otherwise retain expired replies
                    # until the next orphan insertion
                    self._sweep_orphans()
                    # the accept poll tick: timeouts just re-check the
                    # stop event
                    continue
                except OSError:
                    # listener closed by drain(): the clean shutdown path
                    break
                hb.beat()
                try:
                    self._admit_conn(sock, addr)
                except Exception as e:
                    _log.warning("front door: rejected connection from "
                                 "%s: %s", addr, e)
                    try:
                        sock.close()
                    except OSError:
                        pass  # socket already dead; close is best-effort
        finally:
            hb.close()

    def _admit_conn(self, sock, addr):
        peer = addr[0]
        _faults.fault_point("frontdoor.accept", peer=peer)
        now = time.monotonic()
        with self._lock:
            strikes = self._strikes.get(peer)
            if strikes is not None and strikes[1] > now:
                self._counters["refused_evicted"] += 1
                refuse = True
            else:
                refuse = False
                if self._draining:
                    refuse = True
                else:
                    self._conn_seq += 1
                    conn_id = self._conn_seq
        if refuse:
            try:
                sock.close()
            except OSError:
                pass  # refused peer's socket; close is best-effort
            return
        sock.settimeout(0.5)
        conn = _Conn(sock, peer, conn_id)
        # bootstrap hello before the reader/writer exist: the conn_id
        # must be the FIRST frame on the stream (the client's request
        # ids embed it). ALWAYS pickle-encoded: a previous-protocol
        # client can only read pickle, and a safe-mode client SKIPS this
        # frame undecoded (it takes conn_id from the hello_ack instead)
        # — sending pickle is harmless, only loading it is code
        # execution. The third element advertises this build's
        # (protos, codecs) for proto-2 peers that do decode it; proto-1
        # clients index only [0] and [1] (forward compat by position).
        _wire.send_msg(
            sock, ("hello", conn_id,
                   {"protos": list(_wire.SUPPORTED_PROTOS),
                    "codecs": self._offered_codecs()}),
            auth_key=self._auth_key)
        conn.reader = threading.Thread(
            target=self._read_loop, args=(conn,),
            name="mx-frontdoor-read-%d" % conn_id, daemon=True)
        conn.writer = threading.Thread(
            target=self._write_loop, args=(conn,),
            name="mx-frontdoor-write-%d" % conn_id, daemon=True)
        with self._lock:
            self._conns.add(conn)
            self._counters["connections"] += 1
        conn.reader.start()
        conn.writer.start()

    # ------------------------------------------------------------------
    # per-connection reader
    # ------------------------------------------------------------------
    def _read_loop(self, conn):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("frontdoor:read:%d" % conn.conn_id,
                                  thread=threading.current_thread())
        try:
            while not conn.stop_evt.is_set():
                hb.idle()
                try:
                    # TICK-aware receive: a poll timeout BEFORE any frame
                    # byte re-checks the stop event; a timeout INSIDE a
                    # frame keeps reading (an honest slow peer must not
                    # be desynced into a strike) until the stall budget.
                    # Pickle acceptance is PER-CONNECTION: before the
                    # first frame the compat policy decides (rolling
                    # upgrade); after negotiation only a pickle-codec
                    # connection may keep sending pickle — a
                    # negotiated-safe peer switching back is a violation
                    # (and a strike), not a fallback.
                    allow_pickle = (self._wire_compat if conn.codec is None
                                    else conn.codec == _wire.CODEC_PICKLE)
                    msg = _wire.recv_msg_tick(conn.sock,
                                              max_bytes=self._max_frame,
                                              auth_key=self._auth_key,
                                              allow_pickle=allow_pickle,
                                              limits=self._codec_limits)
                except _wire.FrameError as e:
                    self._strike(conn, e)
                    return
                except OSError:
                    self._conn_lost(conn)
                    return
                if msg is _wire.TICK:
                    continue
                if msg is None:          # clean close at a frame boundary
                    self._conn_lost(conn, clean=True)
                    return
                hb.beat()
                with self._lock:
                    self._counters["frames"] += 1
                    # clean frame: the strike STREAK resets (breaker
                    # closes), but an active eviction cooldown stands —
                    # another connection from the same host must not be
                    # able to lift a refusal the cooldown still owns
                    rec = self._strikes.get(conn.peer)
                    if rec is not None:
                        rec[0] = 0
                        if rec[1] <= time.monotonic():
                            del self._strikes[conn.peer]
                try:
                    _faults.fault_point("frontdoor.read", peer=conn.peer,
                                        verb=str(msg[0]))
                    self._handle(conn, msg)
                except Exception as e:
                    # a verb handler crash (or injected read fault) is a
                    # server-side failure of THIS connection, never of
                    # the gateway: close it so the client's recovery
                    # path takes over
                    _log.warning("front door: connection %d dropped: %s",
                                 conn.conn_id, e)
                    self._conn_lost(conn)
                    return
        finally:
            hb.close()

    def _strike(self, conn, err):
        """One mid-frame failure from this peer: count a breaker strike;
        at the threshold the peer is evicted — refused at accept until
        the cooldown elapses. Auth failures (a peer without the shared
        ``MXNET_SERVING_AUTH_KEY``, or a tampered frame) are strikes of
        the same kind, separately counted — the frame never reached
        unpickling."""
        now = time.monotonic()
        with self._lock:
            if isinstance(err, _wire.AuthError):
                self._counters["auth_rejected"] += 1
            rec = self._strikes.setdefault(conn.peer, [0, 0.0])
            rec[0] += 1
            evicted = rec[0] >= self._evict_threshold
            if evicted:
                rec[1] = now + self._evict_cooldown_s
                rec[0] = 0
                self._counters["evictions"] += 1
        if evicted:
            _log.warning("front door: evicting client %s for %.1fs after "
                         "repeated mid-frame failures (%s)",
                         conn.peer, self._evict_cooldown_s, err)
        self._conn_lost(conn)

    def _conn_lost(self, conn, clean=False):
        """The peer is gone (or unusable): stop its threads, close the
        socket. Pending requests of this connection keep running — their
        outcomes land in the orphan store for the resolve protocol.
        ``clean`` marks an EOF at a frame boundary (a deliberate
        hang-up): such a peer read everything it wanted and will never
        reconnect-and-resolve, so the sent-ring is NOT requeued."""
        with self._lock:
            conn.alive = False
            self._conns.discard(conn)
            # detach this connection's decode streams: they keep
            # generating (and retaining frames) headless; a reconnect
            # re-attaches via resolve + sresume
            for st in self._streams.values():
                if st.conn is conn:
                    st.conn = None
        conn.stop_evt.set()
        try:
            # shutdown before close: wakes a reader blocked in recv()
            # and FINs the peer promptly (a bare close does neither
            # reliably while another thread holds the recv)
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # peer already gone; shutdown is best-effort
        try:
            conn.sock.close()
        except OSError:
            pass  # peer socket already dead; close is best-effort
        # replies enqueued before (or atomically with, see _on_done) the
        # alive flip may never reach the writer once stop_evt is set:
        # drain them into the orphan store so the resolve protocol can
        # still hand them out (each queue entry reaches exactly one
        # consumer — this drain or the writer — never both)
        while True:
            try:
                self._requeue_orphan(conn.send_q.get(block=False))
            except _queue.Empty:
                break  # empty queue IS the drain's exit condition
            conn.send_q.task_done()
        # ... and, for NON-clean deaths, the recently-SENT window too: a
        # send into a half-dead connection succeeds into the TCP buffer,
        # so outcomes the writer believed delivered may be gone — retain
        # them for the resolve protocol rather than answer a reconnect
        # "unknown". A clean hang-up skips this: the peer read its
        # replies and will never resolve, and requeueing would pin every
        # short-lived connection's last outputs for the orphan TTL.
        while not clean and conn.sent_ring:
            try:
                self._requeue_orphan(conn.sent_ring.popleft())
            except IndexError:
                break  # concurrent pop emptied the ring — drain done

    def _close_conn(self, conn, join=False):
        self._conn_lost(conn)
        if join:
            me = threading.current_thread()
            for t in (conn.reader, conn.writer):
                if t is not None and t.is_alive() and t is not me:
                    t.join(timeout=5.0)

    # ------------------------------------------------------------------
    # verbs
    # ------------------------------------------------------------------
    def _handle(self, conn, msg):
        verb = msg[0]
        if verb == "hello":
            if conn.codec is not None:
                # negotiation is ONCE per connection: a re-hello after
                # the codec is fixed is a protocol violation (it could
                # renegotiate a safe connection back onto pickle and
                # bypass the post-negotiation allow_pickle gate) — a
                # strike, exactly like any other malformed stream
                self._strike(conn, _wire.FrameError(
                    "hello after negotiation on connection %d"
                    % conn.conn_id))
                return
            self._handle_hello(conn, msg[1] if len(msg) > 1 else {})
            return
        if conn.codec is None:
            # first frame and it is NOT a hello: a previous-protocol
            # peer (old hello consumed, old codec). The connection
            # speaks pickle for its lifetime — the rolling-upgrade
            # tolerance the compat gate already admitted.
            conn.codec = _wire.CODEC_PICKLE
            with self._lock:
                self._counters["legacy_peers"] += 1
        if verb == "predict":
            self._handle_predict(conn, msg[1], msg[2])
        elif verb == "decode":
            self._handle_decode(conn, msg[1], msg[2])
        elif verb == "sresume":
            self._handle_sresume(conn, msg[1], msg[2])
        elif verb == "resolve":
            self._handle_resolve(conn, msg[1], msg[2])
        elif verb == "health":
            with self._lock:
                self._counters["control"] += 1
            conn.send_q.put(("health", msg[1], self._server.health()))
        elif verb == "list_models":
            with self._lock:
                self._counters["control"] += 1
            conn.send_q.put(("models", msg[1], self._list_models()))
        elif verb == "ping":
            conn.send_q.put(("pong", msg[1]))
        else:
            conn.send_q.put(("failed", msg[1] if len(msg) > 1 else None,
                             "unknown verb %r" % (verb,)))

    def _offered_codecs(self):
        if self._wire_mode == _wire.CODEC_SAFE:
            return [_wire.CODEC_SAFE] + (
                [_wire.CODEC_PICKLE] if self._wire_compat else [])
        return [_wire.CODEC_PICKLE, _wire.CODEC_SAFE]

    def _handle_hello(self, conn, offer):
        """Proto-2 negotiation: pick the highest common (proto, codec)
        pair and ack it; every later frame on this connection — both
        directions — speaks the chosen codec. Unknown offer keys are
        ignored (forward compat). A failed negotiation is answered
        typed (``hello_reject``), not struck: a version-mismatched
        honest peer deserves a readable verdict, and it will hang up
        cleanly on receipt."""
        try:
            proto, chosen = _wire.negotiate(
                offer if isinstance(offer, dict) else {},
                self._wire_mode, self._wire_compat)
        except _wire.FrameError as e:
            with self._lock:
                self._counters["hello_rejected"] += 1
            # the peer sent a (decodable) hello, so it reads the safe
            # codec; answer in it so the refusal is legible
            conn.codec = _wire.CODEC_SAFE
            conn.send_q.put(("hello_reject", None, str(e)))
            return
        with self._lock:
            self._counters["negotiated_%s" % chosen] += 1
        conn.codec = chosen
        conn.proto = proto
        conn.send_q.put(("hello_ack", conn.conn_id,
                         {"proto": proto, "codec": chosen}))

    def _list_models(self):
        out = {}
        for name in self._server.models():
            out[name] = {
                "versions": [str(v) for v in self._server.versions(name)],
                "default_version": str(self._server.default_version(name))}
        return out

    def _handle_predict(self, conn, rid, spec):
        from .. import profiler as _prof
        model = spec.get("model")
        trace = spec.get("trace") or rid
        with self._lock:
            self._counters["submitted"] += 1
        # deadline propagation: the budget on the wire is the REMAINING
        # budget at client send time; subtract the measured transfer so
        # queue wait accrues against the true end-to-end budget. Wall
        # clocks (time.time) are shared on one host; cross-host skew is
        # clamped at 0.
        t_send = spec.get("t_send")
        wire_ms = 0.0
        if t_send is not None:
            wire_ms = max(0.0, (time.time() - float(t_send)) * 1e3)
        _prof.record_latency("serving.%s.wire" % model, wire_ms * 1e6)
        deadline_ms = spec.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms) - wire_ms
            if deadline_ms <= 0.0:
                with self._lock:
                    self._counters["wire_shed"] += 1
                    self._counters["shed"] += 1
                conn.send_q.put((
                    "shed", rid,
                    "request shed at the front door: deadline budget "
                    "consumed by %.1fms wire transfer" % wire_ms))
                return
        entry = _Pending(conn, model, rid)
        with self._lock:
            # the draining check and the pending registration are ONE
            # critical section: drain() reads _pending under this lock
            # to decide "everything resolved" — a check-then-insert
            # across two acquisitions would let drain return clean with
            # a request admitted in the gap
            if self._draining:
                self._counters["refused_draining"] += 1
                self._counters["failed"] += 1
                refused = True
            else:
                self._pending[rid] = entry
                refused = False
        if refused:
            conn.send_q.put(("failed", rid,
                             "server draining: request refused"))
            return
        try:
            fut = self._server.predict_async(
                model, spec.get("arrays"), version=spec.get("version"),
                deadline_ms=deadline_ms,
                priority=int(spec.get("priority") or 0))
        except Exception as e:
            with self._lock:
                self._pending.pop(rid, None)
                self._counters["failed"] += 1
            conn.send_q.put(("failed", rid, "%s: %s"
                             % (type(e).__name__, e)))
            return
        fut.add_done_callback(
            lambda inner, e=entry, w=wire_ms, t=trace:
            self._on_done(e, inner, w, t))

    def _on_done(self, entry, inner, wire_ms, trace):
        """Inner future resolved (batcher/replica thread): build the
        typed reply, count the outcome, hand the frame to the writer —
        or to the orphan store when the client connection died."""
        err = inner.error
        if err is None:
            timings = {"trace": trace, "wire_ms": round(wire_ms, 3)}
            t_submit = getattr(inner, "t_submit", None)
            t_dispatch = getattr(inner, "t_dispatch", None)
            t_done = getattr(inner, "t_done", None)
            if t_submit is not None and t_done is not None:
                td = t_dispatch if t_dispatch is not None else t_done
                timings["queue_ms"] = round((td - t_submit) * 1e3, 3)
                timings["device_ms"] = round((t_done - td) * 1e3, 3)
                timings["total_ms"] = round(
                    wire_ms + (t_done - t_submit) * 1e3, 3)
            # device tensors on the card: the writer thread (or, for a
            # dead connection, _orphan) copies them to the host
            # (codec.host_value), never under a lock
            reply = ("served", entry.rid, list(inner.result), timings)
            outcome = "served"
        elif isinstance(err, DeadlineExceeded):
            reply = ("shed", entry.rid, str(err))
            outcome = "shed"
        else:
            reply = ("failed", entry.rid, "%s: %s"
                     % (type(err).__name__, err))
            outcome = "failed"
        with self._idle_cv:
            self._counters[outcome] += 1
            self._pending.pop(entry.rid, None)
            if not self._pending:
                self._idle_cv.notify_all()
            # the alive check and the enqueue must be ONE atomic step
            # against _conn_lost's alive flip + queue drain: a put after
            # the flip would land in a queue nobody drains, the reply
            # would be neither delivered nor orphaned, and a later
            # resolve would answer "unknown" for an already-executed
            # request — the duplicate the orphan store exists to prevent
            queued = entry.conn.alive
            if queued:
                entry.conn.send_q.put(reply)
        if not queued:
            self._orphan(entry.rid, reply)

    # ------------------------------------------------------------------
    # stateful decode streaming
    # ------------------------------------------------------------------
    def _handle_decode(self, conn, rid, spec):
        """Admit one decode stream. Token frames ``("stok", rid,
        seq_no, token)`` flow back incrementally; ``("sdone", rid,
        outcome, info)`` terminates. Accounting is identical to
        predict: one submitted, exactly one terminal outcome — a stream
        is one request however many frames it produces."""
        from .. import profiler as _prof
        model = spec.get("model")
        trace = spec.get("trace") or rid
        with self._lock:
            self._counters["submitted"] += 1
        t_send = spec.get("t_send")
        wire_ms = 0.0
        if t_send is not None:
            wire_ms = max(0.0, (time.time() - float(t_send)) * 1e3)
        _prof.record_latency("serving.%s.wire" % model, wire_ms * 1e6)
        deadline_ms = spec.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms) - wire_ms
            if deadline_ms <= 0.0:
                with self._lock:
                    self._counters["wire_shed"] += 1
                    self._counters["shed"] += 1
                conn.send_q.put((
                    "sdone", rid, "shed",
                    "decode shed at the front door: deadline budget "
                    "consumed by %.1fms wire transfer" % wire_ms))
                return
        st = _Stream(rid, model, conn, trace)
        with self._lock:
            # same one-critical-section rule as predict: the draining
            # check, the pending registration, and the stream
            # registration are atomic against drain()
            if self._draining:
                self._counters["refused_draining"] += 1
                self._counters["failed"] += 1
                refused = True
            else:
                self._pending[rid] = _Pending(conn, model, rid)
                self._streams[rid] = st
                refused = False
        if refused:
            conn.send_q.put(("sdone", rid, "failed",
                             "server draining: request refused"))
            return
        extra = {}
        if deadline_ms is not None:
            # explicit client budget (minus wire time); an absent one
            # falls through to the engine's configured default
            extra["deadline_ms"] = deadline_ms
        try:
            st.engine_stream = self._server.submit_decode(
                model, spec.get("tokens"),
                max_new_tokens=spec.get("max_new_tokens"),
                priority=int(spec.get("priority") or 0),
                trace=trace, pin=rid, **extra,
                on_token=lambda es, seq_no, tok, s=st:
                    self._stream_token(s, seq_no, tok),
                on_done=lambda es, s=st: self._stream_done(s, es))
        except Exception as e:
            with self._idle_cv:
                self._pending.pop(rid, None)
                self._streams.pop(rid, None)
                self._counters["failed"] += 1
                if not self._pending:
                    self._idle_cv.notify_all()
            conn.send_q.put(("sdone", rid, "failed", "%s: %s"
                             % (type(e).__name__, e)))

    def _stream_token(self, st, seq_no, token):
        """One generated token (engine loop thread): record the frame in
        the stream history, then deliver to the current connection. The
        append and the enqueue share one lock acquisition with sresume's
        replay, so a concurrent resume can neither drop nor duplicate a
        frame. An injected ``decode.stream`` fault models a broken
        delivery path: the frame is RETAINED (it already happened) and
        the connection is dropped so the client's resume-by-id recovery
        takes over."""
        from .. import profiler as _prof
        frame = ("stok", st.rid, int(seq_no), int(token))
        fault = None
        try:
            _faults.fault_point("decode.stream", rid=st.rid, seq_no=seq_no)
        except Exception as e:
            fault = e
        with self._lock:
            st.frames.append(frame)
            self._counters["stream_frames"] += 1
            conn = st.conn
            deliver = (fault is None and conn is not None and conn.alive)
            if deliver:
                conn.send_q.put(frame)
        _prof.record_decode_event(stream_frames=1)
        if fault is not None and conn is not None:
            _log.warning("front door: stream %s delivery fault: %s",
                         st.rid, fault)
            self._conn_lost(conn)

    def _stream_done(self, st, engine_stream):
        """Terminal engine outcome for a stream: count it (the
        accounting invariant treats the whole stream as one request),
        park the terminal reply on the stream state with a TTL, and
        deliver when a connection is attached."""
        if engine_stream.outcome == "served":
            reply = ("sdone", st.rid, "served",
                     {"trace": st.trace, "tokens": len(engine_stream.tokens)})
        else:
            reply = ("sdone", st.rid, engine_stream.outcome,
                     str(engine_stream.error))
        with self._idle_cv:
            self._counters[engine_stream.outcome] += 1
            self._pending.pop(st.rid, None)
            if not self._pending:
                self._idle_cv.notify_all()
            st.terminal = reply
            st.expiry = time.monotonic() + self._orphan_ttl_s
            conn = st.conn
            if conn is not None and conn.alive:
                conn.send_q.put(reply)

    def _handle_sresume(self, conn, rid, payload):
        """Re-attach a stream to a (new) connection and replay exactly
        the frames past the client's high-water mark — the streaming
        half of exactly-once: the client asked for ``have+1..`` and
        that is precisely what it gets, plus the terminal if the stream
        finished while detached."""
        from .. import profiler as _prof
        orig = payload.get("rid")
        have = max(0, int(payload.get("have") or 0))
        with self._lock:
            self._counters["control"] += 1
            st = self._streams.get(orig)
            if st is None:
                self._counters["stream_resume_unknown"] += 1
                known = False
            else:
                known = True
                st.conn = conn
                self._counters["stream_resumes"] += 1
                for frame in st.frames[have:]:
                    conn.send_q.put(frame)
                if st.terminal is not None:
                    conn.send_q.put(st.terminal)
        if known:
            _prof.record_decode_event(stream_resumes=1)
        else:
            conn.send_q.put(("sdone", orig, "failed",
                             "unknown stream %r (expired, or never "
                             "admitted)" % (orig,)))

    # ------------------------------------------------------------------
    # orphan store + resolve protocol
    # ------------------------------------------------------------------
    def _sweep_orphans_locked(self, now):
        """Drop expired orphan replies (caller holds ``self._lock``).
        Runs on the acceptor's poll tick, on every resolve, and on each
        insertion — TTL is enforced by TIME, not by traffic (an idle
        gateway must not retain expired replies indefinitely)."""
        expired = [r for r, (exp, _) in self._orphans.items()
                   if exp <= now]
        for r in expired:
            del self._orphans[r]
            self._counters["orphan_expired"] += 1
        # finished streams age out on the same TTL: once terminal, the
        # retained frame history only exists for resume-by-id, and a
        # client that has not reconnected within the orphan window gets
        # the same "unknown" answer an expired orphan would
        dead = [r for r, st in self._streams.items()
                if st.terminal is not None and st.expiry <= now]
        for r in dead:
            del self._streams[r]
            self._counters["streams_expired"] += 1

    def _sweep_orphans(self):
        with self._lock:
            if self._orphans or self._streams:
                self._sweep_orphans_locked(time.monotonic())

    def _orphan(self, rid, reply):
        # the store holds host values, as the reference's does: a dead
        # connection's reply must not pin the engine's device memory
        # for the orphan TTL (copied before the lock is taken)
        reply = host_value(reply)
        now = time.monotonic()
        with self._lock:
            self._sweep_orphans_locked(now)
            self._orphans[rid] = (now + self._orphan_ttl_s, reply)
            self._counters["orphaned"] += 1

    def _handle_resolve(self, conn, rid, rids):
        now = time.monotonic()
        out = {}
        with self._lock:
            self._sweep_orphans_locked(now)
            for r in rids:
                st = self._streams.get(r)
                if st is not None:
                    # streams resolve to their high-water mark: the
                    # client learns how many frames exist (and the
                    # terminal outcome, if any) and resumes via sresume
                    # rather than resubmitting
                    out[r] = ("stream", len(st.frames), st.terminal)
                    continue
                rec = self._orphans.pop(r, None)
                if rec is not None and rec[0] > now:
                    self._counters["orphan_resolved"] += 1
                    out[r] = rec[1]
                elif rec is not None:
                    self._counters["orphan_expired"] += 1
                    out[r] = ("unknown",)
                elif r in self._pending:
                    out[r] = ("pending",)
                else:
                    out[r] = ("unknown",)
        conn.send_q.put(("resolved", rid, out))

    # ------------------------------------------------------------------
    # per-connection writer
    # ------------------------------------------------------------------
    def _write_loop(self, conn):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("frontdoor:write:%d" % conn.conn_id,
                                  thread=threading.current_thread())
        try:
            while not (conn.stop_evt.is_set() and conn.send_q.empty()):
                try:
                    reply = conn.send_q.get(timeout=0.2)
                except _queue.Empty:
                    hb.idle()
                    continue
                hb.beat()
                try:
                    _faults.fault_point("frontdoor.reply", peer=conn.peer,
                                        verb=str(reply[0]))
                    # stall-tolerant send: the socket's short poll
                    # timeout must not kill a merely backpressured
                    # client mid-reply (only a zero-progress stall does).
                    # Replies speak the connection's negotiated codec;
                    # pre-negotiation control replies (a pre-hello
                    # "failed" verdict) default to pickle — the only
                    # codec a peer that skipped the handshake can read.
                    reply = host_value(reply)
                    _wire.send_msg_stall(
                        conn.sock, reply, auth_key=self._auth_key,
                        codec=conn.codec or _wire.CODEC_PICKLE,
                        limits=self._codec_limits)
                    if reply[0] in ("served", "shed", "failed"):
                        # "sent" is not "delivered" (TCP buffers accept
                        # frames for a dead peer): keep the outcome in
                        # the bounded sent-ring until the connection
                        # proves healthy longer than the window
                        conn.sent_ring.append(reply)
                except Exception:
                    # peer unreachable (or injected reply fault): keep
                    # the outcome for the resolve protocol, then drain
                    # the rest of this connection's queue the same way
                    self._requeue_orphan(reply)
                    self._conn_lost(conn)
                    while True:
                        try:
                            self._requeue_orphan(
                                conn.send_q.get(block=False))
                        except _queue.Empty:
                            # empty queue IS the loop's exit: every
                            # queued reply has been orphaned
                            return
                        conn.send_q.task_done()
                finally:
                    # this reply is written (or orphaned): drain may now
                    # close the socket
                    conn.send_q.task_done()
        finally:
            hb.close()

    def _requeue_orphan(self, reply):
        if reply and reply[0] in ("served", "shed", "failed") \
                and reply[1] is not None:
            self._orphan(reply[1], reply)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self):
        """Gateway counters. The invariant the smoke/chaos gates assert:
        ``submitted == served + shed + failed`` (outcomes counted at
        future resolution, so connection kills lose nothing)."""
        with self._lock:
            out = dict(self._counters)
            out["open_connections"] = len(self._conns)
            out["pending"] = len(self._pending)
            out["orphans_held"] = len(self._orphans)
            out["streams_held"] = len(self._streams)
        return out

