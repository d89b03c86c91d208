"""FleetPool — cross-HOST replica fan-out behind one serving gateway.

Counterpart of ``mxnet_tpu/serving/pool.py``. Without it every replica
of every model lives inside the gateway's own OS process, so one process
death is a total outage. The fleet layer is the serving-tier shape of
TensorFlow's distributed fault-tolerance axis (arXiv:1605.08695) at the
pod scale arXiv:1909.09756 assumes: worker HOSTS join and leave, and the
system keeps its exactly-once accounting and its SLA through the death,
drain, and rejoin of any of them.

Topology:

* a :class:`~.worker.ReplicaWorker` process hosts engine replicas behind
  its OWN `ServingFrontDoor` (the dispatch plane — orphan store, resolve
  protocol and exactly-once semantics come for free);
* the worker DIALS the gateway's `FleetPool` control port, sends
  ``("join", info)`` and then heartbeats on a supervised cadence — the
  worker initiates, so NAT'd/ephemeral hosts need no inbound port except
  their own dispatch plane;
* on admission the pool wraps the worker in one :class:`RemoteReplica`
  per shared model and attaches it to the gateway `ModelServer` via
  :meth:`~.server.ModelServer.add_replicas` — least-loaded routing, the
  per-replica `_Breaker`, hedging and the remaining-budget resubmit
  machinery all work UNCHANGED across hosts, because the adapter speaks
  the same replica dispatch surface as a local `InferenceEngine`.

Failure model (the watchdog idiom from `resilience/watchdog.py`, applied
across hosts):

* missed heartbeats mark a worker **SUSPECT** after
  ``MXNET_SERVING_FLEET_SUSPECT_S`` — its replicas flip
  ``available=False`` and dispatch routes around them (like an open
  breaker; the forced-probe fallback still exists so degradation can
  never self-inflict a full outage);
* **DEAD** after ``MXNET_SERVING_FLEET_DEAD_S``: the replicas detach
  from the routing table and the worker's `ServingClient` fails over —
  every in-flight request resolves **by id against the worker's orphan
  store** (the client's rule: only proven-unknown requests resubmit, so a
  reply the worker already computed is recovered, not re-executed);
* a rejoining worker (same ``worker_id`` or fresh) must report warmed
  engines AND answer a **half-open probe** (one real self-predict per
  model over the control channel) before its replicas are readmitted.

Fault-injection sites (`MXNET_TPU_FAULT_SPEC`):
``fleet.join`` (admission), ``fleet.heartbeat`` (ctx ``side=gateway`` on
receipt / ``side=worker`` on send), ``fleet.dispatch`` (every remote
dispatch) — all behind the faults module's zero-overhead cached flag.

Rollover weights cross the control channel as host values
(:func:`_host_params`: numpy arrays, bfloat16 as a CPU tensor), and the
worker lifts them to tensors on its engines' device.
"""
from __future__ import annotations

import logging
import socket
import threading
import time

from ..base import MXNetError, get_env
from ..resilience import faults as _faults
from . import wire as _wire
from .client import ServingClient

__all__ = ["FleetPool", "RemoteReplica", "DEFAULT_FLEET_PORT"]

_log = logging.getLogger(__name__)

DEFAULT_FLEET_PORT = 9612

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"


class RemoteReplica:
    """The replica dispatch surface of a REMOTE worker — what makes the
    ModelServer's routing work unchanged across hosts.

    Implements exactly the engine methods dispatch touches
    (``predict_async`` / ``predict`` / ``update_params`` / ``stats`` /
    ``stop``, plus ``name``/``replica``/``device`` for observability) over
    the worker's own front door via a pooled `ServingClient`. The
    returned `ClientRequest` future carries ``error``/``result``/
    ``add_done_callback`` and back-derived ``t_submit``/``t_dispatch``/
    ``t_done``, so `_ServerRequest` proxying, breaker feeding, hedging
    and the gateway front door's timing decomposition all compose."""

    def __init__(self, pool, handle, model):
        self._pool = pool
        self._worker = handle
        self.name = model
        self.replica = None          # assigned by ModelServer.add_replicas
        self._ctx = "remote:%s@%s:%d" % (handle.worker_id, handle.host,
                                         handle.port)
        self.device = self._ctx      # what ModelServer.stats() prints
        self._lat_key = "serving.%s" % model

    # -- dispatch surface ----------------------------------------------
    def predict_async(self, data, deadline_ms=None, priority=0):
        _faults.fault_point("fleet.dispatch", worker=self._worker.worker_id,
                            model=self.name)
        fut = self._worker.client.predict_async(
            data, model=self.name, deadline_ms=deadline_ms,
            priority=priority)
        fut.add_done_callback(self._record)
        return fut

    def predict(self, data):
        _faults.fault_point("fleet.dispatch", worker=self._worker.worker_id,
                            model=self.name, mode="sync")
        return self._worker.client.predict(data, model=self.name)

    def _record(self, fut):
        """Served remote dispatches feed the GATEWAY's per-model latency
        histograms (local replicas record through their batcher): the
        hedger's p95 signal and `health()` must see remote service time
        too. Remote dispatch only exists with the fleet on, so this adds
        nothing to the in-process path."""
        if fut.error is not None:
            return
        from .. import profiler as _prof
        t_submit, t_done = fut.t_submit, fut.t_done
        t_dispatch = fut.t_dispatch
        if t_submit is None or t_done is None:
            return
        td = t_dispatch if t_dispatch is not None else t_done
        _prof.record_latency(self._lat_key + ".queue",
                             (td - t_submit) * 1e9)
        _prof.record_latency(self._lat_key + ".device",
                             (t_done - td) * 1e9)
        _prof.record_latency(self._lat_key + ".total",
                             (t_done - t_submit) * 1e9)

    # -- lifecycle / observability -------------------------------------
    def update_params(self, arg_params, aux_params=None):
        """Rollover fan-out reaches remote hosts over the control
        channel: the worker re-stages the weights through its local
        engines' `update_params`."""
        self._pool._rollover_worker(self._worker, self.name,
                                    arg_params, aux_params)

    def stats(self):
        health = self._worker.health or {}
        model_health = (health.get("models") or {}).get(self.name, {})
        return {"remote": True, "worker": self._worker.worker_id,
                "worker_state": self._worker.state,
                "ctx": self._ctx, "name": self.name,
                "worker_health": model_health}

    def step_time(self, bucket):
        return None                  # remote: no local program cache

    def stop(self):
        pass                         # the pool owns the client lifecycle


class WorkerHandle:
    """One fleet worker as the gateway sees it: control connection,
    heartbeat freshness, ALIVE/SUSPECT/DEAD state, the dispatch-plane
    `ServingClient`, and the `_Replica` wrappers attached to the
    ModelServer."""

    def __init__(self, worker_id, host, port, pid=None,
                 codec=_wire.CODEC_PICKLE):
        self.worker_id = worker_id
        self.host = host
        self.port = port             # the worker's DISPATCH (frontdoor) port
        self.pid = pid
        self.codec = codec           # control-channel codec (negotiated)
        self.state = ALIVE
        self.last_hb = time.monotonic()
        self.health = None           # last heartbeat's health snapshot
        self.client = None           # ServingClient to the dispatch plane
        self.replicas = {}           # model -> [_Replica wrappers]
        self.conn = None             # control socket
        self.send_lock = threading.Lock()
        self.acks = {}               # rid -> [threading.Event, reply]
        self.seq = 0
        self.joined_at = time.time()
        self.suspects = 0
        self.deaths = 0

    def describe(self):
        return {"worker_id": self.worker_id, "host": self.host,
                "port": self.port, "pid": self.pid, "state": self.state,
                "age_s": round(time.time() - self.joined_at, 1),
                "heartbeat_age_s": round(
                    time.monotonic() - self.last_hb, 2),
                "suspects": self.suspects, "deaths": self.deaths,
                "models": sorted(self.replicas)}


class FleetPool:
    """The gateway's fleet control plane: admit workers, supervise their
    heartbeats, attach/detach their replicas, and answer the merged
    health the autoscaler polls.

    Parameters
    ----------
    server : ModelServer
        The gateway serving tier remote replicas attach to. Models a
        worker offers that the gateway has not registered are ignored
        (the gateway's registry is the source of truth for what is
        served; a worker can't introduce a model by joining).
    host, port : control-plane bind (defaults
        ``MXNET_SERVING_FLEET_BIND`` / ``MXNET_SERVING_FLEET_PORT``;
        port 0 binds ephemeral and :attr:`port` reports it).
    heartbeat_s : float
        Cadence workers are told to heartbeat at
        (``MXNET_SERVING_FLEET_HEARTBEAT_S``, default 2s).
    suspect_after_s, dead_after_s : float
        Missed-heartbeat thresholds (defaults: 2x and 5x the cadence,
        overridable via ``MXNET_SERVING_FLEET_SUSPECT_S`` /
        ``MXNET_SERVING_FLEET_DEAD_S``).
    auth_key : shared HMAC frame key (``MXNET_SERVING_AUTH_KEY``);
        covers the control channel AND the dispatch clients.
    connect_deadline_s : budget for establishing dispatch connections to
        a worker (kept small: this bounds failure-detection latency on
        the dispatch path).
    """

    def __init__(self, server, host=None, port=None, heartbeat_s=None,
                 suspect_after_s=None, dead_after_s=None, auth_key=None,
                 connect_deadline_s=3.0, probe_timeout_s=30.0, backlog=16,
                 wire_mode=None, wire_compat=None):
        self._server = server
        # control-channel wire codec policy, read ONCE: the
        # fleet channel defaults to the safe non-executable codec; a
        # previous-protocol worker whose first frame is a pickle "join"
        # is tolerated while compat is on (rolling upgrade)
        self._wire_mode = _wire.resolve_wire_mode(wire_mode)
        self._wire_compat = _wire.wire_compat_from_env() \
            if wire_compat is None else bool(wire_compat)
        from . import codec as _codec
        self._codec_limits = _codec.Limits()
        self._host = host if host is not None else get_env(
            "MXNET_SERVING_FLEET_BIND", "127.0.0.1")
        self.port = int(port) if port is not None else int(get_env(
            "MXNET_SERVING_FLEET_PORT", DEFAULT_FLEET_PORT, int))
        if heartbeat_s is None:
            heartbeat_s = get_env("MXNET_SERVING_FLEET_HEARTBEAT_S",
                                  2.0, float)
        self._heartbeat_s = float(heartbeat_s)
        if suspect_after_s is None:
            suspect_after_s = get_env("MXNET_SERVING_FLEET_SUSPECT_S",
                                      2.0 * self._heartbeat_s, float)
        if dead_after_s is None:
            dead_after_s = get_env("MXNET_SERVING_FLEET_DEAD_S",
                                   5.0 * self._heartbeat_s, float)
        self._suspect_after_s = float(suspect_after_s)
        self._dead_after_s = float(dead_after_s)
        if not (self._dead_after_s > self._suspect_after_s > 0):
            raise MXNetError(
                "fleet thresholds must satisfy 0 < suspect (%s) < dead "
                "(%s)" % (self._suspect_after_s, self._dead_after_s))
        self._auth_key = _wire.normalize_auth_key(auth_key)
        self._connect_deadline_s = float(connect_deadline_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._backlog = int(backlog)

        self._lock = threading.Lock()
        self._workers = {}           # worker_id -> WorkerHandle
        self._retired = []           # [(close_after_monotonic, client)]
        self._listen_sock = None
        self._acceptor = None
        self._monitor = None
        self._stop_evt = threading.Event()
        self._started = False
        self._counters = {"joins": 0, "rejoins": 0, "rejects": 0,
                          "suspects": 0, "deads": 0, "recoveries": 0,
                          "heartbeats": 0, "probe_failures": 0}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        with self._lock:
            if self._started:
                raise MXNetError("fleet pool already started")
            self._started = True
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self._host, self.port))
        srv.listen(self._backlog)
        srv.settimeout(0.5)
        self.port = srv.getsockname()[1]
        self._listen_sock = srv
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="mx-fleet-accept", daemon=True)
        self._acceptor.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="mx-fleet-monitor", daemon=True)
        self._monitor.start()
        _log.info("fleet pool listening on %s:%d (heartbeat %.1fs, "
                  "suspect %.1fs, dead %.1fs)", self._host, self.port,
                  self._heartbeat_s, self._suspect_after_s,
                  self._dead_after_s)
        return self

    def stop(self, drain_workers=False):
        """Stop supervision and detach every worker. With
        ``drain_workers`` each worker is asked to drain-and-exit first
        (the autoscaler's launcher otherwise owns process shutdown)."""
        self._stop_evt.set()
        sock = self._listen_sock
        if sock is not None:
            _teardown(sock)     # wakes the acceptor blocked in accept()
        for thread in (self._acceptor, self._monitor):
            if thread is not None and thread.is_alive() \
                    and thread is not threading.current_thread():
                thread.join(timeout=5.0)
        with self._lock:
            handles = list(self._workers.values())
        for handle in handles:
            if drain_workers and handle.state != DEAD:
                try:
                    self._send_cmd(handle, ("drain", self._next_rid(handle)))
                except Exception:
                    # best-effort drain notice on shutdown: the launcher
                    # owns process teardown
                    pass
            self._detach(handle, reason="pool stopped")
            conn = handle.conn
            if conn is not None:
                _teardown(conn)
            if handle.client is not None:
                handle.client.close()
        with self._lock:
            retired, self._retired = self._retired, []
        for _t, client in retired:
            client.close()

    # ------------------------------------------------------------------
    # acceptor + per-worker control reader
    # ------------------------------------------------------------------
    def _accept_loop(self):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("fleet:accept",
                                  thread=threading.current_thread())
        try:
            while not self._stop_evt.is_set():
                hb.idle()
                try:
                    sock, addr = self._listen_sock.accept()
                except socket.timeout:
                    continue  # accept poll tick — re-check the stop event
                except OSError:
                    break  # listener closed by stop(): the clean exit path
                hb.beat()
                sock.settimeout(0.5)
                threading.Thread(
                    target=self._control_loop, args=(sock, addr),
                    name="mx-fleet-control-%s" % (addr[0],),
                    daemon=True).start()
        finally:
            hb.close()

    def _control_loop(self, sock, addr):
        """One worker's control connection: join handshake, then
        heartbeats + command acks until the connection (or the pool)
        dies."""
        from ..resilience.watchdog import watchdog as _watchdog
        handle = None
        codec = None                # None until the first frame decides
        hb = _watchdog().register("fleet:control:%s" % (addr[0],),
                                  thread=threading.current_thread())
        try:
            while not self._stop_evt.is_set():
                hb.idle()
                try:
                    allow_pickle = (self._wire_compat if codec is None
                                    else codec == _wire.CODEC_PICKLE)
                    msg = _wire.recv_msg_tick(sock,
                                              auth_key=self._auth_key,
                                              allow_pickle=allow_pickle,
                                              limits=self._codec_limits)
                except (_wire.FrameError, OSError) as e:
                    if handle is not None:
                        _log.warning("fleet: control channel to %s lost "
                                     "(%s)", handle.worker_id, e)
                    break
                if msg is _wire.TICK:
                    continue
                if msg is None:
                    break
                hb.beat()
                verb = msg[0]
                # hello is ONCE per session (codec is None): a re-hello
                # after the codec is fixed falls through to the
                # unexpected-frame break — it must not renegotiate the
                # session codec mid-stream
                if verb == "hello" and handle is None and codec is None:
                    # proto-2 worker: negotiate the session codec before
                    # the join (the frontdoor handshake, control-plane
                    # shape — the worker speaks first here, so there is
                    # no bootstrap frame to skip)
                    try:
                        _, codec = _wire.negotiate(
                            msg[1] if len(msg) > 1
                            and isinstance(msg[1], dict) else {},
                            self._wire_mode, self._wire_compat)
                    except _wire.FrameError as e:
                        _wire.send_msg(sock, ("hello_reject", None,
                                              str(e)),
                                       auth_key=self._auth_key,
                                       codec=_wire.CODEC_SAFE)
                        break
                    _wire.send_msg(
                        sock, ("hello_ack", None,
                               {"proto": _wire.PROTO_VERSION,
                                "codec": codec}),
                        auth_key=self._auth_key, codec=codec,
                        limits=self._codec_limits)
                elif verb == "join" and handle is None:
                    if codec is None:
                        # hello-less join: a previous-protocol worker —
                        # its session speaks pickle (compat admitted it)
                        codec = _wire.CODEC_PICKLE
                    handle = self._handle_join(sock, addr, msg[1], codec)
                    if handle is None:
                        break       # rejected; reply already sent
                elif verb == "heartbeat" and handle is not None:
                    self._handle_heartbeat(handle, msg[1])
                elif verb in ("ok", "err") and handle is not None:
                    self._handle_ack(handle, msg)
                else:
                    _log.warning("fleet: unexpected control frame %r "
                                 "from %s", verb, addr)
                    break
        finally:
            hb.close()
            _teardown(sock)
            # the control channel IS the heartbeat carrier: without it
            # no heartbeat can arrive, so don't wait out the full
            # suspect age — age the handle to the SUSPECT threshold and
            # let the next monitor tick route around it (a SIGTERM'd
            # scale-down or a crash stops receiving traffic within one
            # tick instead of several heartbeat periods; a quick
            # reconnect/heartbeat still recovers it)
            if handle is not None and handle.conn is sock:
                handle.conn = None
                with self._lock:
                    if handle.state == ALIVE:
                        handle.last_hb = min(
                            handle.last_hb,
                            time.monotonic() - self._suspect_after_s)

    # ------------------------------------------------------------------
    # join / admission (warmup + half-open probe)
    # ------------------------------------------------------------------
    def _handle_join(self, sock, addr, info, codec):
        worker_id = str(info.get("worker_id") or "%s:%s" % addr)
        try:
            _faults.fault_point("fleet.join", worker=worker_id)
            return self._admit(sock, addr, worker_id, info, codec)
        except Exception as e:
            with self._lock:
                self._counters["rejects"] += 1
            _log.warning("fleet: rejecting worker %s: %s", worker_id, e)
            try:
                _wire.send_msg(sock, ("reject", "%s: %s"
                                      % (type(e).__name__, e)),
                               auth_key=self._auth_key, codec=codec,
                               limits=self._codec_limits)
            except OSError:
                # the rejected worker may already be gone; the verdict
                # frame is best-effort
                pass
            return None

    def _admit(self, sock, addr, worker_id, info, codec):
        from .. import profiler as _prof
        port = int(info.get("port") or 0)
        if port <= 0:
            raise MXNetError("join carries no dispatch port")
        host = str(info.get("host") or addr[0])
        if not info.get("warmed"):
            raise MXNetError("worker engines are not warmed — warm up "
                             "before joining (readmission rule)")
        models = sorted(set(info.get("models") or ())
                        & set(self._server.models()))
        if not models:
            raise MXNetError(
                "worker offers no model the gateway serves (offered %s, "
                "gateway has %s)" % (sorted(info.get("models") or ()),
                                     self._server.models()))
        with self._lock:
            prior = self._workers.get(worker_id)
            rejoin = prior is not None
        if prior is not None:
            was_dead = prior.state == DEAD
            if not was_dead:
                # a live handle under this id: the old incarnation's
                # control channel may merely have dropped — retire it
                # first so the new connection owns the id
                self._mark_dead(prior, reason="superseded by rejoin")
            # the superseded handle leaves self._workers below, so its
            # dispatch client must retire or its reader threads and
            # sockets leak once per death/rejoin cycle. ALWAYS on a
            # delay, never an immediate close: even a handle that was
            # already DEAD may still be running fail_over's
            # resolve-by-id recovery (DEAD is declared on heartbeat age
            # — a worker that stalled past dead_after and rejoined
            # within its 0.5s backoff is the common case), and close()
            # would typed-fail results its orphan store already holds
            if prior.client is not None:
                self._retire_client(prior.client)
        handle = WorkerHandle(worker_id, host, port,
                              pid=info.get("pid"), codec=codec)
        handle.conn = sock
        # HALF-OPEN PROBE (the breaker idiom, host-scale): exactly one
        # self-predict per model must succeed before any traffic routes
        # here — a worker that died mid-life and restarted cold (or
        # wedged during warmup) is refused readmission
        probe_rid = self._next_rid(handle)
        self._send_cmd(handle, ("probe", probe_rid))
        reply = self._await_probe(sock, probe_rid, codec)
        if reply[0] != "probe_ok":
            with self._lock:
                self._counters["probe_failures"] += 1
            raise MXNetError("half-open probe failed: %s"
                             % (reply[2] if len(reply) > 2 else reply,))
        # dispatch plane: pooled client to the worker's own front door.
        # Any failure from here to full attachment must unwind — a
        # leaked client (reader thread + sockets, once per rejoin
        # attempt) or a half-attached model (routable replicas with no
        # supervising handle) would outlive the rejected join
        # the dispatch client's codec comes from what the worker's join
        # ADVERTISES ("codecs" — absent from a previous-protocol join,
        # whose front door only speaks pickle; an old pool ignores the
        # key, the forward-compat rule both ways): a v-new gateway keeps
        # dispatching to a v-old worker through a rolling upgrade
        offered = [str(c) for c in (info.get("codecs")
                                    or (_wire.CODEC_PICKLE,))]
        dispatch_mode = _wire.CODEC_SAFE \
            if (self._wire_mode == _wire.CODEC_SAFE
                and _wire.CODEC_SAFE in offered) else _wire.CODEC_PICKLE
        client = ServingClient(host, port, pool_size=2,
                               connect_deadline_s=self._connect_deadline_s,
                               resubmits=1, auth_key=self._auth_key,
                               wire_mode=dispatch_mode)
        try:
            client.ping(timeout=self._probe_timeout_s)
            handle.client = client
            for model in models:
                replica = RemoteReplica(self, handle, model)
                handle.replicas[model] = self._server.add_replicas(
                    model, [replica])
        except BaseException:
            self._detach(handle, reason="admission failed")
            client.close()
            raise
        if prior is not None and prior.replicas:
            # a dead predecessor whose removal the last-replica guard
            # refused (no other capacity at the time): NOW there is a
            # fresh replica, so the stale wrapper can finally detach
            self._detach(prior, reason="superseded by rejoin")
        with self._lock:
            # admission (probe + dispatch connect) can take whole
            # seconds: stamp freshness NOW or the first scan() judges
            # the worker by its construction time and may evict the
            # just-admitted host before its first heartbeat lands
            handle.last_hb = time.monotonic()
            self._workers[worker_id] = handle
            self._counters["rejoins" if rejoin else "joins"] += 1
        _prof.record_fleet_event("rejoin" if rejoin else "join")
        self._send_cmd(handle, ("joined",
                                {"worker_id": worker_id,
                                 "heartbeat_s": self._heartbeat_s}))
        _log.info("fleet: worker %s joined (%s:%d, models %s%s)",
                  worker_id, host, port, models,
                  ", READMITTED after death" if rejoin else "")
        return handle

    def _await_probe(self, sock, probe_rid, codec):
        """Block this control reader until the worker answers the probe
        (heartbeats may interleave; they are consumed, not lost)."""
        deadline = time.monotonic() + self._probe_timeout_s
        while time.monotonic() < deadline:
            msg = _wire.recv_msg_tick(
                sock, auth_key=self._auth_key,
                allow_pickle=codec == _wire.CODEC_PICKLE,
                limits=self._codec_limits)
            if msg is _wire.TICK:
                continue
            if msg is None:
                raise MXNetError("worker hung up during the probe")
            if msg[0] in ("probe_ok", "probe_err") and msg[1] == probe_rid:
                return msg
            if msg[0] == "heartbeat":
                continue            # pre-admission heartbeat: ignore
        raise MXNetError("half-open probe timed out after %.1fs"
                         % self._probe_timeout_s)

    # ------------------------------------------------------------------
    # heartbeats + supervision
    # ------------------------------------------------------------------
    def _handle_heartbeat(self, handle, payload):
        from .. import profiler as _prof
        _faults.fault_point("fleet.heartbeat", worker=handle.worker_id,
                            side="gateway")
        now = time.monotonic()
        with self._lock:
            self._counters["heartbeats"] += 1
            handle.last_hb = now
            handle.health = payload.get("health")
            recovered = handle.state == SUSPECT
            if recovered:
                handle.state = ALIVE
                self._counters["recoveries"] += 1
                for reps in handle.replicas.values():
                    for rep in reps:
                        rep.available = True
        if recovered:
            _prof.record_fleet_event("recovery")
            _log.info("fleet: worker %s heartbeating again — back to "
                      "ALIVE", handle.worker_id)

    def _monitor_loop(self):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("fleet:monitor",
                                  thread=threading.current_thread())
        interval = min(1.0, self._heartbeat_s / 2.0)
        try:
            while not self._stop_evt.wait(interval):
                hb.beat()
                self.scan()
                hb.idle()
        finally:
            hb.close()

    def _retire_client(self, client, grace_s=30.0):
        """Queue a superseded dispatch client for deferred close: its
        readers may still be running resolve-by-id recovery for
        in-flight requests (close() would typed-fail them); the monitor
        closes it after the grace."""
        with self._lock:
            self._retired.append((time.monotonic() + grace_s, client))

    def scan(self, now=None):
        """One supervision pass (the monitor calls this on its cadence;
        tests call it directly for determinism). Returns the number of
        state transitions."""
        from .. import profiler as _prof
        now = time.monotonic() if now is None else now
        suspects, deads = [], []
        with self._lock:
            due = [c for t, c in self._retired if t <= now]
            self._retired = [(t, c) for t, c in self._retired if t > now]
        for client in due:
            client.close()
        with self._lock:
            # reap long-DEAD handles: autoscaler-launched workers carry
            # fresh uuid ids, so dead entries would otherwise accumulate
            # one per death/scale-down forever (the grace keeps same-id
            # rejoins counted as rejoins and recovery races closed)
            reap_after = max(30.0, 4.0 * self._dead_after_s)
            reaped = [wid for wid, h in self._workers.items()
                      if h.state == DEAD and now - h.last_hb > reap_after]
            reaped = [self._workers.pop(wid) for wid in reaped]
            for handle in self._workers.values():
                age = now - handle.last_hb
                if handle.state == ALIVE and age > self._suspect_after_s:
                    handle.state = SUSPECT
                    handle.suspects += 1
                    self._counters["suspects"] += 1
                    for reps in handle.replicas.values():
                        for rep in reps:
                            rep.available = False
                    suspects.append(handle)
                elif handle.state == SUSPECT and age > self._dead_after_s:
                    deads.append(handle)
        for handle in reaped:
            if handle.client is not None:
                handle.client.close()
            _log.info("fleet: reaped long-dead worker %s",
                      handle.worker_id)
        for handle in suspects:
            _prof.record_fleet_event("suspect")
            _log.warning("fleet: worker %s missed heartbeats for %.1fs — "
                         "SUSPECT (routing around it)", handle.worker_id,
                         now - handle.last_hb)
        for handle in deads:
            self._mark_dead(handle, reason="missed heartbeats for %.1fs"
                            % (now - handle.last_hb))
        return len(suspects) + len(deads)

    def _mark_dead(self, handle, reason):
        from .. import profiler as _prof
        with self._lock:
            if handle.state == DEAD:
                return
            handle.state = DEAD
            handle.deaths += 1
            self._counters["deads"] += 1
        _prof.record_fleet_event("dead")
        _log.warning("fleet: worker %s is DEAD (%s) — detaching replicas, "
                     "resolving in-flight by id", handle.worker_id, reason)
        self._detach(handle, reason=reason)
        conn = handle.conn
        if conn is not None:
            _teardown(conn)
        # resolve-by-id: break the dispatch transports WITHOUT closing
        # the client — each reader runs the client's recovery (reconnect,
        # ("resolve", rids) against the worker's orphan store; only
        # proven-unknown requests flow back into the ModelServer's
        # resubmit machinery). A SIGKILLed worker fails the reconnect
        # inside connect_deadline_s and the same path resolves typed.
        if handle.client is not None:
            handle.client.fail_over()

    def _detach(self, handle, reason):
        """Remove the worker's replicas from the routing table. When a
        model would be left with NO replica (no local floor), the
        wrapper stays attached-but-unavailable — degraded beats
        unroutable, and the forced-probe fallback may still try it."""
        for model, reps in list(handle.replicas.items()):
            for rep in reps:
                rep.available = False
            try:
                self._server.remove_replicas(model, reps)
                del handle.replicas[model]
            except MXNetError as e:
                # the last-replica guard refused the removal: degraded
                # but routable beats an empty table; the replicas stay
                # attached with available=False
                _log.warning("fleet: keeping DEAD worker %s attached to "
                             "model %s (%s)", handle.worker_id, model, e)

    # ------------------------------------------------------------------
    # worker commands (rollover fan-out, drain)
    # ------------------------------------------------------------------
    def _next_rid(self, handle):
        with handle.send_lock:
            handle.seq += 1
            return "f%s-%d" % (handle.worker_id, handle.seq)

    def _send_cmd(self, handle, frame):
        conn = handle.conn
        if conn is None:
            raise MXNetError("no control channel to worker %s"
                             % handle.worker_id)
        with handle.send_lock:
            # stall-tolerant: the control socket carries a short poll
            # timeout, and a rollover frame shipping real model weights
            # takes far longer than one tick — plain sendall would
            # raise mid-frame and desync the channel (the front door's
            # big-reply rule, applied to the control plane)
            _wire.send_msg_stall(conn, frame, auth_key=self._auth_key,
                                 codec=handle.codec,
                                 limits=self._codec_limits)

    def _handle_ack(self, handle, msg):
        rec = handle.acks.get(msg[1])
        if rec is not None:
            rec[1] = msg
            rec[0].set()

    def _rollover_worker(self, handle, model, arg_params, aux_params,
                         timeout=120.0):
        """Ship a weight rollover to one worker over the control channel
        and wait for its ack (`RemoteReplica.update_params` — called by
        `ModelServer.rollover`'s fan-out loop)."""
        rid = self._next_rid(handle)
        rec = [threading.Event(), None]
        handle.acks[rid] = rec
        try:
            self._send_cmd(handle, ("rollover", rid, model,
                                    _host_params(arg_params),
                                    _host_params(aux_params)))
            if not rec[0].wait(timeout):
                raise MXNetError("rollover ack from worker %s timed out"
                                 % handle.worker_id)
            reply = rec[1]
            if reply[0] != "ok":
                raise MXNetError("worker %s rollover failed: %s"
                                 % (handle.worker_id, reply[2]))
        finally:
            handle.acks.pop(rid, None)

    def drain_worker(self, worker_id, timeout=30.0):
        """Ask one worker to drain and exit (the autoscaler's graceful
        scale-down path): detach its replicas from routing FIRST so no
        new dispatch lands there, then send the drain command — its
        in-flight work resolves through the normal completion path."""
        with self._lock:
            handle = self._workers.get(worker_id)
        if handle is None:
            raise MXNetError("unknown worker %r" % worker_id)
        self._detach(handle, reason="drain")
        rid = self._next_rid(handle)
        rec = [threading.Event(), None]
        handle.acks[rid] = rec
        try:
            self._send_cmd(handle, ("drain", rid))
            rec[0].wait(timeout)
        finally:
            handle.acks.pop(rid, None)
        return True

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def workers(self):
        with self._lock:
            return {wid: handle.describe()
                    for wid, handle in self._workers.items()}

    def stats(self):
        with self._lock:
            out = dict(self._counters)
            out["workers"] = {wid: handle.describe()
                              for wid, handle in self._workers.items()}
            out["workers_alive"] = sum(
                1 for h in self._workers.values() if h.state == ALIVE)
        return out

    def health(self):
        """The AUTOSCALER's merged signal: the gateway `ModelServer`'s
        health (authoritative request accounting — remote dispatches
        already count there exactly once) with each model's queue-wait
        p95 widened by the workers' own reported queue waits (remote
        queueing happens on the worker; the gateway must not scale on a
        signal that can't see it), plus the per-worker fleet view."""
        health = self._server.health()
        with self._lock:
            worker_healths = [
                (h.worker_id, h.state, h.health)
                for h in self._workers.values()]
        for _wid, state, whealth in worker_healths:
            if state != ALIVE or not whealth:
                continue
            for name, wmodel in (whealth.get("models") or {}).items():
                gmodel = health["models"].get(name)
                if gmodel is None:
                    continue
                for key in ("queue_wait_p95_ms", "queue_wait_p50_ms",
                            "device_p95_ms"):
                    wval = wmodel.get(key)
                    if wval is not None and (gmodel.get(key) is None
                                             or wval > gmodel[key]):
                        gmodel[key] = wval
        health["workers"] = {wid: {"state": state}
                             for wid, state, _ in worker_healths}
        health["workers_alive"] = sum(
            1 for _w, state, _h in worker_healths if state == ALIVE)
        return health


def _host_params(params):
    """Weight dict normalized to host values for the control channel:
    the safe wire carries plain data, not framework handles. NDArrays
    and tensors (on the card or the CPU) become host numpy arrays, a
    bfloat16 tensor a CPU tensor (`codec.host_value`). The worker
    lifts them back to tensors on its device, so the rollover path the
    engines see is unchanged."""
    if not params:
        return params
    import numpy as _np
    import torch
    from .codec import host_value
    out = {}
    for name, val in params.items():
        val = host_value(val)
        out[name] = val if isinstance(val, torch.Tensor) \
            else _np.asarray(val)
    return out


_teardown = _wire.teardown
