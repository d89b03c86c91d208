"""ReplicaWorker — one fleet worker HOST: engine replicas behind their
own front door, supervised by a gateway's `FleetPool`.

Counterpart of ``mxnet_tpu/serving/worker.py``. The worker is
deliberately built from parts that already exist:

* its **dispatch plane** is a local `ModelServer` behind a local
  `ServingFrontDoor` — so the orphan store, resolve-by-id protocol,
  per-peer eviction, drain semantics and the exactly-once accounting
  all come unchanged (the gateway's `RemoteReplica` is just
  a `ServingClient` of this front door);
* its **control plane** is one outbound connection to the gateway's
  fleet port: ``("join", info)`` on connect, ``("heartbeat", ...)`` on a
  supervised cadence, and command handling (``probe`` — the half-open
  readmission check, ``rollover`` — weight fan-out, ``drain`` —
  graceful scale-down). The control loop carries a watchdog heartbeat
  and reconnects with backoff when the gateway drops — a worker
  OUTLIVES a gateway restart and rejoins by itself.

CLI (what `LocalProcessLauncher` spawns)::

    python -m mxnet_tpu_torch.serving.worker \
        --gateway 127.0.0.1:9612 --builder mymodels:build --port 0

``--builder mod:fn`` names an importable callable returning a populated
(and WARMED — the pool refuses unwarmed workers) `ModelServer`. Its
engines run where the builder put them: the card (``cuda:0``) unless it
asked for the CPU. On the card the builder should capture every bucket
(``warmup_shapes``) before it returns: a capture beside live traffic
holds the card's capture lock, and every replay waits behind it.
"""
from __future__ import annotations

import argparse
import logging
import os
import socket
import threading
import time
import uuid

import numpy as _np

from ..base import MXNetError, get_env
from ..resilience import faults as _faults
from . import wire as _wire
from .frontdoor import ServingFrontDoor
from .server import ModelServer

__all__ = ["ReplicaWorker"]

_log = logging.getLogger(__name__)


class ReplicaWorker:
    """Host a ModelServer's replicas as one fleet worker process.

    Parameters
    ----------
    gateway : str or (host, port)
        The gateway FleetPool's control address (``"host:port"``).
    server : ModelServer
        The populated local serving tier (models registered AND warmed —
        the pool's admission requires it).
    host : str
        Dispatch-plane bind AND advertise address. Default None: the
        front door binds ``MXNET_SERVING_FRONTDOOR_BIND`` and the join
        advertises no host, so the gateway dials the address it
        OBSERVES on the control connection — correct cross-host with
        zero configuration once the front door binds a routable
        interface.
    port : int
        Dispatch (front door) port; 0 binds ephemeral.
    worker_id : str, optional
        Stable identity across restarts (default: ``host-pid-rand``). A
        restarted worker reusing its id is READMITTED — after the warmup
        + half-open-probe checks.
    heartbeat_s : float, optional
        Initial heartbeat cadence until the gateway's ``joined`` reply
        supplies the authoritative one
        (``MXNET_SERVING_FLEET_HEARTBEAT_S``).
    auth_key : shared HMAC frame key (``MXNET_SERVING_AUTH_KEY``).
    """

    def __init__(self, gateway, server, host=None, port=0, worker_id=None,
                 heartbeat_s=None, auth_key=None, rejoin_backoff_s=0.5,
                 wire_mode=None):
        if isinstance(gateway, str):
            ghost, _, gport = gateway.rpartition(":")
            gateway = (ghost or "127.0.0.1", int(gport))
        self._gateway = (gateway[0], int(gateway[1]))
        if not isinstance(server, ModelServer):
            raise MXNetError("ReplicaWorker needs a ModelServer, got %r"
                             % type(server).__name__)
        self._server = server
        self._frontdoor = ServingFrontDoor(server, host=host, port=port,
                                           auth_key=auth_key,
                                           wire_mode=wire_mode)
        self.worker_id = worker_id or "%s-%d-%s" % (
            socket.gethostname(), os.getpid(), uuid.uuid4().hex[:6])
        if heartbeat_s is None:
            heartbeat_s = get_env("MXNET_SERVING_FLEET_HEARTBEAT_S",
                                  2.0, float)
        self._heartbeat_s = float(heartbeat_s)
        self._auth_key = _wire.normalize_auth_key(auth_key)
        # control-channel wire codec, read ONCE: "safe" sends
        # a proto-2 hello before the join and never unpickles gateway
        # bytes; "pickle" is the previous protocol byte-for-byte (the
        # escape hatch against a v-old gateway, and the rolling-upgrade
        # test double)
        self._wire_mode = _wire.resolve_wire_mode(wire_mode)
        from . import codec as _codec
        self._codec_limits = _codec.Limits()
        self._codec = _wire.CODEC_PICKLE   # per-session; set at handshake
        self._rejoin_backoff_s = float(rejoin_backoff_s)
        self._reject_streak = 0   # escalates the retry wait after rejects
        self._advertise_host = host
        self._send_lock = threading.Lock()  # control sends come from the
        #                                     session loop AND command
        #                                     worker threads (rollover)
        self._stop_evt = threading.Event()
        self._control_thread = None
        self._started = False
        self.joined = threading.Event()    # observability: admitted once
        self.stats = {"joins": 0, "rejects": 0, "heartbeats": 0,
                      "reconnects": 0, "rollovers": 0, "probes": 0}

    # ------------------------------------------------------------------
    @property
    def port(self):
        return self._frontdoor.port

    def warmed(self):
        """True when every registered model's engines learned their
        input templates (warmup ran) — what the join reports and the
        gateway's admission requires."""
        for name in self._server.models():
            eng = self._server.engine(name)
            if not getattr(eng, "_templates", None):
                return False
        return True

    def start(self):
        if self._started:
            raise MXNetError("worker already started")
        self._started = True
        self._frontdoor.start()
        self._control_thread = threading.Thread(
            target=self._control_loop, name="mx-fleet-worker-control",
            daemon=True)
        self._control_thread.start()
        return self

    def wait(self, timeout=None):
        """Block until the worker stops (drain command, :meth:`stop`, or
        SIGTERM via the front door's drain chain)."""
        self._stop_evt.wait(timeout)
        return self._stop_evt.is_set()

    def stop(self):
        self._stop_evt.set()
        thread = self._control_thread
        if thread is not None and thread.is_alive() \
                and thread is not threading.current_thread():
            thread.join(timeout=10.0)
        self._frontdoor.drain(timeout=30.0)
        self._server.stop()

    # ------------------------------------------------------------------
    # control loop (join -> heartbeat/commands -> reconnect)
    # ------------------------------------------------------------------
    def _join_info(self):
        # host None when unconfigured: the pool falls back to the
        # address it OBSERVES on the control connection — the one
        # address that provably routes back to this worker cross-host
        info = {"worker_id": self.worker_id,
                "host": self._advertise_host,
                "port": self._frontdoor.port,
                "pid": os.getpid(),
                "models": {name: {"versions":
                                  [str(v)
                                   for v in self._server.versions(name)]}
                           for name in self._server.models()},
                "warmed": self.warmed()}
        if self._wire_mode == _wire.CODEC_SAFE:
            # advertise what this worker's DISPATCH plane (its front
            # door) speaks — the gateway derives its ServingClient codec
            # from this; a previous-protocol pool ignores the key (the
            # unknown-map-keys forward-compat rule). In pickle mode the
            # key is OMITTED, exactly the shape a v-old join has, so
            # wire_mode=pickle is a faithful previous-protocol double.
            info["codecs"] = self._frontdoor._offered_codecs()
        return info

    def _control_loop(self):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("fleet:worker:%s" % self.worker_id,
                                  thread=threading.current_thread())
        backoff = self._rejoin_backoff_s
        try:
            while not self._stop_evt.is_set():
                try:
                    sock = socket.create_connection(self._gateway,
                                                    timeout=10.0)
                except OSError as e:
                    hb.idle()
                    _log.debug("fleet worker: gateway not reachable "
                               "(%s); retrying in %.1fs", e, backoff)
                    if self._stop_evt.wait(backoff):
                        break
                    backoff = min(backoff * 2.0, 10.0)
                    continue
                backoff = self._rejoin_backoff_s
                try:
                    self._session(sock, hb)
                except Exception as e:
                    # ANY session failure — transport death, a frame
                    # that unpickles to garbage from a version-skewed
                    # gateway, a command handler bug — means rejoin,
                    # never process death: the gateway self-heals from
                    # the same frame (only its control thread recycles)
                    # and the worker must not turn it into permanent
                    # capacity loss
                    self.stats["reconnects"] += 1
                    _log.warning("fleet worker: control session failed "
                                 "(%s: %s) — rejoining",
                                 type(e).__name__, e)
                finally:
                    _teardown(sock)
                if not self._stop_evt.is_set():
                    # a REJECTED worker (unwarmed, no shared model) must
                    # back off exponentially — the connect succeeds every
                    # round, so the connect-failure backoff never engages
                    # and a fixed cadence would hammer the gateway
                    self._stop_evt.wait(min(
                        self._rejoin_backoff_s
                        * (2 ** min(self._reject_streak, 6)), 30.0))
        finally:
            hb.close()
            self._stop_evt.set()

    def _send(self, sock, frame):
        """One control frame out, serialized: the session loop
        (heartbeats, acks) and command worker threads (rollover) share
        the socket and must never interleave mid-frame. Stall-tolerant:
        the socket carries a sub-second poll timeout, and a frame
        larger than one tick's worth of bytes must not desync the
        channel."""
        with self._send_lock:
            _wire.send_msg_stall(sock, frame, auth_key=self._auth_key,
                                 codec=self._codec,
                                 limits=self._codec_limits)

    def _session(self, sock, hb):
        """One connected control session: join, then heartbeat + serve
        commands until the socket (or the worker) dies."""
        # the recv tick quantizes WHEN heartbeats can send: it must be
        # well under the cadence, or a fast cadence (tests/bench run
        # 0.25s) sends at the tick period instead and the effective
        # heartbeat age brushes the pool's 2x-cadence SUSPECT threshold
        sock.settimeout(min(0.5, self._heartbeat_s / 2.0))
        self._codec = _wire.CODEC_PICKLE
        if self._wire_mode == _wire.CODEC_SAFE:
            self._codec = self._hello(sock)
        self._send(sock, ("join", self._join_info()))
        last_hb_sent = time.monotonic()
        while not self._stop_evt.is_set():
            hb.idle()
            msg = _wire.recv_msg_tick(
                sock, auth_key=self._auth_key,
                allow_pickle=self._codec == _wire.CODEC_PICKLE,
                limits=self._codec_limits)
            now = time.monotonic()
            if msg is None:
                raise OSError("gateway closed the control channel")
            if msg is not _wire.TICK:
                hb.beat()
                if not self._handle_cmd(sock, msg):
                    return           # drain: clean session end
            if now - last_hb_sent >= self._heartbeat_s:
                # an injected fault here (site fleet.heartbeat,
                # side=worker) SKIPS sends without killing the loop —
                # exactly a worker whose heartbeats stop arriving
                try:
                    _faults.fault_point("fleet.heartbeat",
                                        worker=self.worker_id,
                                        side="worker")
                except Exception as e:
                    # an injected fleet.heartbeat fault must SKIP the send
                    # (simulating missed heartbeats), never kill the loop
                    _log.debug("fleet worker: heartbeat suppressed by "
                               "injected fault: %s", e)
                else:
                    with_health = {"worker_id": self.worker_id,
                                   "health": self._server.health(),
                                   "ts": time.time()}
                    self._send(sock, ("heartbeat", with_health))
                    self.stats["heartbeats"] += 1
                last_hb_sent = now

    def _hello(self, sock):
        """Proto-2 control handshake: offer (protos, codecs) in a safe
        hello, adopt the gateway's pick from the hello_ack. The worker
        speaks first on the control channel, so unlike the serving
        client there is no legacy bootstrap frame to skip. A gateway
        that rejects (or a v-old gateway that drops the session on the
        unknown verb) surfaces as a failed session — the reconnect
        loop's backoff owns recovery either way."""
        _wire.send_msg(
            sock, ("hello", {"protos": list(_wire.SUPPORTED_PROTOS),
                             "codecs": [_wire.CODEC_SAFE],
                             "lib": "mxnet_tpu_torch"}),
            auth_key=self._auth_key, codec=_wire.CODEC_SAFE,
            limits=self._codec_limits)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            msg = _wire.recv_msg_tick(sock, auth_key=self._auth_key,
                                      allow_pickle=False,
                                      limits=self._codec_limits)
            if msg is _wire.TICK:
                continue
            if msg is None:
                raise OSError("gateway hung up during the wire "
                              "handshake (previous-protocol gateway? "
                              "set MXNET_SERVING_WIRE=pickle)")
            if msg[0] == "hello_reject":
                raise OSError("gateway refused the wire handshake: %s"
                              % (msg[2] if len(msg) > 2 else msg,))
            if msg[0] == "hello_ack":
                info = msg[2] if len(msg) > 2 \
                    and isinstance(msg[2], dict) else {}
                return str(info.get("codec") or _wire.CODEC_SAFE)
            raise OSError("unexpected frame %r during the wire "
                          "handshake" % (msg[0],))
        raise OSError("wire handshake timed out")

    def _handle_cmd(self, sock, msg):
        """One gateway command. Returns False when the session should
        end (drain)."""
        verb = msg[0]
        if verb == "joined":
            self._heartbeat_s = float(
                msg[1].get("heartbeat_s", self._heartbeat_s))
            sock.settimeout(min(0.5, self._heartbeat_s / 2.0))
            self.stats["joins"] += 1
            self._reject_streak = 0
            self.joined.set()
        elif verb == "reject":
            self.stats["rejects"] += 1
            self._reject_streak += 1
            _log.warning("fleet worker: gateway rejected join: %s", msg[1])
            raise OSError("join rejected: %s" % (msg[1],))
        elif verb == "probe":
            self.stats["probes"] += 1
            try:
                report = self._self_probe()
            except Exception as e:
                self._send(sock, ("probe_err", msg[1],
                                  "%s: %s" % (type(e).__name__, e)))
            else:
                self._send(sock, ("probe_ok", msg[1], report))
        elif verb == "rollover":
            # apply OFF the session thread: a big-model re-stage (device
            # puts, quantized re-fold) can outlast the DEAD threshold,
            # and a worker must never get itself evicted by the very
            # rollover the gateway asked for — heartbeats keep flowing
            # while the weights swap, and the ack ships when done
            threading.Thread(
                target=self._apply_rollover,
                args=(sock, msg[1], msg[2], msg[3], msg[4]),
                name="mx-fleet-worker-rollover", daemon=True).start()
        elif verb == "drain":
            self._send(sock, ("ok", msg[1]))
            _log.info("fleet worker: drain requested — exiting")
            self._stop_evt.set()
            return False
        elif verb == "ping":
            self._send(sock, ("pong", msg[1]))
        else:
            _log.warning("fleet worker: unknown control verb %r", verb)
        return True

    def _apply_rollover(self, sock, rid, model, arg_params, aux_params):
        try:
            # the wire delivers host numpy (the safe codec's schema; a
            # bfloat16 weight as a CPU tensor): lift it to tensors on the
            # model's device, so the engines' rollover path sees what
            # an in-process caller hands it
            import torch
            device = self._server.engine(model).device

            def _lift(params):
                if not params:
                    return params
                return {name: torch.from_numpy(val).to(device)
                        if isinstance(val, _np.ndarray) else
                        val.to(device) if isinstance(val, torch.Tensor)
                        else val for name, val in params.items()}

            self._server.rollover(model, _lift(arg_params),
                                  _lift(aux_params))
            self.stats["rollovers"] += 1
        except Exception as e:
            reply = ("err", rid, "%s: %s" % (type(e).__name__, e))
        else:
            reply = ("ok", rid)
        try:
            self._send(sock, reply)
        except OSError:
            # the control channel died mid-rollover: the gateway's ack
            # wait times out and the reconnect loop owns recovery
            pass

    def _self_probe(self):
        """The half-open readmission check: ONE real synchronous predict
        per model through the local serving tier, using the engines'
        learned templates — proves warmup ran and the device path
        executes, before the gateway routes any traffic here."""
        report = {}
        for name in self._server.models():
            eng = self._server.engine(name)
            templates = dict(getattr(eng, "_templates", None) or {})
            if not templates:
                raise MXNetError("model %r has no learned input "
                                 "templates — not warmed" % name)
            probe = {iname: _np.zeros((1,) + shape[1:], dtype)
                     for iname, (shape, dtype) in templates.items()}
            tic = time.monotonic()
            self._server.predict(name, probe)
            report[name] = {"ok": True,
                            "ms": round((time.monotonic() - tic) * 1e3, 2)}
        return report


_teardown = _wire.teardown


# ---------------------------------------------------------------------
# CLI entry (what the autoscaler's LocalProcessLauncher spawns)
# ---------------------------------------------------------------------
def _resolve_builder(spec):
    """``mod.sub:fn`` -> the callable. The builder returns a populated,
    WARMED ModelServer (the admission contract)."""
    mod_name, sep, fn_name = spec.partition(":")
    if not sep:
        raise MXNetError("--builder must look like module:function, got %r"
                         % spec)
    import importlib
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name, None)
    if not callable(fn):
        raise MXNetError("builder %r is not callable" % spec)
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="mxnet_tpu_torch serving fleet worker")
    ap.add_argument("--gateway", required=True,
                    help="gateway fleet control address host:port")
    ap.add_argument("--builder", required=True,
                    help="module:function returning a warmed ModelServer")
    ap.add_argument("--port", type=int, default=0,
                    help="dispatch (front door) port; 0 = ephemeral")
    ap.add_argument("--host", default=None,
                    help="dispatch bind + advertise address (default: "
                         "bind MXNET_SERVING_FRONTDOOR_BIND, advertise "
                         "the address the gateway observes)")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--heartbeat-s", type=float, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s fleet-worker %(levelname)s %(message)s")
    server = _resolve_builder(args.builder)()
    worker = ReplicaWorker(args.gateway, server, host=args.host,
                           port=args.port, worker_id=args.worker_id,
                           heartbeat_s=args.heartbeat_s).start()
    # SIGTERM = graceful scale-down: drain the front door (resolve
    # in-flight, flush replies), then fall through to exit
    worker._frontdoor.install_sigterm_drain()
    _log.info("fleet worker %s serving on port %d (gateway %s)",
              worker.worker_id, worker.port, args.gateway)
    try:
        worker.wait()
    except KeyboardInterrupt:
        pass  # Ctrl-C falls through to the same graceful stop as a drain
    worker.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
