"""Length-prefixed binary wire framing: one definition for every TCP
tier of the port (the serving front door, its client, the fleet control
channel, and the kvstore transport's wrappers at the end).

Counterpart of ``mxnet_tpu/serving/wire.py``; the bytes on the wire are
the reference's, so a port endpoint and a reference endpoint talk to
each other.

Frame layout: an 8-byte little-endian unsigned length header followed by
an encoded payload. The payload encoding is pluggable: the safe
non-executable codec (``serving/codec.py``, the serving default) or
legacy pickle (the kvstore transport's trusted default, for one job's
own cluster network only).

A connection that closes AT a frame boundary is a client hanging up
cleanly (``recv_msg`` returns None), while a close MID-frame, or a
header whose length exceeds the frame cap, is a broken or misbehaving
peer and raises :class:`FrameError` (what the front door's
per-connection eviction counts strikes on). The kvstore wrappers
(:func:`kv_send_msg` / :func:`kv_recv_msg`) keep the transport's "any
EOF is None" contract.

Frame authentication: when a call supplies ``auth_key``, every frame's
payload is prefixed with an HMAC-SHA256 tag over the encoded bytes, and
the receive side verifies the tag BEFORE the payload is decoded, so a
frame from a peer without the shared key is rejected as
:class:`AuthError` while it is still inert bytes. The serving tier
(front door, client, fleet control channel) reads the shared key from
``MXNET_SERVING_AUTH_KEY`` once at construction; the kvstore wrappers
keep their trusted no-auth default.

Wire codec: ``MXNET_SERVING_WIRE=safe`` (the default for the front door,
the serving client and the fleet control channel) encodes every frame
with the bounded, NON-EXECUTABLE codec of ``serving/codec.py``;
``pickle`` keeps the previous protocol byte for byte. The receive path
is sniff-based: a safe frame (magic ``b"MXW1"``; pickles always start
``b"\\x80"``) decodes safely whatever the endpoint's mode, while a
legacy pickle frame is accepted only where the endpoint's compat policy
allows it (``MXNET_SERVING_WIRE_COMPAT``, default on: an old peer keeps
being served through a rolling upgrade; set 0 afterwards and the
listening side never runs ``pickle.loads`` on network bytes again).
Protocol version negotiation rides hello frames (:func:`negotiate`).
:func:`decode_payload` is the one place in ``serving/`` that calls
``pickle.loads``. Auth composes with either codec: the MAC is verified
first, then the payload decodes.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import pickle
import socket as _socket
import struct

from ..base import MXNetError, get_env

__all__ = ["FrameError", "AuthError", "send_msg", "recv_msg",
           "recv_exact", "recv_msg_tick", "send_msg_stall", "TICK",
           "DEFAULT_MAX_FRAME_BYTES", "auth_key_from_env", "MAC_LEN",
           "teardown", "PROTO_VERSION", "SUPPORTED_PROTOS",
           "CODEC_SAFE", "CODEC_PICKLE", "wire_mode_from_env",
           "wire_compat_from_env", "encode_payload", "decode_payload",
           "recv_payload", "negotiate", "kv_send_msg", "kv_recv_msg"]

#: protocol versions this build speaks. 1 = the first wire (server
#: pickle hello, pickle frames, no negotiation). 2 = negotiated: the
#: client sends a ("hello", offer) frame, the server answers
#: ("hello_ack", conn_id, {"proto", "codec"}) picking the highest
#: common pair; unknown offer/ack map keys are IGNORED on both sides so
#: a proto-3 peer can extend the handshake without breaking us.
PROTO_VERSION = 2
SUPPORTED_PROTOS = (1, 2)

CODEC_SAFE = "safe"
CODEC_PICKLE = "pickle"
_CODECS = (CODEC_SAFE, CODEC_PICKLE)

# A corrupt or adversarial 8-byte header must not become a multi-TB
# allocation: frames above the cap raise FrameError instead. 1 GiB
# covers any realistic request batch (the serving tier pads to buckets
# of at most a few thousand rows) with orders of magnitude to spare.
DEFAULT_MAX_FRAME_BYTES = 1 << 30

_HEADER = struct.Struct("<Q")


class FrameError(MXNetError):
    """The byte stream stopped being a frame stream: EOF mid-frame, a
    length header above the frame cap, or an unpicklable payload. The
    connection that raised it is unusable (the next read would pair
    bytes with the wrong frame) and must be closed."""


class AuthError(FrameError):
    """Frame failed HMAC authentication (or arrived unauthenticated at
    an authenticated endpoint). Raised BEFORE the payload is unpickled —
    the whole point of the tag — and, being a FrameError, counts an
    eviction strike at the front door."""


#: HMAC-SHA256 digest length prefixed to every authenticated payload.
MAC_LEN = hashlib.sha256().digest_size

# AFTER the error types: codec.py imports FrameError from this module,
# so this module-object import must run once FrameError exists (both
# import orders then resolve — attribute access happens at call time)
from . import codec as _codec_mod            # noqa: E402


def wire_mode_from_env():
    """The serving tier's wire codec (``MXNET_SERVING_WIRE``): ``safe``
    (default — the non-executable codec) or ``pickle`` (the previous
    protocol, byte-for-byte). Read ONCE at endpoint construction."""
    return resolve_wire_mode(get_env("MXNET_SERVING_WIRE", CODEC_SAFE))


def resolve_wire_mode(mode=None):
    """THE constructor-time wire-mode rule, shared by every serving
    endpoint (front door, client, fleet pool, worker): ``None`` defers
    to the env var; anything else lowercases and validates — so an
    explicit ``wire_mode="SAFE"`` behaves exactly like
    ``MXNET_SERVING_WIRE=SAFE``."""
    if mode is None:
        return wire_mode_from_env()
    mode = str(mode).lower()
    if mode not in _CODECS:
        raise MXNetError("wire mode must be one of %s, got %r"
                         % ("/".join(_CODECS), mode))
    return mode


def wire_compat_from_env():
    """Rolling-upgrade tolerance (``MXNET_SERVING_WIRE_COMPAT``,
    default on): whether a safe-mode LISTENER still accepts legacy
    pickle frames from previous-protocol peers. Read once at endpoint
    construction; set 0 once the fleet is fully migrated and the
    listening side never unpickles network bytes again."""
    return bool(get_env("MXNET_SERVING_WIRE_COMPAT", True, bool))


def encode_payload(obj, codec=CODEC_PICKLE, limits=None):
    """One frame body (pre-MAC): safe-codec or pickle bytes."""
    if codec == CODEC_SAFE:
        return _codec_mod.encode(obj, limits)
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode_payload(payload, allow_pickle=True, limits=None):
    """Sniff-based frame decode — THE receive-side codec policy. A
    safe-codec frame (magic-prefixed) always decodes: it is inert data
    regardless of endpoint mode. Anything else is a legacy pickle
    frame, accepted only when ``allow_pickle`` (the endpoint's
    per-connection verdict: its own mode is pickle, the connection
    negotiated pickle, or pre-negotiation compat tolerance). Refused
    pickle surfaces as :class:`FrameError` — an eviction strike, not a
    deserialization."""
    if _codec_mod.sniff(payload):
        return _codec_mod.decode(payload, limits)
    if not allow_pickle:
        raise FrameError(
            "legacy pickle frame refused: this endpoint speaks the safe "
            "wire only (MXNET_SERVING_WIRE=safe with compat off, or the "
            "connection negotiated the safe codec)")
    try:
        return pickle.loads(payload)
    except Exception as e:
        raise FrameError("frame payload does not unpickle: %s" % e) from e


def negotiate(offer, mode, compat):
    """Server-side half of the hello handshake: pick the highest common
    ``(proto, codec)`` pair from a client hello's ``offer`` mapping
    (keys ``protos`` and ``codecs``; UNKNOWN keys ignored — forward
    compat). ``mode``/``compat`` are the listener's construction-time
    policy. Returns ``(proto, codec)``; raises :class:`FrameError` when
    nothing is common (the caller replies ``hello_reject``)."""
    if not isinstance(offer, dict):
        raise FrameError("hello offer must be a mapping, got %s"
                         % type(offer).__name__)
    try:
        protos = {int(p) for p in (offer.get("protos") or (1,))}
    except (TypeError, ValueError) as e:
        raise FrameError("hello protos are not integers: %s" % e) from e
    common = protos & set(SUPPORTED_PROTOS)
    if not common:
        raise FrameError("no common protocol version: peer speaks %s, "
                         "this build %s" % (sorted(protos),
                                            list(SUPPORTED_PROTOS)))
    peer_codecs = [str(c) for c in (offer.get("codecs") or (CODEC_PICKLE,))]
    if mode == CODEC_SAFE:
        preference = [CODEC_SAFE] + ([CODEC_PICKLE] if compat else [])
    else:
        preference = [CODEC_PICKLE, CODEC_SAFE]
    for codec in preference:
        if codec in peer_codecs:
            return max(common), codec
    raise FrameError("no common wire codec: peer offers %s, this "
                     "endpoint allows %s" % (peer_codecs, preference))


def auth_key_from_env():
    """The serving tier's shared frame-auth key (``MXNET_SERVING_AUTH_KEY``)
    as bytes, or None when unset/empty (auth off). Call ONCE at endpoint
    construction — never per frame (the zero-overhead contract)."""
    key = get_env("MXNET_SERVING_AUTH_KEY")
    if not key:
        return None
    return key.encode("utf-8") if isinstance(key, str) else bytes(key)


def normalize_auth_key(auth_key):
    """THE constructor-time auth-key rule, shared by every serving
    endpoint (front door, client, fleet pool, worker): ``None`` defers
    to the env var, a str encodes to bytes, and any falsy value (empty
    str/bytes) means auth OFF."""
    if auth_key is None:
        return auth_key_from_env()
    if isinstance(auth_key, str):
        auth_key = auth_key.encode("utf-8")
    return auth_key or None


def _seal(payload, auth_key):
    if auth_key is None:
        return payload
    return _hmac.new(auth_key, payload, hashlib.sha256).digest() + payload


def _open(payload, auth_key):
    """Verify-and-strip the MAC prefix. Must run before pickle.loads —
    an unauthenticated payload stays inert bytes."""
    if auth_key is None:
        return payload
    if len(payload) < MAC_LEN:
        raise AuthError("frame too short to carry an auth tag "
                        "(%d bytes) — unauthenticated peer?" % len(payload))
    mac, body = payload[:MAC_LEN], payload[MAC_LEN:]
    want = _hmac.new(auth_key, body, hashlib.sha256).digest()
    if not _hmac.compare_digest(mac, want):
        raise AuthError("frame failed HMAC authentication — peer does "
                        "not hold MXNET_SERVING_AUTH_KEY (or the frame "
                        "was tampered with in transit)")
    return body


def send_msg(sock, obj, auth_key=None, codec=CODEC_PICKLE, limits=None):
    """Encode ``obj`` (``codec``: safe or pickle) and send it as one
    length-prefixed frame (HMAC-prefixed when ``auth_key`` is set)."""
    payload = _seal(encode_payload(obj, codec, limits), auth_key)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def recv_exact(sock, n):
    """Read exactly ``n`` bytes. Returns None on EOF before the FIRST
    byte (clean close); raises :class:`FrameError` on EOF after a
    partial read (the peer died mid-frame)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise FrameError(
                "connection closed mid-frame (%d of %d bytes)"
                % (len(buf), n))
        buf += chunk
    return buf


def recv_payload(sock, max_bytes=DEFAULT_MAX_FRAME_BYTES, auth_key=None):
    """Receive one frame's RAW payload bytes (MAC verified and stripped,
    nothing decoded). Returns None on a clean close. What the safe-mode
    client handshake uses to SKIP the server's legacy bootstrap hello
    without ever unpickling it."""
    header = recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    (n,) = _HEADER.unpack(header)
    if max_bytes is not None and n > max_bytes:
        raise FrameError("frame length %d exceeds the %d-byte cap "
                         "(corrupt header or misbehaving peer)"
                         % (n, max_bytes))
    payload = recv_exact(sock, n)
    if payload is None:
        raise FrameError("connection closed between header and payload")
    return _open(payload, auth_key)


def recv_msg(sock, max_bytes=DEFAULT_MAX_FRAME_BYTES, auth_key=None,
             allow_pickle=True, limits=None):
    """Receive one frame and decode it (sniff-based — see
    :func:`decode_payload`). Returns None when the peer closed cleanly
    at a frame boundary; raises :class:`FrameError` for a mid-frame
    close, an oversized length header, or a payload that does not
    decode — and :class:`AuthError` (before any decoding) when
    ``auth_key`` is set and the frame's HMAC does not verify.
    ``max_bytes=None`` disables the frame cap (the kvstore transport,
    whose trusted peers ship arbitrarily large parameter shards and
    never had a cap)."""
    payload = recv_payload(sock, max_bytes=max_bytes, auth_key=auth_key)
    if payload is None:
        return None
    return decode_payload(payload, allow_pickle=allow_pickle,
                          limits=limits)


def teardown(sock):
    """shutdown(SHUT_RDWR) THEN close — THE socket-teardown idiom for
    every serving transport: a bare close neither wakes a
    reader blocked in recv() nor promptly FINs the peer, so death
    detection would hang on the other side. One definition, shared by
    the client pool, the fleet pool, and the worker."""
    try:
        sock.shutdown(_socket.SHUT_RDWR)
    except OSError:
        pass  # peer already gone; shutdown is best-effort
    try:
        sock.close()
    except OSError:
        pass  # socket already dead; close is best-effort hygiene


#: sentinel returned by :func:`recv_msg_tick` for a poll timeout that
#: fired before ANY byte of a frame was consumed — the caller's cue to
#: check its stop flag and poll again. Distinct from None (clean EOF).
TICK = object()


def recv_msg_tick(sock, max_bytes=DEFAULT_MAX_FRAME_BYTES,
                  stall_timeout=30.0, auth_key=None, allow_pickle=True,
                  limits=None):
    """`recv_msg` for a socket carrying a short poll timeout (the
    front-door reader pattern: block briefly, check a stop event, block
    again).

    The naive ``except socket.timeout: continue`` around `recv_msg` is
    only safe while ZERO bytes of a frame have been consumed — a timeout
    after partial bytes would discard them and re-parse the remainder as
    a fresh header, desyncing the stream and striking an honest-but-slow
    peer. Here a timeout before the first byte returns :data:`TICK`;
    once inside a frame, timeouts keep reading (a slow cross-host peer
    is not a tick) until ``stall_timeout`` of consecutive zero-progress
    passes accumulates, which raises :class:`FrameError`."""
    tick_s = sock.gettimeout() or 0.0
    consumed = [False]

    def read_n(n):
        buf = b""
        stalled = 0.0
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except _socket.timeout:
                if not consumed[0]:
                    return None         # pure tick: nothing consumed yet
                stalled += tick_s
                if stall_timeout is not None and stalled >= stall_timeout:
                    raise FrameError(
                        "peer stalled mid-frame for %.1fs (%d of %d "
                        "bytes)" % (stalled, len(buf), n))
                continue
            if not chunk:
                if not buf and not consumed[0]:
                    return b""          # clean EOF at a frame boundary
                raise FrameError(
                    "connection closed mid-frame (%d of %d bytes)"
                    % (len(buf), n))
            consumed[0] = True
            stalled = 0.0
            buf += chunk
        return buf

    header = read_n(_HEADER.size)
    if header is None:
        return TICK
    if header == b"":
        return None
    (n,) = _HEADER.unpack(header)
    if max_bytes is not None and n > max_bytes:
        raise FrameError("frame length %d exceeds the %d-byte cap "
                         "(corrupt header or misbehaving peer)"
                         % (n, max_bytes))
    payload = _open(read_n(n), auth_key)
    return decode_payload(payload, allow_pickle=allow_pickle,
                          limits=limits)


def send_msg_stall(sock, obj, stall_timeout=30.0, auth_key=None,
                   codec=CODEC_PICKLE, limits=None):
    """`send_msg` for a socket carrying a short poll timeout: `sendall`
    raising mid-send loses how much went out, so a big reply to a
    backpressured (but healthy) client would look like a dead peer.
    This send loop keeps pushing while the peer makes ANY progress and
    raises :class:`FrameError` only after ``stall_timeout`` of
    consecutive zero-progress passes."""
    payload = _seal(encode_payload(obj, codec, limits), auth_key)
    data = _HEADER.pack(len(payload)) + payload
    view = memoryview(data)
    tick_s = sock.gettimeout() or 0.0
    off = 0
    stalled = 0.0
    while off < len(data):
        try:
            sent = sock.send(view[off:])
        except _socket.timeout:
            stalled += tick_s
            if stall_timeout is not None and stalled >= stall_timeout:
                raise FrameError(
                    "peer stalled mid-send for %.1fs (%d of %d bytes)"
                    % (stalled, off, len(data)))
            continue
        if sent:
            stalled = 0.0
        off += sent


# the kvstore transport's wrappers: its historical contract is that ANY
# end of stream, clean or mid-frame, reads as None and the caller
# breaks the socket; no frame cap (trusted peers ship arbitrarily large
# parameter shards, and a cap would misread an oversized but healthy
# reply as a dead connection and retry it forever), no auth, pickle
def kv_send_msg(sock, obj):
    """One kvstore frame out (pickle, no auth)."""
    send_msg(sock, obj)


def kv_recv_msg(sock):
    """One kvstore frame in, or None at any end of stream."""
    try:
        return recv_msg(sock, max_bytes=None)
    except FrameError:
        return None
