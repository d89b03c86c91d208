"""Deterministic mutational fuzz harness for the safe wire codec: ANY
byte string fed to `codec.decode` either decodes to plain data or raises
the typed :class:`~.wire.FrameError`, never another exception, never an
allocation beyond the caps, never a hang.

Counterpart of ``mxnet_tpu/serving/wire_fuzz.py``; the corpus builds the
reference's frames byte for byte.

Three corpus sources compose:

* :func:`base_corpus` — frames with the exact shapes real traffic has
  (predict specs with multi-dtype arrays, served/shed/failed replies,
  hello/hello_ack, resolve maps, fleet join/heartbeat/rollover);
* :class:`FrameTap` — records every payload `wire.encode_payload`
  produces while REAL traffic runs (a corpus captured from a live
  gateway and fleet session);
* :func:`bombs` — hand-crafted adversarial frames (depth bombs, length
  bombs, shape bombs, dtype confusion, truncations) that target each
  cap directly rather than waiting for mutation luck.

Everything is seeded (`random.Random(seed)`) so a failure replays bit
for bit: ``run_fuzz(n, seed)`` returns a report whose
``other_exceptions`` must stay empty.
"""
from __future__ import annotations

import random
import struct

import numpy as _np

from . import codec as _codec
from . import wire as _wire

__all__ = ["base_corpus", "bombs", "mutate", "run_fuzz", "FrameTap"]


def base_corpus(limits=None):
    """Encoded safe frames shaped like real serving traffic."""
    rng = _np.random.RandomState(0)
    arrays = {
        "data": rng.uniform(-1, 1, (8, 128)).astype(_np.float32),
        "mask": rng.randint(0, 2, (8, 1)).astype(_np.bool_),
        "ids": rng.randint(0, 1 << 30, (8,)).astype(_np.int64),
        "emb": rng.uniform(0, 1, (4, 16)).astype(_np.float16),
        "raw": rng.randint(0, 255, (3, 3, 3)).astype(_np.uint8),
    }
    objs = [
        # client hello / server acks (the negotiation surface)
        ("hello", {"protos": [1, 2], "codecs": ["safe"], "lib": "mxnet_tpu"}),
        ("hello_ack", 7, {"proto": 2, "codec": "safe"}),
        # predict request spec (the dominant frame)
        ("predict", "c7-1",
         {"model": "resnet", "version": None, "arrays": arrays,
          "deadline_ms": 184.25, "priority": 1,
          "trace": "a1b2c3d4e5f6", "t_send": 1754300000.123456}),
        # typed replies
        ("served", "c7-1",
         [rng.uniform(-1, 1, (8, 10)).astype(_np.float32)],
         {"trace": "a1b2c3d4e5f6", "wire_ms": 0.81, "queue_ms": 3.25,
          "device_ms": 11.5, "total_ms": 15.56}),
        ("shed", "c7-2", "deadline budget consumed by 42.0ms wire"),
        ("failed", "c7-3", "MXNetError: unknown model 'x'"),
        # stateful decode: request, streamed tokens, terminal, resume
        ("decode", "c7-5",
         {"model": "lm", "tokens": [3, 1, 4, 1, 5], "max_new_tokens": 32,
          "deadline_ms": 2500.0, "priority": 0,
          "trace": "a1b2c3d4e5f6", "t_send": 1754300000.5}),
        ("stok", "c7-5", 7, 31173),
        ("sdone", "c7-5", "served", {"trace": "a1b2c3d4e5f6", "tokens": 32}),
        ("sdone", "c7-6", "shed",
         "CacheOverflow: prompt of 10 tokens can never fit a pool of "
         "2 blocks"),
        ("sresume", "c8-3", {"rid": "c7-5", "have": 7}),
        # resolve round-trip
        ("resolve", "c8-1", ["c7-1", "c7-2", "c9-9"]),
        ("resolved", "c8-1", {"c7-1": ("pending",), "c9-9": ("unknown",),
                              "c7-5": ("stream", 7, None)}),
        # fleet control plane
        ("join", {"worker_id": "h-1234-ab", "host": None, "port": 40001,
                  "pid": 1234, "codecs": ["safe", "pickle"],
                  "models": {"m": {"versions": ["1", "2"]}},
                  "warmed": True}),
        ("heartbeat", {"worker_id": "h-1234-ab", "ts": 1754300001.5,
                       "health": {"models": {"m": {
                           "queue_wait_p95_ms": 12.5, "shed_rate": 0.01,
                           "submitted": 4096}}}}),
        ("rollover", "fh-3", "m",
         {"fc0_weight": rng.normal(0, 0.05, (64, 32)).astype(_np.float32),
          "fc0_bias": _np.zeros((64,), _np.float32)}, None),
        ("health", "c7-9"),
        # scalar/edge soup: the encodings mutation should reach
        {"empty": _np.zeros((0, 4), _np.int16),
         "zero_d": _np.float64(3.5),    # numpy SCALAR (host memory)
         "scalar": _np.float32(1.25), "big": 1 << 80, "neg": -(1 << 80),
         "none": None, "flag": True, "bytes": b"\x00\x01\xfe",
         "nested": [[[({"deep": (1, 2.5)},)]]]},
        _np.zeros((1,), _np.float64).reshape(()),    # true 0-d array
    ]
    return [_codec.encode(obj, limits) for obj in objs]


def bombs(limits=None):
    """Hand-crafted adversarial frames targeting each decode cap.
    Every one must raise FrameError — fast, and without the allocation
    it tries to provoke."""
    limits = limits or _codec.Limits()
    u32, u64 = struct.Struct("<I"), struct.Struct("<Q")
    magic = _codec.MAGIC
    out = [
        b"",                                      # not even magic
        b"MXW",                                   # truncated magic
        magic,                                    # magic, no value
        magic + b"\xff",                          # unknown tag
        magic + b"i\x01",                         # truncated int64
        magic + b"s" + u32.pack(100) + b"abc",    # str longer than frame
        magic + b"s" + u32.pack(3) + b"\xff\xfe\x00",   # invalid UTF-8
        magic + b"I\x02" + u32.pack(1) + b"\x01",       # bad sign byte
        magic + b"I\x00" + u32.pack(1 << 26),           # bigint bomb
        # depth bomb: nested single-element lists beyond any sane cap
        magic + (b"l" + u32.pack(1)) * (limits.max_depth + 8) + b"N",
        # length bomb: a list declaring 2^31 elements in a 10-byte frame
        magic + b"l" + u32.pack((1 << 31) - 1) + b"N",
        # dict length bomb
        magic + b"d" + u32.pack((1 << 31) - 1) + b"N" + b"N",
        # shape bomb: (2^40,) float64 declared in a 30-byte frame
        magic + b"a\x00\x0b\x01" + u64.pack(1 << 40) + u64.pack(1 << 43),
        # element-cap bomb inside a plausible buffer claim
        magic + b"a\x00\x05\x02" + u64.pack(1 << 20) + u64.pack(1 << 20)
        + u64.pack(1 << 40),
        # dtype confusion: buffer length disagrees with shape x itemsize
        magic + b"a\x00\x0a\x01" + u64.pack(4) + u64.pack(999) + b"x" * 16,
        # unknown dtype code
        magic + b"a\x00\x63\x01" + u64.pack(2) + u64.pack(8) + b"x" * 8,
        # scalar flag on a rank-1 array
        magic + b"a\x01\x01\x01" + u64.pack(2) + u64.pack(2) + b"xy",
        # rank above the wire max
        magic + b"a\x00\x01\xff" + u64.pack(1) * 40,
        # trailing garbage after a valid root
        _codec.encode(None) + b"\x00",
        # valid header, payload cut mid-array
        _codec.encode({"a": _np.arange(64, dtype=_np.int32)})[:-17],
    ]
    return out


_MUTATIONS = ("bitflip", "byteset", "truncate", "extend", "splice",
              "zero_run", "header")


def mutate(data, rng):
    """One seeded mutation of ``data`` (bytes -> bytes)."""
    data = bytearray(data)
    op = rng.choice(_MUTATIONS)
    if not data:
        return bytes(data) + b"\x00"
    if op == "bitflip":
        i = rng.randrange(len(data))
        data[i] ^= 1 << rng.randrange(8)
    elif op == "byteset":
        i = rng.randrange(len(data))
        data[i] = rng.randrange(256)
    elif op == "truncate":
        data = data[:rng.randrange(len(data))]
    elif op == "extend":
        data += bytes(rng.randrange(256)
                      for _ in range(rng.randrange(1, 16)))
    elif op == "splice":
        i, j = sorted(rng.randrange(len(data) + 1) for _ in range(2))
        data = data[:i] + data[j:]
    elif op == "zero_run":
        i = rng.randrange(len(data))
        n = min(len(data) - i, rng.randrange(1, 9))
        data[i:i + n] = b"\x00" * n
    elif op == "header":
        # target length/count fields specifically: overwrite 4-8 bytes
        # somewhere with a huge little-endian integer
        i = rng.randrange(len(data))
        width = rng.choice((4, 8))
        bomb = rng.choice((0xFFFFFFFF, 1 << 30, (1 << 62) + 1, 1 << 20))
        data[i:i + width] = bomb.to_bytes(8, "little")[:width]
    return bytes(data)


def run_fuzz(n, seed=0xC0DEC, corpus=None, limits=None,
             track_alloc=False, alloc_factor=64, alloc_floor=1 << 20):
    """Run ``n`` seeded mutations against the decoder and classify every
    outcome. Returns a report dict; the gate asserts
    ``report["other_exceptions"] == []`` (decoder-is-total) and, with
    ``track_alloc``, that no decode's peak traced allocation exceeded
    ``alloc_factor * len(frame) + alloc_floor`` (caps bound allocation).
    Deterministic for a given (n, seed, corpus)."""
    limits = limits or _codec.Limits()
    corpus = list(corpus) if corpus else base_corpus(limits)
    corpus += bombs(limits)
    rng = random.Random(seed)
    report = {"mutations": 0, "decoded_ok": 0, "frame_errors": 0,
              "other_exceptions": [], "alloc_violations": [],
              "max_alloc_ratio": 0.0}
    tracemalloc = None
    if track_alloc:
        import tracemalloc                      # noqa: F811 (lazy)
        tracemalloc.start()
    try:
        for i in range(n):
            frame = rng.choice(corpus)
            for _ in range(rng.randrange(1, 4)):
                frame = mutate(frame, rng)
            report["mutations"] += 1
            if tracemalloc is not None:
                tracemalloc.clear_traces()
                tracemalloc.reset_peak()
            try:
                _codec.decode(frame, limits)
            except _wire.FrameError:
                report["frame_errors"] += 1
            except Exception as e:              # the gate's failure mode
                report["other_exceptions"].append(
                    {"iteration": i, "seed": seed,
                     "error": "%s: %s" % (type(e).__name__, e),
                     "frame_head": frame[:64].hex()})
            else:
                report["decoded_ok"] += 1
            if tracemalloc is not None:
                _cur, peak = tracemalloc.get_traced_memory()
                budget = alloc_factor * max(len(frame), 1) + alloc_floor
                ratio = peak / float(budget)
                if ratio > report["max_alloc_ratio"]:
                    report["max_alloc_ratio"] = round(ratio, 4)
                if peak > budget:
                    report["alloc_violations"].append(
                        {"iteration": i, "peak": peak, "budget": budget,
                         "frame_len": len(frame),
                         "frame_head": frame[:64].hex()})
    finally:
        if tracemalloc is not None:
            tracemalloc.stop()
    return report


class FrameTap:
    """Record every payload `wire.encode_payload` produces while real
    traffic runs (a corpus captured from live front door and fleet
    traffic). Thread-safe append; restores the original on exit.

        with FrameTap() as tap:
            ... drive a real gateway/client/fleet session ...
        corpus = tap.frames("safe")
    """

    def __init__(self):
        self._orig = None
        self._records = []
        import threading
        self._lock = threading.Lock()

    def __enter__(self):
        self._orig = _wire.encode_payload

        def recording(obj, codec=_wire.CODEC_PICKLE, limits=None):
            payload = self._orig(obj, codec, limits)
            with self._lock:
                self._records.append((codec, payload))
            return payload

        _wire.encode_payload = recording
        return self

    def __exit__(self, *exc):
        _wire.encode_payload = self._orig
        return False

    def frames(self, codec=None):
        with self._lock:
            return [payload for c, payload in self._records
                    if codec is None or c == codec]
