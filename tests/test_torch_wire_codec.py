"""The port's wire framing and safe codec held against the JAX package's.

- Byte identity: for every frame of the reference's
  ``wire_fuzz.base_corpus()`` the port's ``codec.encode`` of the decoded
  value gives the reference's bytes, and the port's own ``base_corpus()``
  is the reference's; for each allowlisted dtype (bool, the integers,
  float16/32/64, bfloat16) an array encodes to the reference's bytes,
  from numpy and from a torch tensor, bfloat16 from ``torch.bfloat16`` on
  the port's side and from ``ml_dtypes`` on the reference's.
- ``decode`` round-trips every value bit for bit (numpy scalars stay
  scalars, bfloat16 decodes to a ``torch.bfloat16`` tensor), also with
  ``ml_dtypes`` hidden (``sys.modules["ml_dtypes"] = None``) in a fresh
  process.
- Every bomb of ``wire_fuzz.bombs()`` is a FrameError within 0.5 s, and a
  seeded ``run_fuzz`` sweep stays total (FrameError or data, nothing
  else).
- Frames cross packages: the port's ``send_msg`` is read by the
  reference's ``recv_msg`` and the other way, sealed with a shared key;
  ``negotiate`` picks the reference's pair.
- The MAC is checked before decode: a frame whose pickle would execute is
  refused as ``AuthError`` when unsealed or tampered; a pickle frame is
  refused on a safe endpoint (``allow_pickle=False``).
- ``codec.host_value`` is the one rule for tensors on the wire (numpy,
  bfloat16 as a CPU tensor, NDArrays unwrapped) and gives the
  reference's bytes; ``encode`` refuses a tensor off the CPU.
- The receive helpers: a poll timeout before any byte is ``TICK``; a
  close mid-frame is a FrameError, at a boundary None; the kvstore
  wrappers read any end of stream as None.
"""
import os
import pickle
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.serving import codec as jcodec
from mxnet_tpu.serving import wire as jwire
from mxnet_tpu.serving import wire_fuzz as jfuzz

from mxnet_tpu_torch.serving import codec as tcodec
from mxnet_tpu_torch.serving import wire as twire
from mxnet_tpu_torch.serving import wire_fuzz as tfuzz
from torch_one_thread import one_torch_thread  # noqa: F401

try:
    from ml_dtypes import bfloat16 as ml_bf16
except ImportError:          # pragma: no cover - ships with jax
    ml_bf16 = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CORPUS = jfuzz.base_corpus()
KEY = b"wire-codec-key"


def _same(a, b):
    """Bit-for-bit equality of decoded values (arrays by bytes, dtype and
    shape; containers by structure; numpy scalars by type)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.int16), b.view(torch.int16)))
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype
                and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (type(b) is dict and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


def test_port_corpus_is_the_reference_corpus():
    assert tfuzz.base_corpus() == REF_CORPUS


@pytest.mark.parametrize("i", range(len(REF_CORPUS)))
def test_corpus_frame_encodes_to_the_reference_bytes(i):
    frame = REF_CORPUS[i]
    ref_value = jcodec.decode(frame)
    assert tcodec.encode(ref_value) == frame
    port_value = tcodec.decode(frame)
    assert tcodec.encode(port_value) == frame
    # decode round-trips bit for bit
    assert _same(tcodec.decode(tcodec.encode(port_value)), port_value)


def _dtype_array(name):
    rng = np.random.RandomState(7)
    if name == "bool":
        return rng.randint(0, 2, (3, 5)).astype(np.bool_)
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return rng.randint(max(info.min, -1000), min(info.max, 1000),
                           (3, 5)).astype(name)
    return rng.uniform(-3, 3, (3, 5)).astype(np.float32 if name ==
                                             "bfloat16" else name)


@pytest.mark.parametrize("name", tcodec.ALLOWED_DTYPES)
def test_each_dtype_encodes_to_the_reference_bytes(name):
    arr = _dtype_array(name)
    if name == "bfloat16":
        ref = jcodec.encode({"x": arr.astype(ml_bf16),
                             "s": arr.astype(ml_bf16)[0, 0]})
        t = torch.from_numpy(arr).to(torch.bfloat16)
        assert tcodec.encode({"x": t, "s": arr.astype(ml_bf16)[0, 0]}) \
            == ref
        got = tcodec.decode(ref)
        assert _same(got["x"], t)
        # a bfloat16 scalar decodes to a 0-d tensor (no numpy scalar to
        # hold it), which encodes back as a 0-d array
        assert got["s"].shape == () and got["s"].dtype == torch.bfloat16
        assert tcodec.encode(got["x"]) == jcodec.encode(arr.astype(ml_bf16))
        return
    ref = jcodec.encode({"x": arr, "s": arr[1, 2], "e": arr[:0],
                         "v": arr[:, ::2]})
    port = {"x": arr, "s": arr[1, 2], "e": arr[:0], "v": arr[:, ::2]}
    assert tcodec.encode(port) == ref
    try:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in port.items() if k != "s"}
    except TypeError:        # a dtype this torch cannot hold
        tensors = None
    if tensors is not None:
        assert tcodec.encode({"x": tensors["x"], "s": arr[1, 2],
                              "e": tensors["e"], "v": tensors["v"]}) == ref
    assert _same(tcodec.decode(ref), jcodec.decode(ref))


def test_bf16_round_trip_without_ml_dtypes():
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from mxnet_tpu_torch.serving import codec\n"
        "t = torch.linspace(-4, 4, 24).reshape(4, 6).to(torch.bfloat16)\n"
        "frame = codec.encode({'w': t, 'tail': t[:, 1:4]})\n"
        "back = codec.decode(frame)\n"
        "assert back['w'].dtype == torch.bfloat16\n"
        "assert torch.equal(back['w'].view(torch.int16),"
        " t.view(torch.int16))\n"
        "assert torch.equal(back['tail'], t[:, 1:4])\n"
        "assert codec.encode(back) == frame\n"
        "print('ok', frame[:4].decode())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok MXW1"


def test_encode_refuses_what_the_wire_cannot_carry():
    with pytest.raises(tcodec.CodecError):
        tcodec.encode(torch.zeros(2, dtype=torch.complex64))
    with pytest.raises(tcodec.CodecError):
        tcodec.encode(object())
    with pytest.raises(tcodec.CodecError):
        tcodec.encode(np.zeros(3, np.complex64))


def test_host_value_is_what_every_sender_puts_on_the_wire():
    import mxnet_tpu_torch as tmx
    arr = _dtype_array("float32")
    b16 = torch.from_numpy(arr).to(torch.bfloat16)
    value = ("served", "c1-1", [torch.from_numpy(arr),
                                tmx.nd.array(arr, ctx=tmx.cpu()), b16],
             {"w": b16[:, 1:3], "n": 3, "s": "x"})
    host = tcodec.host_value(value)
    assert isinstance(host, tuple) and host[:2] == ("served", "c1-1")
    assert [type(v) for v in host[2]] == [np.ndarray, np.ndarray,
                                          torch.Tensor]
    assert _same(host[2][0], arr) and _same(host[2][1], arr)
    assert host[2][2].device.type == "cpu" and torch.equal(host[2][2], b16)
    assert host[3]["n"] == 3 and host[3]["s"] == "x"
    assert tcodec.encode(host) == jcodec.encode(
        ("served", "c1-1", [arr, arr, arr.astype(ml_bf16)],
         {"w": arr.astype(ml_bf16)[:, 1:3], "n": 3, "s": "x"}))
    assert tcodec.encode(tcodec.host_value(host)) == tcodec.encode(host)
    # the codec itself takes only host tensors: a tensor elsewhere (here
    # on ``meta``, as one on the card) is the sender's bug
    with pytest.raises(tcodec.CodecError, match="host_value"):
        tcodec.encode({"x": torch.empty(2, 3, device="meta")})


@pytest.mark.parametrize("i", range(len(jfuzz.bombs())))
def test_bomb_is_a_fast_frame_error(i):
    bomb = tfuzz.bombs()[i]
    assert bomb == jfuzz.bombs()[i]
    t0 = time.perf_counter()
    with pytest.raises(twire.FrameError):
        tcodec.decode(bomb)
    assert time.perf_counter() - t0 < 0.5


def test_seeded_fuzz_sweep_stays_total():
    report = tfuzz.run_fuzz(3000, seed=0xC0DEC)
    assert report["other_exceptions"] == []
    assert report["mutations"] == 3000
    assert report["decoded_ok"] + report["frame_errors"] == 3000
    assert report["decoded_ok"] > 0 and report["frame_errors"] > 0


def test_frames_cross_packages_sealed():
    value = jcodec.decode(REF_CORPUS[2])          # a predict request
    for codec_name in (twire.CODEC_SAFE, twire.CODEC_PICKLE):
        a, b = socket.socketpair()
        try:
            twire.send_msg(a, value, auth_key=KEY, codec=codec_name)
            got = jwire.recv_msg(b, auth_key=KEY)
            jwire.send_msg(b, got, auth_key=KEY, codec=codec_name)
            back = twire.recv_msg(a, auth_key=KEY)
        finally:
            a.close()
            b.close()
        assert _same(got, value) and _same(back, value)
    payload = tcodec.encode(value)
    assert twire._seal(payload, KEY) == jwire._seal(payload, KEY)


@pytest.mark.parametrize("offer,mode,compat", [
    ({"protos": [1, 2], "codecs": ["safe"]}, "safe", True),
    ({"protos": [2], "codecs": ["pickle", "safe"], "x": 1}, "pickle", True),
    ({"codecs": ["pickle"]}, "safe", True),
    ({"protos": [2, 7]}, "safe", True)])
def test_negotiate_picks_the_reference_pair(offer, mode, compat):
    assert twire.negotiate(offer, mode, compat) == \
        jwire.negotiate(offer, mode, compat)


@pytest.mark.parametrize("offer,mode,compat", [
    ({"protos": [9]}, "safe", True),
    ({"codecs": ["pickle"]}, "safe", False)])
def test_negotiate_refuses_typed(offer, mode, compat):
    with pytest.raises(twire.FrameError):
        twire.negotiate(offer, mode, compat)
    with pytest.raises(jwire.FrameError):
        jwire.negotiate(offer, mode, compat)


class _Boom:
    def __reduce__(self):
        return (pytest.fail, ("a frame was unpickled before its MAC",))


def test_mac_is_checked_before_decode():
    bomb = pickle.dumps(_Boom())
    sealed = twire._seal(bomb, KEY)
    for frame in (bomb, bytes([sealed[0] ^ 0xFF]) + sealed[1:],
                  twire._seal(bomb, b"another-key")):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack("<Q", len(frame)) + frame)
            with pytest.raises(twire.AuthError):
                twire.recv_msg(b, auth_key=KEY)
        finally:
            a.close()
            b.close()
    assert issubclass(twire.AuthError, twire.FrameError)


def test_pickle_frame_refused_on_a_safe_endpoint():
    payload = pickle.dumps(_Boom())
    with pytest.raises(twire.FrameError, match="pickle frame refused"):
        twire.decode_payload(payload, allow_pickle=False)
    # a safe frame decodes whatever the endpoint allows
    safe = tcodec.encode(("ping", "r1"))
    assert twire.decode_payload(safe, allow_pickle=False) == ("ping", "r1")


def test_receive_helpers_tick_and_ends():
    a, b = socket.socketpair()
    try:
        b.settimeout(0.05)
        assert twire.recv_msg_tick(b) is twire.TICK
        twire.send_msg_stall(a, ("stok", "c1-1", 1, 7),
                             codec=twire.CODEC_SAFE)
        assert twire.recv_msg_tick(b) == ("stok", "c1-1", 1, 7)
        frame = tcodec.encode(list(range(100)))
        a.sendall(struct.pack("<Q", len(frame)) + frame[:10])
        a.shutdown(socket.SHUT_WR)
        with pytest.raises(twire.FrameError, match="mid-frame"):
            twire.recv_msg_tick(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        twire.kv_send_msg(a, {"key": 3})
        assert twire.kv_recv_msg(b) == {"key": 3}
        a.sendall(struct.pack("<Q", 100) + b"xx")
        a.close()
        assert twire.kv_recv_msg(b) is None
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        a.close()
        assert twire.recv_msg(b) is None     # a clean close at a boundary
    finally:
        b.close()
