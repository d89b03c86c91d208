"""Safe serving-wire codec: a self-describing, bounded, NON-EXECUTABLE
binary encoding for every value the serving tier ships across a socket.

Counterpart of ``mxnet_tpu/serving/codec.py``: the same magic, tags,
dtype codes and caps, so the port emits the reference's bytes for every
value both can hold, and each side decodes the other's frames.

Why not pickle: deserialization of a pickle is code execution, so the
old wire's safety rested entirely on network trust plus the HMAC layer.
This codec removes the capability instead of guarding it: the decoder
below can only ever produce plain data (dict / list / tuple / str /
bytes / int / float / bool / None, numpy arrays of an ALLOWLISTED dtype
set, and bfloat16 tensors); there is no opcode that names a class,
imports a module, or calls anything. The worst a hostile frame can do is
raise the typed :class:`~.wire.FrameError`, which the front door counts
as an eviction strike.

Resource-bomb hardening, every cap enforced BEFORE the allocation it
bounds:

* **max depth** (``MXNET_SERVING_WIRE_MAX_DEPTH``): nesting checked on
  container entry, so a 10-byte "list of list of list ..." frame fails
  at the cap, not in the recursion limit;
* **max container length** (``MXNET_SERVING_WIRE_MAX_ITEMS``): a
  declared element count is validated against the cap AND against the
  bytes actually remaining in the frame (every element costs >= 1 tag
  byte) before any list/dict storage is sized;
* **max array elements** (``MXNET_SERVING_WIRE_MAX_ELEMENTS``): the
  shape PRODUCT is computed in exact Python ints and checked, with
  ``product * itemsize == declared_buffer_bytes`` (dtype-confusion
  gate) and ``declared_buffer_bytes <= bytes remaining``, before any
  buffer is touched, so a 40-byte frame declaring a ``(2**40,)``
  float64 array raises instead of allocating 8 TiB;
* **total-frame budget**: the transport's length-header cap
  (``MXNET_SERVING_FRONTDOOR_MAX_FRAME_MB`` at the front door) bounds
  the payload itself; within it, every length field is validated
  against the remaining payload, so cumulative decoded allocation is
  O(frame bytes) by construction.

Frame layout: ``MAGIC`` (4 bytes, ``b"MXW1"``; a pickle stream of any
protocol starts ``b"\\x80"``, so the two codecs are sniffable) followed
by one tagged value. Tags are single bytes; integers little-endian.
Arrays ship as ``(flags, dtype code, ndim, shape dims, buffer length,
raw bytes)`` with ``flags`` bit 0 marking a numpy SCALAR
(``np.float32(3)`` round-trips as a scalar, not a 0-d array).

bfloat16 (dtype code 12) needs no ``ml_dtypes``: a ``torch.bfloat16``
tensor encodes through its 16-bit view, a numpy array whose dtype is
named ``bfloat16`` encodes its raw bytes, and code 12 decodes into a
``torch.bfloat16`` tensor on the CPU (a 0-d tensor for the scalar
flag). A CPU torch tensor of any other allowlisted dtype encodes as its
numpy array, byte for byte what the reference emits for that array.
Senders hand the wire host values: :func:`host_value` is the one rule
for that (a tensor on the card or the CPU becomes a numpy array, a
bfloat16 one a CPU tensor), and :func:`encode` refuses a tensor that is
not on the CPU.

Error split: :func:`encode` raises :class:`CodecError` (the SENDER is
holding an unsupported value: a local bug, never a peer's fault);
:func:`decode` raises the wire's :class:`~.wire.FrameError` for ANY
malformed input (the decoder-is-total contract that
``wire_fuzz.run_fuzz`` checks over seeded mutations).
"""
from __future__ import annotations

import math
import struct

import numpy as _np
import torch

from ..base import MXNetError, get_env
from ..ndarray.ndarray import NDArray
from .wire import FrameError

__all__ = ["MAGIC", "CodecError", "Limits", "encode", "decode", "sniff",
           "host_value", "ALLOWED_DTYPES"]

MAGIC = b"MXW1"

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# one byte per tag; ints (not bytes) so decode compares buf[pos] directly
_T_NONE, _T_TRUE, _T_FALSE = 0x4E, 0x54, 0x46       # 'N' 'T' 'F'
_T_INT, _T_BIGINT, _T_FLOAT = 0x69, 0x49, 0x66      # 'i' 'I' 'f'
_T_STR, _T_BYTES = 0x73, 0x62                       # 's' 'b'
_T_LIST, _T_TUPLE, _T_DICT = 0x6C, 0x74, 0x64       # 'l' 't' 'd'
_T_ARRAY = 0x61                                     # 'a'

_F_SCALAR = 0x01                       # array flags bit 0: numpy scalar

# the dtype allowlist — codes are WIRE FORMAT (append-only; never renumber)
_DTYPE_NAMES = ("bool", "int8", "int16", "int32", "int64",
                "uint8", "uint16", "uint32", "uint64",
                "float16", "float32", "float64", "bfloat16")
_NAME_TO_CODE = {name: code for code, name in enumerate(_DTYPE_NAMES)}
_BF16_CODE = _NAME_TO_CODE["bfloat16"]
# every code but bfloat16 decodes to a numpy array; bfloat16 decodes to a
# torch tensor through its 16-bit view (numpy has no bfloat16 of its own)
_CODE_TO_DTYPE = {code: _np.dtype(name)
                  for code, name in enumerate(_DTYPE_NAMES)
                  if name != "bfloat16"}

#: dtypes the wire will carry
ALLOWED_DTYPES = tuple(sorted(_NAME_TO_CODE))

_MAX_NDIM = 32


class CodecError(MXNetError):
    """The ENCODER was handed a value the safe wire cannot carry (an
    unsupported type, a disallowed dtype, nesting beyond the depth cap).
    Always a local caller bug — peer-supplied malformation surfaces as
    :class:`~.wire.FrameError` from :func:`decode` instead."""


class Limits:
    """Decode/encode resource caps. Env vars are read ONCE here — build
    one `Limits` per endpoint at construction (the zero-overhead
    contract) and reuse it for every frame."""

    __slots__ = ("max_depth", "max_items", "max_elements",
                 "max_bigint_bytes")

    def __init__(self, max_depth=None, max_items=None, max_elements=None,
                 max_bigint_bytes=None):
        if max_depth is None:
            max_depth = get_env("MXNET_SERVING_WIRE_MAX_DEPTH", 32, int)
        if max_items is None:
            max_items = get_env("MXNET_SERVING_WIRE_MAX_ITEMS",
                                1 << 16, int)
        if max_elements is None:
            # aligned with the 1 GiB frame budget (2^28 float32 elements
            # == 1 GiB) so the frame cap, not this, is the binding
            # constraint for honest traffic — a legacy-pickle-sized
            # rollover tensor must not become a "shape bomb" refusal
            max_elements = get_env("MXNET_SERVING_WIRE_MAX_ELEMENTS",
                                   1 << 28, int)
        if max_bigint_bytes is None:
            max_bigint_bytes = 1 << 16
        self.max_depth = int(max_depth)
        self.max_items = int(max_items)
        self.max_elements = int(max_elements)
        self.max_bigint_bytes = int(max_bigint_bytes)
        if min(self.max_depth, self.max_items, self.max_elements,
               self.max_bigint_bytes) < 1:
            raise MXNetError("codec limits must all be >= 1")


_DEFAULT_LIMITS = None


def _default_limits():
    global _DEFAULT_LIMITS
    if _DEFAULT_LIMITS is None:
        _DEFAULT_LIMITS = Limits()
    return _DEFAULT_LIMITS


def sniff(payload):
    """True when ``payload`` is a safe-codec frame (magic-prefixed).
    The sniff is what lets one receive path speak both wires during a
    rolling upgrade: safe frames are always decodable, and anything
    else is pickle from a previous-protocol peer (accepted only where
    the endpoint's compat policy says so — `wire.decode_payload`)."""
    return payload[:4] == MAGIC


# ---------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------
def encode(obj, limits=None):
    """Encode ``obj`` into one magic-prefixed safe frame (bytes)."""
    limits = limits or _default_limits()
    out = bytearray(MAGIC)
    _enc(out, obj, limits, limits.max_depth)
    return bytes(out)


def host_value(value):
    """``value`` with every tensor replaced by its host value, as the
    reference's frames carry numpy: a torch tensor or NDArray (on the
    card or the CPU) becomes its host copy as a numpy array, a bfloat16
    one a CPU tensor (numpy has no bfloat16; the codec carries it as
    dtype code 12). Tuples, lists and dicts are walked; anything else is
    returned as it is. Every sender calls it before a frame is encoded
    (the front door's writer threads, the client, the pool's rollover),
    and the pickle codec needs it as much as this one."""
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return value if value.dtype == torch.bfloat16 else value.numpy()
    if isinstance(value, tuple):
        return tuple(host_value(v) for v in value)
    if isinstance(value, list):
        return [host_value(v) for v in value]
    if isinstance(value, dict):
        return {k: host_value(v) for k, v in value.items()}
    return value


def _enc_tensor(out, t, limits):
    """A CPU torch tensor: bfloat16 through its 16-bit view (code 12),
    any other dtype as its numpy array."""
    if t.device.type != "cpu":
        raise CodecError("a tensor on %s: the wire carries host values "
                         "(codec.host_value)" % t.device)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        _enc_array(out, t.contiguous().view(torch.int16).numpy(),
                   scalar=False, limits=limits, code=_BF16_CODE)
        return
    try:
        arr = t.numpy()
    except TypeError as e:
        raise CodecError("torch dtype %s is not in the safe-wire allowlist "
                         "%s" % (t.dtype, ALLOWED_DTYPES)) from e
    _enc_array(out, arr, scalar=False, limits=limits)


def _enc_array(out, arr, scalar, limits, code=None):
    if code is None:
        code = _NAME_TO_CODE.get(arr.dtype.name)
    if code is None:
        raise CodecError(
            "dtype %s is not in the safe-wire allowlist %s"
            % (arr.dtype, ALLOWED_DTYPES))
    if arr.ndim > _MAX_NDIM:
        raise CodecError("array rank %d exceeds the wire max of %d"
                         % (arr.ndim, _MAX_NDIM))
    if arr.size > limits.max_elements:
        # SYMMETRY with decode: refuse to build a frame the peer's
        # decoder would reject as a shape bomb — the sender gets a
        # typed local error at the call site, never a remote strike
        raise CodecError(
            "array of %d elements exceeds the wire element cap (%d) — "
            "raise MXNET_SERVING_WIRE_MAX_ELEMENTS on BOTH ends to ship "
            "it" % (arr.size, limits.max_elements))
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
        # non-contiguous views copy to C order here; 0-d stays 0-d
        # (np.ascontiguousarray would promote it to rank 1)
        arr = _np.ascontiguousarray(arr)
    out += _U8.pack(_T_ARRAY)
    out += _U8.pack(_F_SCALAR if scalar else 0)
    out += _U8.pack(code)
    out += _U8.pack(arr.ndim)
    for dim in arr.shape:
        out += _U64.pack(dim)
    raw = arr.tobytes()
    out += _U64.pack(len(raw))
    out += raw


def _enc(out, obj, limits, depth):
    if depth <= 0:
        raise CodecError("value nests deeper than the wire depth cap "
                         "(%d)" % limits.max_depth)
    if obj is None:
        out += _U8.pack(_T_NONE)
    elif isinstance(obj, _np.ndarray):
        _enc_array(out, obj, scalar=False, limits=limits)
    elif isinstance(obj, torch.Tensor):
        _enc_tensor(out, obj, limits)
    elif isinstance(obj, _np.generic):  # BEFORE float/int: np.float64
        # subclasses float — scalars keep their numpy type through the
        # wire (np.bool_ included) via the array scalar flag
        _enc_array(out, _np.asarray(obj), scalar=True, limits=limits)
    elif isinstance(obj, bool):         # BEFORE int: bool subclasses int
        out += _U8.pack(_T_TRUE if obj else _T_FALSE)
    elif isinstance(obj, int):
        if _I64_MIN <= obj <= _I64_MAX:
            out += _U8.pack(_T_INT)
            out += _I64.pack(obj)
        else:
            mag = abs(obj)
            raw = mag.to_bytes((mag.bit_length() + 7) // 8, "little")
            if len(raw) > limits.max_bigint_bytes:
                raise CodecError("int magnitude (%d bytes) exceeds the "
                                 "wire cap" % len(raw))
            out += _U8.pack(_T_BIGINT)
            out += _U8.pack(1 if obj < 0 else 0)
            out += _U32.pack(len(raw))
            out += raw
    elif isinstance(obj, float):
        out += _U8.pack(_T_FLOAT)
        out += _F64.pack(obj)           # IEEE-754 bit-exact
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _U8.pack(_T_STR)
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += _U8.pack(_T_BYTES)
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(obj, (list, tuple)):
        if len(obj) > limits.max_items:
            raise CodecError("container of %d items exceeds the wire cap "
                             "(%d)" % (len(obj), limits.max_items))
        out += _U8.pack(_T_LIST if isinstance(obj, list) else _T_TUPLE)
        out += _U32.pack(len(obj))
        for item in obj:
            _enc(out, item, limits, depth - 1)
    elif isinstance(obj, dict):
        if len(obj) > limits.max_items:
            raise CodecError("dict of %d items exceeds the wire cap (%d)"
                             % (len(obj), limits.max_items))
        out += _U8.pack(_T_DICT)
        out += _U32.pack(len(obj))
        for key, val in obj.items():
            _enc(out, key, limits, depth - 1)
            _enc(out, val, limits, depth - 1)
    else:
        raise CodecError(
            "type %s cannot ride the safe wire (allowed: dict/list/tuple/"
            "str/bytes/int/float/bool/None/np.ndarray/torch.Tensor)"
            % type(obj).__name__)


# ---------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------
class _Decoder:
    __slots__ = ("buf", "pos", "end", "limits")

    def __init__(self, payload, limits):
        self.buf = payload
        self.pos = 4                    # past MAGIC (caller verified)
        self.end = len(payload)
        self.limits = limits

    def _need(self, n):
        if self.end - self.pos < n:
            raise FrameError(
                "safe frame truncated: needs %d more bytes at offset %d "
                "of %d" % (n, self.pos, self.end))

    def _u8(self):
        self._need(1)
        val = self.buf[self.pos]
        self.pos += 1
        return val

    def _unpack(self, st):
        self._need(st.size)
        (val,) = st.unpack_from(self.buf, self.pos)
        self.pos += st.size
        return val

    def _raw(self, n):
        self._need(n)
        seg = self.buf[self.pos:self.pos + n]
        self.pos += n
        return seg

    def _count(self, per_item_floor):
        """Container/byte-run length header, validated against the cap
        AND the bytes remaining BEFORE anything is sized from it."""
        count = self._unpack(_U32)
        if count > self.limits.max_items:
            raise FrameError("declared count %d exceeds the wire item "
                             "cap (%d)" % (count, self.limits.max_items))
        if count * per_item_floor > self.end - self.pos:
            raise FrameError(
                "declared count %d cannot fit in the %d bytes remaining "
                "(length bomb)" % (count, self.end - self.pos))
        return count

    def value(self, depth):
        if depth <= 0:
            raise FrameError("frame nests deeper than the wire depth cap "
                             "(%d)" % self.limits.max_depth)
        tag = self._u8()
        if tag == _T_NONE:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            return self._unpack(_I64)
        if tag == _T_FLOAT:
            return self._unpack(_F64)
        if tag == _T_BIGINT:
            neg = self._u8()
            if neg > 1:
                raise FrameError("bigint sign byte %d is not 0/1" % neg)
            nbytes = self._unpack(_U32)
            if nbytes > self.limits.max_bigint_bytes:
                raise FrameError("bigint of %d bytes exceeds the wire cap"
                                 % nbytes)
            mag = int.from_bytes(self._raw(nbytes), "little")
            return -mag if neg else mag
        if tag == _T_STR:
            # byte runs need no item cap: _raw() bounds them against the
            # remaining payload, and decoding allocates at most frame-size
            n = self._unpack(_U32)
            try:
                return bytes(self._raw(n)).decode("utf-8")
            except UnicodeDecodeError as e:
                raise FrameError("string payload is not UTF-8: %s"
                                 % e) from e
        if tag == _T_BYTES:
            n = self._unpack(_U32)
            return bytes(self._raw(n))
        if tag in (_T_LIST, _T_TUPLE):
            n = self._count(1)          # every element costs >= 1 tag byte
            items = [self.value(depth - 1) for _ in range(n)]
            return items if tag == _T_LIST else tuple(items)
        if tag == _T_DICT:
            n = self._count(2)          # a pair costs >= 2 tag bytes
            out = {}
            for _ in range(n):
                key = self.value(depth - 1)
                try:
                    out[key] = self.value(depth - 1)
                except TypeError as e:  # unhashable decoded key
                    raise FrameError("dict key is unhashable: %s"
                                     % e) from e
            return out
        if tag == _T_ARRAY:
            return self._array()
        raise FrameError("unknown wire tag 0x%02x at offset %d"
                         % (tag, self.pos - 1))

    def _array(self):
        flags = self._u8()
        code = self._u8()
        dtype = _np.dtype(_np.int16) if code == _BF16_CODE \
            else _CODE_TO_DTYPE.get(code)
        if dtype is None:
            raise FrameError(
                "dtype code %d is not in the safe-wire allowlist" % code)
        ndim = self._u8()
        if ndim > _MAX_NDIM:
            raise FrameError("array rank %d exceeds the wire max of %d"
                             % (ndim, _MAX_NDIM))
        shape = tuple(self._unpack(_U64) for _ in range(ndim))
        elements = math.prod(shape)     # exact (Python int): no overflow
        if elements > self.limits.max_elements:
            raise FrameError(
                "array of %d elements (shape %s) exceeds the wire element "
                "cap (%d) — shape bomb" % (elements, shape,
                                           self.limits.max_elements))
        nbytes = self._unpack(_U64)
        if nbytes != elements * dtype.itemsize:
            raise FrameError(
                "array buffer length %d does not match shape %s x dtype "
                "%s (%d bytes) — dtype confusion"
                % (nbytes, shape, dtype, elements * dtype.itemsize))
        if flags & _F_SCALAR and ndim != 0:
            raise FrameError("scalar flag on a rank-%d array" % ndim)
        # _raw() bounds-checks against the remaining payload BEFORE the
        # allocation below: a declared buffer larger than the frame can
        # never allocate
        raw = self._raw(nbytes)
        arr = _np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        if code == _BF16_CODE:
            t = torch.from_numpy(arr).view(torch.bfloat16)
            return t.reshape(()) if flags & _F_SCALAR else t
        if flags & _F_SCALAR:
            return arr[()]              # numpy scalar round-trip fidelity
        return arr


def decode(payload, limits=None):
    """Decode one safe frame. TOTAL over arbitrary bytes: any input that
    is not a well-formed, in-cap frame raises :class:`~.wire.FrameError`
    — never another exception type, never an allocation beyond the caps,
    never a hang (the fuzz gate's contract)."""
    limits = limits or _default_limits()
    if payload[:4] != MAGIC:
        raise FrameError("payload lacks the safe-codec magic (got %r)"
                         % bytes(payload[:4]))
    dec = _Decoder(payload, limits)
    try:
        obj = dec.value(limits.max_depth)
    except FrameError:
        raise
    except (RecursionError, MemoryError):   # the caps exist to make these
        raise                               # unreachable; never mask them
    except Exception as e:
        # decoder-is-total backstop: structural surprises (struct errors,
        # numpy reshape edge cases) surface typed, feeding the same
        # eviction strikes as any other malformed frame
        raise FrameError("malformed safe frame: %s: %s"
                         % (type(e).__name__, e)) from e
    if dec.pos != dec.end:
        raise FrameError("safe frame carries %d trailing bytes"
                         % (dec.end - dec.pos))
    return obj
