"""Core shared machinery of the PyTorch port: the error type, env config,
the typed op-attribute structs and an atomic file write.

Counterpart of ``mxnet_tpu/base.py`` (``MXNetError``, ``get_env``,
``env_flag``, ``Params``/``ParamsMeta``/``param_field``, ``np_dtype``,
``atomic_write``, ``Registry``), copied rather than imported so the port
never pulls in JAX. ``Params`` parses the string attributes of symbol
JSON into typed fields, as ``dmlc::Parameter`` does in the reference.
"""
from __future__ import annotations

import os
import tempfile

import numpy as _np

__all__ = ["MXNetError", "get_env", "env_flag", "Params", "param_field",
           "np_dtype", "atomic_write", "Registry"]


class MXNetError(Exception):
    """Error raised by the framework (reference: dmlc::Error surfaced via MXGetLastError)."""


def get_env(name, default=None, typ=str):
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        if typ is bool:
            return val not in ("0", "false", "False", "")
        return typ(val)
    except ValueError:
        return default


def env_flag(name, default=False):
    return get_env(name, default, bool)


def np_dtype(dtype):
    """A user dtype spec (str / np.dtype / type) as a numpy dtype; None is
    float32."""
    return _np.dtype(_np.float32) if dtype is None else _np.dtype(dtype)


def atomic_write(fname, data, mode="wb"):
    """Write ``data`` to ``fname`` through a temp file beside it and
    ``os.replace``, so the file at ``fname`` is never a partial write."""
    d = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(fname) + ".tmp-")
    try:
        with os.fdopen(fd, mode) as f:
            f.write(data)
        os.replace(tmp, fname)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class Registry:
    """Name -> class table of a plugin kind (optimizer, metric,
    initializer), names case-insensitive. ``not_ported`` names the
    reference's entries the port lacks: looking one up raises saying so and
    which ROADMAP item holds it."""

    def __init__(self, kind, not_ported=(), item=None):
        self.kind = kind
        self._map = {}
        self._not_ported = frozenset(n.lower() for n in not_ported)
        self._item = item

    def register(self, obj, name=None):
        name = (name or getattr(obj, "__name__", None) or str(obj)).lower()
        self._map[name] = obj
        return obj

    def alias(self, obj, *names):
        for n in names:
            self._map[n.lower()] = obj
        return obj

    def get(self, name):
        key = name.lower() if isinstance(name, str) else name
        if key in self._map:
            return self._map[key]
        if key in self._not_ported:
            raise MXNetError("%s %r is not yet ported (ROADMAP %s)"
                             % (self.kind, name, self._item))
        raise MXNetError("%s %r is not registered. Registered: %s"
                         % (self.kind, name, sorted(self._map)))

    def keys(self):
        return sorted(self._map)


# ---------------------------------------------------------------------------
# Parameter reflection (reference: dmlc::Parameter / DMLC_REGISTER_PARAMETER).
# Every op attribute is string-coercible, which powers the symbol JSON
# round-trip where all attrs are strings.
# ---------------------------------------------------------------------------

class _Field:
    __slots__ = ("name", "type", "default", "required", "doc", "enum")

    def __init__(self, type=str, default=None, required=False, doc="",
                 enum=None):
        self.name = None
        self.type = type
        self.default = default
        self.required = required
        self.doc = doc
        self.enum = enum


def param_field(type=str, default=None, required=False, doc="", enum=None):
    return _Field(type=type, default=default, required=required, doc=doc,
                  enum=enum)


def _coerce(value, typ):
    """Coerce a (possibly string-serialized) value to the declared type."""
    if value is None:
        return None
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    if typ in (int, float):
        return typ(value)
    if typ is tuple:  # shape-like "(1, 2)" / float-list "(1, 0.5)" strings
        def elem(x):
            f = float(x)
            return int(f) if f.is_integer() else f
        if isinstance(value, str):
            s = value.strip().strip("()[]")
            if not s:
                return ()
            return tuple(elem(x) for x in s.replace(" ", "").split(",")
                         if x != "")
        if isinstance(value, (list, tuple)):
            return tuple(elem(v) for v in value)
        return (elem(value),)
    if typ is str:
        return str(value)
    return typ(value)


class ParamsMeta(type):
    def __new__(mcs, name, bases, ns):
        fields = {}
        for base in bases:
            fields.update(getattr(base, "_fields", {}))
        for key, val in list(ns.items()):
            if isinstance(val, _Field):
                val.name = key
                fields[key] = val
                del ns[key]
        ns["_fields"] = fields
        return super().__new__(mcs, name, bases, ns)


class Params(metaclass=ParamsMeta):
    """Typed, string-coercible parameter struct.

    Subclass with ``param_field`` class attributes; instantiate with kwargs
    (values may be strings, as when reloading symbol JSON). Unknown kwargs
    raise."""

    def __init__(self, **kwargs):
        for fname, field in self._fields.items():
            if fname in kwargs:
                val = _coerce(kwargs.pop(fname), field.type)
                if field.enum is not None and val is not None \
                        and val not in field.enum:
                    raise MXNetError(
                        "Invalid value %r for parameter %s; expected one of %s"
                        % (val, fname, field.enum))
                setattr(self, fname, val)
            elif field.required:
                raise MXNetError("Required parameter %s missing" % fname)
            else:
                setattr(self, fname, field.default)
        if kwargs:
            raise MXNetError("Unknown parameters %s for %s"
                             % (sorted(kwargs), type(self).__name__))

    def as_str_dict(self):
        """Stringify for symbol JSON (the reference stores attrs as strings)."""
        return {k: str(getattr(self, k)) for k in self._fields
                if getattr(self, k) is not None}

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, ", ".join(
            "%s=%r" % (k, getattr(self, k)) for k in self._fields))
