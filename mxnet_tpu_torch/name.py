"""Automatic symbol naming: the ``NameManager`` of ``mxnet_tpu/name.py``.

The symbol module consults ``current()`` for every unnamed node, so
unnamed nodes get the reference's names ("pooling0", "flatten0", ...);
``with NameManager():`` starts a fresh count, and ``with Prefix("net_"):``
a fresh count whose names carry the prefix."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Sequential hint-based naming ("fc0", "fc1", ...)."""

    _state = threading.local()

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        """Name to use: explicit ``name`` wins, else hint + counter."""
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        if not hasattr(NameManager._state, "stack"):
            NameManager._state.stack = []
        NameManager._state.stack.append(self)
        return self

    def __exit__(self, *exc):
        NameManager._state.stack.pop()


class Prefix(NameManager):
    """Auto names gain ``prefix`` inside the scope (reference name.py:74):

    >>> with mx.name.Prefix("mynet_"):
    ...     mx.sym.FullyConnected(data, num_hidden=1)  # mynet_fullyconnected0
    """

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    stack = getattr(NameManager._state, "stack", None)
    if stack:
        return stack[-1]
    # per-thread default counter: two threads building graphs must not
    # race one shared dict into duplicate names
    if not hasattr(NameManager._state, "default"):
        NameManager._state.default = NameManager()
    return NameManager._state.default
