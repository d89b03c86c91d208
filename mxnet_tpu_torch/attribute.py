"""``AttrScope``: attributes attached to every symbol made inside a scope
(reference: ``mxnet_tpu/attribute.py``).

``with mx.AttrScope(ctx_group="dev1"):`` gives each ``Variable`` and each
op node created inside the scope (and the weight variables an op makes
for itself) those attributes, as strings. Scopes nest; an inner scope's
keys override the outer ones. The stack is per thread.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]


class AttrScope:
    """Attach user attributes to the symbols created within the scope."""

    _local = threading.local()

    def __init__(self, **kwargs):
        self._attrs = {k: str(v) for k, v in kwargs.items()}

    @classmethod
    def _stack(cls):
        if not hasattr(cls._local, "stack"):
            cls._local.stack = []
        return cls._local.stack

    @classmethod
    def get_current(cls):
        merged = {}
        for scope in cls._stack():
            merged.update(scope._attrs)
        return merged

    def __enter__(self):
        self._stack().append(self)
        return self

    def __exit__(self, *exc):
        self._stack().pop()


def current_attrs():
    """The attributes of the scopes open in this thread, merged."""
    return AttrScope.get_current()
