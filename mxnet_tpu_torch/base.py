"""Core shared machinery of the PyTorch port: the error type and env config.

Counterpart of ``mxnet_tpu/base.py`` (``MXNetError``, ``get_env``,
``env_flag``), copied rather than imported so the port never pulls in JAX.
"""
from __future__ import annotations

import os

__all__ = ["MXNetError", "get_env", "env_flag"]


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
