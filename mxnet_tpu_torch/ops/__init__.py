"""Operators of the port: the registry and the op families (ROADMAP A6).
Importing this package registers them, ``Custom`` (the Python user op
of ``mxnet_tpu_torch.operator``) included."""
from . import elemwise, nn, optimizer_ops, random_ops, tensor  # noqa: F401
from .registry import OPS, OpDef, draws, find_op, get_op, list_ops, \
    register_op
from .. import operator  # noqa: F401,E402  (registers Custom)

__all__ = ["OPS", "OpDef", "draws", "find_op", "get_op", "list_ops",
           "register_op"]
