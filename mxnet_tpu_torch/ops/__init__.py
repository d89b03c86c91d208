"""Operators of the port: the registry and the ops of the symbolic
training path (ROADMAP A3). Importing this package registers them."""
from . import elemwise, nn, tensor  # noqa: F401  (registration)
from .registry import OPS, OpDef, find_op, get_op, list_ops, register_op

__all__ = ["OPS", "OpDef", "find_op", "get_op", "list_ops", "register_op"]
