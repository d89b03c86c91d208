"""Operators of the port: the registry and the op families (ROADMAP A6),
imported in the reference's order (``mxnet_tpu/ops/__init__.py``, its
quantization family aside: ROADMAP A9), so that the compat aliases find
their targets. Importing this package registers them, ``Custom`` (the
Python user op of ``mxnet_tpu_torch.operator``) included."""
from . import elemwise  # noqa: F401
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import random_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import fork_ops  # noqa: F401
from . import multibox  # noqa: F401
from . import vision  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import linalg_extra  # noqa: F401
from . import contrib_extra  # noqa: F401
from . import compat_extra  # noqa: F401
from . import image_ops  # noqa: F401
from .registry import OPS, OpDef, draws, find_op, get_op, list_ops, \
    register_op
from .. import operator  # noqa: F401,E402  (registers Custom)

__all__ = ["OPS", "OpDef", "draws", "find_op", "get_op", "list_ops",
           "register_op"]
