"""``mx.mod`` of the port: ``Module`` on one device (reference:
``mxnet_tpu/module/``). ``BucketingModule`` is not yet ported (ROADMAP
A3)."""
from ..base import MXNetError
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup"]


def __getattr__(name):
    if name == "BucketingModule":
        raise MXNetError("mx.mod.BucketingModule is not yet ported "
                         "(ROADMAP A3)")
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
