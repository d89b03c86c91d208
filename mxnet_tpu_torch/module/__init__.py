"""``mx.mod`` of the port: ``Module`` on one device and
``BucketingModule`` over it (reference: ``mxnet_tpu/module/``)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module",
           "DataParallelExecutorGroup"]
