"""Device contexts: ``mx.cpu()`` / ``mx.gpu(i)`` as ``torch.device``.

The reference MXNet had ``kGPU`` natively; in the port a context is simply
a ``torch.device``. There is no silent CPU default: an entry point given
no device runs on the card, and raises when CUDA is missing, so a run
meant for the GPU can never quietly measure the CPU.

``tpu(i)`` is the reference's accelerator context, so scripts written for
it run unchanged: on the port it names the card, as ``gpu(i)`` does.
``host_scope()`` makes the CPU the default device of the calling thread
for its extent: a Python ``CustomOp``'s callbacks run under it, so the
arrays they make stay on the host their inputs were copied to.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError, env_flag

__all__ = ["cpu", "gpu", "tpu", "default_device", "resolve_device",
           "pin_float32", "host_scope"]

_local = threading.local()


def cpu(device_id=0):
    """The host; every ``cpu(i)`` is torch's one CPU device."""
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


tpu = gpu


@contextlib.contextmanager
def host_scope():
    """The CPU as this thread's default device while the scope lasts."""
    prior = getattr(_local, "device", None)
    _local.device = cpu()
    try:
        yield
    finally:
        _local.device = prior


def default_device():
    """``cuda:0`` (the CPU inside :func:`host_scope`); raises
    :class:`MXNetError` when CUDA is missing."""
    scoped = getattr(_local, "device", None)
    if scoped is not None:
        return scoped
    if not torch.cuda.is_available():
        raise MXNetError("CUDA is not available: pass device='cpu' to run "
                         "on the CPU")
    return gpu(0)


def resolve_device(device):
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``,
    checked for CUDA availability when it names the card."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("device %s requested but CUDA is not available"
                             % device)
        if device.index is None:
            device = gpu(0)
    return device


def pin_float32():
    """Keep float32 float32 on the card, as the reference computes it:
    turn off TF32 in cuBLAS's matmuls and cuDNN's convolutions (torch
    allows it in convolutions by default). ``MXNET_ALLOW_TF32=1`` leaves
    torch's settings as they are."""
    if not env_flag("MXNET_ALLOW_TF32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
