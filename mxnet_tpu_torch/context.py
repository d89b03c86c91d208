"""Device contexts: ``mx.cpu()`` / ``mx.gpu(i)`` as ``torch.device``.

The reference MXNet had ``kGPU`` natively; in the port a context is simply
a ``torch.device``. There is no silent CPU default: an entry point given
no device runs on the card, and raises when CUDA is missing, so a run
meant for the GPU can never quietly measure the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve_device"]


def cpu():
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def default_device():
    """``cuda:0``; raises :class:`MXNetError` when CUDA is missing."""
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
