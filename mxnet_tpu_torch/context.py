"""Device contexts: ``mx.cpu()`` / ``mx.gpu(i)`` as ``torch.device``.

The reference MXNet had ``kGPU`` natively; in the port a context is simply
a ``torch.device``. There is no silent CPU default: an entry point given
no device runs on the card, and raises when CUDA is missing, so a run
meant for the GPU can never quietly measure the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError, env_flag

__all__ = ["cpu", "gpu", "default_device", "resolve_device", "pin_float32"]


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


def pin_float32():
    """Keep float32 float32 on the card, as the reference computes it:
    turn off TF32 in cuBLAS's matmuls and cuDNN's convolutions (torch
    allows it in convolutions by default). ``MXNET_ALLOW_TF32=1`` leaves
    torch's settings as they are."""
    if not env_flag("MXNET_ALLOW_TF32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
