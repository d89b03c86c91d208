"""The kernel-tier knob of the training path.

Counterpart of ``resolve_kernel_tier`` / ``kernel_tier_mode`` in
``mxnet_tpu/parallel/mesh_kernels.py``: the model's attention reads
``MXNET_TPU_MESH_KERNEL_TIER`` to pick the kernel tier or the plain tier,
in the port's vocabulary (``kernels.flash_attention.resolve_kernel_tier``):

    auto     the CUDA kernels on CUDA tensors, the plain tier on the CPU
             (default)
    1 / on   the CUDA kernels; CPU tensors raise
    0 / off  the plain tier (``blockwise_attention``) on any device

``interpret`` (the JAX package's Pallas interpret mode) has no counterpart
and raises, as does any other value. The mesh islands of that module
(``flash_attention_mesh``, ``fused_update_mesh``) arrive with distribution
(ROADMAP A10).
"""
from __future__ import annotations

import os

from ..kernels import flash_attention as _fa

__all__ = ["resolve_kernel_tier", "kernel_tier_mode"]

_ENV_TIER = "MXNET_TPU_MESH_KERNEL_TIER"


def kernel_tier_mode():
    """Raw MXNET_TPU_MESH_KERNEL_TIER value (default 'auto')."""
    return os.environ.get(_ENV_TIER, "auto").strip().lower() or "auto"


def resolve_kernel_tier(mode=None, *, device):
    """-> True when the kernel tier runs for tensors on ``device``.
    ``mode=None`` reads MXNET_TPU_MESH_KERNEL_TIER; unknown values and
    ``interpret`` raise ``MXNetError``."""
    return _fa.resolve_kernel_tier(kernel_tier_mode() if mode is None
                                   else mode, device)
