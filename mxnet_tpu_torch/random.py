"""Global PRNG state: ``mx.random.seed`` (reference:
``mxnet_tpu/random.py`` ``seed`` L26, MXNet's
``src/common/random_generator.h``).

The JAX package keeps one functional key chain; the port keeps one
``torch.Generator`` per device, made on first use from the last seed
(0 until ``seed`` is called), and the initializers draw from the
generator of the array's device. The values are torch's and differ from
jax's, and a card's stream differs from the CPU's: weights cross between
the packages as ``.params`` files, never as seeds.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_seed = 0
_generators = {}


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state, ctx="all"):
    """Reseed every device's generator (``ctx="all"``), or only the one
    of ``ctx``; generators made later start from this seed too when
    ``ctx`` is "all"."""
    global _seed
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            for gen in _generators.values():
                gen.manual_seed(_seed)
            return
        device = _key(ctx)
        _generators[device] = torch.Generator(device).manual_seed(
            int(seed_state))


def generator(device):
    """The generator of ``device``, made from the current seed on first
    use."""
    device = _key(device)
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = _generators[device] = torch.Generator(device).manual_seed(
                _seed)
        return gen
