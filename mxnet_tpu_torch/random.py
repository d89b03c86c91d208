"""Global PRNG state: ``mx.random.seed`` (reference:
``mxnet_tpu/random.py`` ``seed`` L26, MXNet's
``src/common/random_generator.h``), and the seed of a stochastic train
step.

The JAX package keeps one functional key chain; the port keeps one
``torch.Generator`` per device, made on first use from the last seed
(0 until ``seed`` is called), and the initializers draw from the
generator of the array's device, as do the imperative stochastic ops
(``mx.nd.Dropout``, ``mx.nd.random.*``) and an ``Executor``'s stochastic
nodes. The values are torch's and differ from jax's, and a card's stream
differs from the CPU's: weights cross between the packages as ``.params``
files, never as seeds.

A training step of a graph with stochastic ops (``DataParallelTrainStep``)
draws its seed as the reference's does, ``numpy.random.randint(0,
2**31)`` once a step (``mxnet_tpu/parallel/tpu_step.py:605-610``;
``step_seed``), and seeds a generator on its device with it: a fit from
one ``numpy.random.seed`` draws the same numbers, bit for bit.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["seed", "generator", "step_seed"]

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


def step_seed():
    """One training step's seed, from numpy's global RNG (the reference's
    draw)."""
    return int(_np.random.randint(0, 2 ** 31))
