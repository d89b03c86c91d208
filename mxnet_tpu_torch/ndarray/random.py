"""``mx.nd.random`` of the port (reference: ``mxnet_tpu/ndarray/random.py``).

Each distribution is the registered sampling op (``ops/random_ops.py``)
called as ``mx.nd.<op>`` on ``ctx`` (the card when None), drawing from
``mx.random.generator`` of that device, which ``mx.random.seed`` resets.
"""
from __future__ import annotations

import torch

from .. import random as _rnd
from ..context import resolve_device
from ..ops.elemwise import torch_dtype
from .ndarray import NDArray, full

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "randint", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "seed"]


def _op(name, shape, ctx, dtype, out=None, **attrs):
    from . import invoke
    from ..ops import get_op
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return invoke(get_op(name), [], dict(attrs, shape=shape,
                                         dtype=dtype or "float32"),
                  out=out, ctx=ctx)


def uniform(low=0, high=1, shape=(1,), dtype=None, ctx=None, out=None,
            **kwargs):
    return _op("_random_uniform", shape, ctx, dtype, out, low=low, high=high)


def normal(loc=0, scale=1, shape=(1,), dtype=None, ctx=None, out=None,
           **kwargs):
    return _op("_random_normal", shape, ctx, dtype, out, loc=loc,
               scale=scale)


def randn(*shape, **kwargs):
    loc = kwargs.pop("loc", 0)
    scale = kwargs.pop("scale", 1)
    return normal(loc=loc, scale=scale, shape=shape or (1,), **kwargs)


def gamma(alpha=1, beta=1, shape=(1,), dtype=None, ctx=None, **kwargs):
    return _op("_random_gamma", shape, ctx, dtype, alpha=alpha, beta=beta)


def exponential(scale=1.0, shape=(1,), dtype=None, ctx=None, **kwargs):
    return _op("_random_exponential", shape, ctx, dtype, lam=1.0 / scale)


def poisson(lam=1.0, shape=(1,), dtype=None, ctx=None, **kwargs):
    return _op("_random_poisson", shape, ctx, dtype, lam=lam)


def negative_binomial(k=1, p=1, shape=(1,), dtype=None, ctx=None,
                      **kwargs):
    return _op("_random_negative_binomial", shape, ctx, dtype, k=k, p=p)


def generalized_negative_binomial(mu=1, alpha=1, shape=(1,), dtype=None,
                                  ctx=None, **kwargs):
    from . import _sample_generalized_negative_binomial as sample
    one = full((1,), 1.0, ctx=ctx)
    out = sample(one * mu, one * alpha, shape=(shape,)
                 if isinstance(shape, int) else tuple(shape),
                 dtype=dtype or "float32")
    return out.reshape(out.shape[1:])


def randint(low, high, shape=(1,), dtype="int32", ctx=None, **kwargs):
    device = resolve_device(ctx)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.randint(int(low), int(high), shape,
                                 generator=_rnd.generator(device),
                                 dtype=torch_dtype(dtype), device=device))


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kwargs):
    from . import _sample_multinomial
    return _sample_multinomial(data, shape=shape, get_prob=get_prob,
                               dtype=dtype)


def shuffle(data, **kwargs):
    from . import shuffle as _shuffle
    return _shuffle(data)


def seed(seed_state, ctx="all"):
    _rnd.seed(seed_state, ctx)
