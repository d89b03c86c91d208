"""``mx.sym.random`` of the port (reference:
``mxnet_tpu/symbol/random.py``): each function builds the registered
sampling op's node; it draws when an executor or train step runs it,
from the generator that run hands its stochastic ops."""
from __future__ import annotations

import sys

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial"]


def _ops():
    return sys.modules[__name__.rsplit(".", 1)[0]]


def uniform(low=0, high=1, shape=(1,), dtype=None, **kwargs):
    return _ops()._random_uniform(low=low, high=high, shape=shape,
                                  dtype=dtype or "float32", **kwargs)


def normal(loc=0, scale=1, shape=(1,), dtype=None, **kwargs):
    return _ops()._random_normal(loc=loc, scale=scale, shape=shape,
                                 dtype=dtype or "float32", **kwargs)


def gamma(alpha=1, beta=1, shape=(1,), dtype=None, **kwargs):
    return _ops()._random_gamma(alpha=alpha, beta=beta, shape=shape,
                                dtype=dtype or "float32", **kwargs)


def exponential(scale=1, shape=(1,), dtype=None, **kwargs):
    return _ops()._random_exponential(lam=1.0 / scale, shape=shape,
                                      dtype=dtype or "float32", **kwargs)


def poisson(lam=1, shape=(1,), dtype=None, **kwargs):
    return _ops()._random_poisson(lam=lam, shape=shape,
                                  dtype=dtype or "float32", **kwargs)


def negative_binomial(k=1, p=1, shape=(1,), dtype=None, **kwargs):
    return _ops()._random_negative_binomial(
        k=k, p=p, shape=shape, dtype=dtype or "float32", **kwargs)


def generalized_negative_binomial(mu=1, alpha=1, shape=(1,), dtype=None,
                                  **kwargs):
    ops = _ops()
    one = ops._ones(shape=(1,))
    out = ops._sample_generalized_negative_binomial(
        one * mu, one * alpha, shape=shape, dtype=dtype or "float32",
        **kwargs)
    return ops.Reshape(out, shape=(shape,) if isinstance(shape, int)
                       else tuple(shape))


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kwargs):
    return _ops()._sample_multinomial(data, shape=shape, get_prob=get_prob,
                                      dtype=dtype, **kwargs)
