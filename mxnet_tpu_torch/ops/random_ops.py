"""Random sampling ops of the port (``mxnet_tpu/ops/random_ops.py``, its 15
registrations: ``_random_*``, ``_sample_*``, ``shuffle``).

Each op draws from the ``torch.Generator`` its caller hands it (``rng``;
``random.generator(device)`` for ``mx.nd`` calls, one generator a step
in a training step), never from torch's global RNG. The values are
torch's and never equal jax's: the ops are held to the reference by their
moments and by reproducibility from a seed. On ``meta`` tensors (shape
inference) nothing is drawn.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, Params, param_field
from .elemwise import torch_dtype
from .registry import register_op


def _meta(device):
    return torch.device(device).type == "meta"


def _need(rng):
    if rng is None:
        raise MXNetError("a sampling op ran without a generator")
    return rng


def uniform01(shape, rng, device, dtype=torch.float32):
    """U[0, 1) from ``rng`` (nothing is drawn on ``meta``); Dropout's and
    rrelu's draw too."""
    if _meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.rand(shape, generator=_need(rng), dtype=dtype,
                      device=device)


def _normal(shape, rng, device):
    if _meta(device):
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=_need(rng), device=device)


def _gamma(alpha, rng):
    """Gamma(alpha, 1) a lane, ``alpha`` a float32 tensor."""
    if _meta(alpha.device):
        return torch.empty_like(alpha)
    return torch._standard_gamma(alpha, generator=_need(rng))


def _poisson(lam, rng):
    if _meta(lam.device):
        return torch.empty_like(lam)
    return torch.poisson(lam, generator=_need(rng))


def _exponential(shape, rng, device):
    if _meta(device):
        return torch.empty(shape, device="meta")
    return torch.empty(shape, device=device).exponential_(
        1.0, generator=_need(rng))


class SampleParam(Params):
    shape = param_field(tuple, default=())
    dtype = param_field(str, default="float32")
    ctx = param_field(str, default=None)


class UniformParam(SampleParam):
    low = param_field(float, default=0.0)
    high = param_field(float, default=1.0)


def _out(x, params):
    return x.to(torch_dtype(params.dtype))


@register_op("_random_uniform", aliases=("uniform", "random_uniform"),
             param_cls=UniformParam, input_names=(), need_rng=True)
def _random_uniform(params, rng=None, device=None):
    u = uniform01(params.shape, rng, device)
    return _out(params.low + (params.high - params.low) * u, params)


class NormalParam(SampleParam):
    loc = param_field(float, default=0.0)
    scale = param_field(float, default=1.0)


@register_op("_random_normal", aliases=("normal", "random_normal"),
             param_cls=NormalParam, input_names=(), need_rng=True)
def _random_normal(params, rng=None, device=None):
    return _out(_normal(params.shape, rng, device) * params.scale
                + params.loc, params)


class GammaParam(SampleParam):
    alpha = param_field(float, default=1.0)
    beta = param_field(float, default=1.0)


@register_op("_random_gamma", aliases=("random_gamma",), param_cls=GammaParam,
             input_names=(), need_rng=True)
def _random_gamma(params, rng=None, device=None):
    alpha = torch.full(params.shape, params.alpha, device=device)
    return _out(_gamma(alpha, rng) * params.beta, params)


class ExpParam(SampleParam):
    lam = param_field(float, default=1.0)


@register_op("_random_exponential", aliases=("random_exponential",),
             param_cls=ExpParam, input_names=(), need_rng=True)
def _random_exponential(params, rng=None, device=None):
    return _out(_exponential(params.shape, rng, device) / params.lam, params)


@register_op("_random_poisson", aliases=("random_poisson",),
             param_cls=ExpParam, input_names=(), need_rng=True)
def _random_poisson(params, rng=None, device=None):
    lam = torch.full(params.shape, params.lam, device=device)
    return _out(_poisson(lam, rng), params)


class NegBinParam(SampleParam):
    k = param_field(int, default=1)
    p = param_field(float, default=1.0)


@register_op("_random_negative_binomial",
             aliases=("random_negative_binomial",), param_cls=NegBinParam,
             input_names=(), need_rng=True)
def _random_negative_binomial(params, rng=None, device=None):
    # NB(k, p) = Poisson(Gamma(k, (1 - p) / p))
    k = torch.full(params.shape, float(params.k), device=device)
    lam = _gamma(k, rng) * (1 - params.p) / params.p
    return _out(_poisson(lam, rng), params)


class MultinomialParam(Params):
    shape = param_field(tuple, default=())
    get_prob = param_field(bool, default=False)
    dtype = param_field(str, default="int32")


@register_op("_sample_multinomial", aliases=("sample_multinomial",),
             param_cls=MultinomialParam, input_names=("data",), need_rng=True,
             num_outputs=lambda p: 2 if (p and p.get_prob) else 1)
def _sample_multinomial(params, data, rng=None):
    """``shape`` draws (one without it) from each row of probabilities
    ``data`` (the last axis); with ``get_prob`` also their log-probability
    under ``log_softmax(log(data))``."""
    n = math.prod(params.shape) if params.shape else 1
    rows = data.reshape(-1, data.shape[-1])
    if _meta(data.device):
        idx = torch.empty((rows.shape[0], n), dtype=torch.int64,
                          device="meta")
    else:
        idx = torch.multinomial(rows.float().clamp_min(1e-37), n,
                                replacement=True, generator=_need(rng))
    out_shape = data.shape[:-1] + tuple(params.shape)
    samp = idx.reshape(out_shape).to(torch_dtype(params.dtype))
    if not params.get_prob:
        return samp
    logp = torch.log_softmax(torch.log(torch.clamp_min(data, 1e-37)), dim=-1)
    lp = torch.gather(logp.reshape(rows.shape), 1, idx)
    return samp, lp.reshape(out_shape)


@register_op("shuffle", aliases=("_shuffle",), input_names=("data",),
             need_rng=True)
def _shuffle(params, data, rng=None):
    """A random permutation of ``data``'s first axis."""
    if _meta(data.device):
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=_need(rng),
                          device=data.device)
    return data.index_select(0, perm)


# ---------------------------------------------------------------------------
# per-element distribution parameters (multisample_op.cc: _sample_uniform,
# ...): each input element is one distribution, ``shape`` draws of it
# ---------------------------------------------------------------------------


class MultiSampleParam(Params):
    shape = param_field(tuple, default=())
    dtype = param_field(str, default="float32")


def _ms_shape(params, base):
    return tuple(base.shape) + tuple(params.shape or ())


def _expand(x, out_shape):
    """``x`` with trailing unit dims, broadcastable to ``out_shape``."""
    return x.reshape(tuple(x.shape) + (1,) * (len(out_shape) - x.dim()))


def _ms_out(x, params):
    return x.to(torch_dtype(params.dtype or "float32"))


@register_op("_sample_uniform", aliases=("sample_uniform",),
             param_cls=MultiSampleParam, input_names=("low", "high"),
             need_rng=True)
def _sample_uniform(params, low, high, rng=None):
    out_shape = _ms_shape(params, low)
    lo, hi = _expand(low, out_shape), _expand(high, out_shape)
    return _ms_out(lo + uniform01(out_shape, rng, low.device) * (hi - lo),
                   params)


@register_op("_sample_normal", aliases=("sample_normal",),
             param_cls=MultiSampleParam, input_names=("mu", "sigma"),
             need_rng=True)
def _sample_normal(params, mu, sigma, rng=None):
    out_shape = _ms_shape(params, mu)
    z = _normal(out_shape, rng, mu.device)
    return _ms_out(_expand(mu, out_shape) + z * _expand(sigma, out_shape),
                   params)


@register_op("_sample_gamma", aliases=("sample_gamma",),
             param_cls=MultiSampleParam, input_names=("alpha", "beta"),
             need_rng=True)
def _sample_gamma(params, alpha, beta, rng=None):
    out_shape = _ms_shape(params, alpha)
    a = _expand(alpha, out_shape).float().expand(out_shape).contiguous()
    return _ms_out(_gamma(a, rng) * _expand(beta, out_shape), params)


@register_op("_sample_exponential", aliases=("sample_exponential",),
             param_cls=MultiSampleParam, input_names=("lam",), need_rng=True)
def _sample_exponential(params, lam, rng=None):
    out_shape = _ms_shape(params, lam)
    e = _exponential(out_shape, rng, lam.device)
    return _ms_out(e / _expand(lam, out_shape), params)


@register_op("_sample_poisson", aliases=("sample_poisson",),
             param_cls=MultiSampleParam, input_names=("lam",), need_rng=True)
def _sample_poisson(params, lam, rng=None):
    out_shape = _ms_shape(params, lam)
    rate = _expand(lam, out_shape).float().expand(out_shape).contiguous()
    return _ms_out(_poisson(rate, rng), params)


@register_op("_sample_negative_binomial",
             aliases=("sample_negative_binomial",),
             param_cls=MultiSampleParam, input_names=("k", "p"),
             need_rng=True)
def _sample_negative_binomial(params, k, p, rng=None):
    out_shape = _ms_shape(params, k)
    kk = _expand(k, out_shape).float().expand(out_shape).contiguous()
    pp = _expand(p, out_shape)
    # NB(k, p) = Poisson(Gamma(k, (1 - p) / p))
    lam = _gamma(kk, rng) * (1 - pp) / pp
    return _ms_out(_poisson(lam, rng), params)


@register_op("_sample_generalized_negative_binomial",
             aliases=("sample_generalized_negative_binomial",),
             param_cls=MultiSampleParam, input_names=("mu", "alpha"),
             need_rng=True)
def _sample_generalized_negative_binomial(params, mu, alpha, rng=None):
    out_shape = _ms_shape(params, mu)
    m = _expand(mu, out_shape).expand(out_shape)
    a = _expand(alpha, out_shape).expand(out_shape)
    # GNB(mu, alpha) = Poisson(Gamma(1 / alpha, mu * alpha)); alpha -> 0 is
    # Poisson(mu)
    a_safe = torch.clamp_min(a, 1e-6)
    lam = _gamma((1.0 / a_safe).float().contiguous(), rng) * m * a_safe
    lam = torch.where(a < 1e-6, m, lam)
    return _ms_out(_poisson(lam.float().contiguous(), rng), params)
