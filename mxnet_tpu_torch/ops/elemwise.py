"""Elementwise, scalar and broadcast ops of the port.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the ``_UNARY``, ``_BINARY``
and ``_SCALAR`` tables (L44-170) with their names and aliases,
``identity``, ``BlockGrad``, ``make_loss``, ``softrelu``, ``smooth_l1``,
``clip``, ``Cast`` and ``add_n``. Each is one torch expression; the
reference's conventions hold where torch's differ:

- ``round`` rounds halves away from zero and ``rint`` to the floor
  (torch's ``round`` is half to even); ``fix`` truncates.
- ``mod`` is floored, as numpy's, and a divisor of 0 gives 0, not NaN
  (``_ref_mod``).
- Comparisons and logical ops return the left operand's dtype (MXNet
  returns numbers, never booleans).
- No op promotes: float32 stays float32 (a Python scalar never widens a
  tensor in torch either).
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import Params, np_dtype, param_field
from .registry import _ALIASES, register_op

#: numpy dtype -> torch dtype, for Cast and the NDArray constructors
TORCH_DTYPES = {_np.dtype(k): v for k, v in (
    (_np.float32, torch.float32), (_np.float64, torch.float64),
    (_np.float16, torch.float16), (_np.uint8, torch.uint8),
    (_np.int8, torch.int8), (_np.int32, torch.int32),
    (_np.int64, torch.int64), (_np.bool_, torch.bool))}


def torch_dtype(dtype):
    """A user dtype spec (str / numpy / torch) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "bfloat16":
        return torch.bfloat16
    return TORCH_DTYPES[np_dtype(dtype)]


def _ref_mod(a, b):
    """The reference's mod (mshadow_op.h:394): floored like numpy's, but a
    divisor of 0 gives 0. Both ``where`` sides stay finite, so no NaN
    reaches the gradient of the zero lanes."""
    zero = b == 0
    safe = torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, torch.zeros((), dtype=torch.result_type(a, b),
                                         device=zero.device),
                       torch.remainder(a, safe))


def round_half_away(x):
    """C ``round()``: halves away from zero. ``x - trunc(x)`` is exact, so
    no half is misjudged (``floor(|x| + 0.5)`` rounds 0.49999997 up)."""
    if not x.is_floating_point():
        return x
    t = torch.trunc(x)
    up = (x - t).abs() >= 0.5
    return torch.where(up, t + torch.sign(x), t)


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _as_dtype(out, like):
    return out.to(like.dtype)


# ---------------------------------------------------------------------------
# unary
# ---------------------------------------------------------------------------

_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "negative": torch.neg,
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "square": torch.square, "reciprocal": lambda x: 1.0 / x,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "floor": torch.floor, "ceil": torch.ceil,
    "round": round_half_away,
    "rint": lambda x: torch.where(x - torch.floor(x) <= torch.ceil(x) - x,
                                  torch.floor(x), torch.ceil(x)),
    "trunc": torch.trunc, "fix": torch.trunc,
    "sigmoid": torch.sigmoid, "relu": torch.relu,
    "softsign": F.softsign,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "logical_not": lambda x: _as_dtype(x == 0, x),
}


def _make_unary(fn):
    def op(params, x):
        return fn(x)
    return op


for _name, _fn in _UNARY.items():
    register_op(_name)(_make_unary(_fn))

register_op("identity", aliases=("_copy", "stop_gradient_off"))(
    lambda params, x: x)
class _BlockGrad(torch.autograd.Function):
    """Identity whose gradient is zero (``lax.stop_gradient``): unlike a
    detach, the output stays on the graph, so a head behind it still
    differentiates (to zeros), as in the reference."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


register_op("BlockGrad", aliases=("stop_gradient",))(
    lambda params, x: _BlockGrad.apply(x))
register_op("make_loss")(lambda params, x: x)
register_op("softrelu")(
    lambda params, x: torch.logaddexp(x, torch.zeros_like(x)))

# ---------------------------------------------------------------------------
# binary (the same-shape and broadcast forms share one body: torch
# broadcasts; MXNet tells them apart only in shape inference)
# ---------------------------------------------------------------------------

_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "mod": _ref_mod, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": torch.hypot,
    "equal": lambda a, b: _as_dtype(a == b, a),
    "not_equal": lambda a, b: _as_dtype(a != b, a),
    "greater": lambda a, b: _as_dtype(a > b, a),
    "greater_equal": lambda a, b: _as_dtype(a >= b, a),
    "lesser": lambda a, b: _as_dtype(a < b, a),
    "lesser_equal": lambda a, b: _as_dtype(a <= b, a),
    "logical_and": lambda a, b: _as_dtype((a != 0) & (b != 0), a),
    "logical_or": lambda a, b: _as_dtype((a != 0) | (b != 0), a),
    "logical_xor": lambda a, b: _as_dtype((a != 0) ^ (b != 0), a),
}


def _make_binary(fn):
    def op(params, lhs, rhs):
        return fn(lhs, rhs)
    return op


for _name, _fn in _BINARY.items():
    register_op("elemwise_" + _name if _name in ("add", "sub", "mul", "div")
                else _name,
                aliases=("_" + _name, "broadcast_" + _name),
                input_names=("lhs", "rhs"))(_make_binary(_fn))

_ALIASES.update({
    "broadcast_plus": "elemwise_add", "broadcast_minus": "elemwise_sub",
    "_plus": "elemwise_add", "_minus": "elemwise_sub",
    "_Plus": "elemwise_add", "_Minus": "elemwise_sub",
    "_Mul": "elemwise_mul", "_Div": "elemwise_div",
    "_Power": "power", "_Maximum": "maximum", "_Minimum": "minimum",
})


# ---------------------------------------------------------------------------
# scalar ops (elemwise_binary_scalar_op*.cc: _plus_scalar, ...)
# ---------------------------------------------------------------------------


class ScalarParam(Params):
    scalar = param_field(float, default=0.0)


def _scalar_like(x, s):
    """``jnp.asarray(s, x.dtype)``: the scalar in ``x``'s dtype."""
    return torch.tensor(s, dtype=x.dtype, device=x.device)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: _ref_mod(x, _scalar_like(x, s)),
    "_rmod_scalar": lambda x, s: _ref_mod(_scalar_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    # maximum/minimum, not clamp: a tie splits the gradient, as jax does
    "_maximum_scalar": lambda x, s: torch.maximum(x, _scalar_like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _scalar_like(x, s)),
    "_equal_scalar": lambda x, s: _as_dtype(x == s, x),
    "_not_equal_scalar": lambda x, s: _as_dtype(x != s, x),
    "_greater_scalar": lambda x, s: _as_dtype(x > s, x),
    "_greater_equal_scalar": lambda x, s: _as_dtype(x >= s, x),
    "_lesser_scalar": lambda x, s: _as_dtype(x < s, x),
    "_lesser_equal_scalar": lambda x, s: _as_dtype(x <= s, x),
}


def _make_scalar(fn):
    def op(params, x):
        return fn(x, params.scalar)
    return op


for _name, _fn in _SCALAR.items():
    register_op(_name, aliases=("_PlusScalar",) if _name == "_plus_scalar"
                else (), param_cls=ScalarParam)(_make_scalar(_fn))


class SmoothL1Param(Params):
    scalar = param_field(float, default=1.0)


@register_op("smooth_l1", param_cls=SmoothL1Param)
def _smooth_l1(params, x):
    """elemwise_binary_scalar_op_extended.cc:86 (the SSD loss's term)."""
    sigma2 = params.scalar * params.scalar
    absx = x.abs()
    return torch.where(absx < 1.0 / sigma2, 0.5 * sigma2 * x * x,
                       absx - 0.5 / sigma2)


class ClipParam(Params):
    a_min = param_field(float, default=None)
    a_max = param_field(float, default=None)


@register_op("clip", param_cls=ClipParam)
def _clip(params, x):
    return torch.clamp(x, params.a_min, params.a_max)


class CastParam(Params):
    dtype = param_field(str, default="float32")


@register_op("Cast", aliases=("cast",), param_cls=CastParam)
def _cast(params, x):
    return x.to(torch_dtype(params.dtype))


class AddNParam(Params):
    num_args = param_field(int, default=2, required=False)


@register_op("add_n", aliases=("ElementWiseSum", "_sum"), param_cls=AddNParam,
             key_var_num_args="num_args",
             input_names=lambda p: tuple(
                 "arg%d" % i for i in range(p.num_args if p else 2)))
def _add_n(params, *args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
