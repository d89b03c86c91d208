"""Tensor manipulation, reduction, indexing, ordering, init and linalg
ops of the port.

Counterpart of ``mxnet_tpu/ops/tensor.py`` (its 55 registrations and
their aliases), one torch expression each, in the reference's
conventions:

- ``Reshape`` keeps MXNet's special codes 0/-1/-2/-3/-4 and ``reverse``
  (``infer_reshape_shape``, L28-104).
- The reductions take ``axis`` as a tuple, ``keepdims`` and ``exclude``.
- Index outputs (``argmax``, ``argsort``, ``topk``) are float32 (or the
  op's ``dtype``), where torch returns int64; index inputs (``take``,
  ``pick``, ``one_hot``, ``Embedding``) may be float and are truncated.
- ``take`` clips out-of-range indices (or wraps, ``mode="wrap"``).
- The init ops (``_zeros``, ``_arange``, ...) have no tensor input and
  make their output on the ``device`` their caller passes.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, Params, param_field
from .elemwise import torch_dtype
from .registry import register_op

# ---------------------------------------------------------------------------
# shape manipulation (matrix_op.cc)
# ---------------------------------------------------------------------------


class ReshapeParam(Params):
    shape = param_field(tuple, default=())
    reverse = param_field(bool, default=False)


def infer_reshape_shape(spec, ishape, reverse=False):
    """The reference's special codes (matrix_op-inl.h:73 InferReshapeShape):
    0 copies a dim, -1 infers one dim, -2 copies the remaining dims, -3
    merges two dims, -4 splits one dim into the next two values (one of
    them may be -1). ``reverse`` reverses input dims and spec before and
    after, as the reference does."""
    ishape = list(ishape)
    spec = list(spec)
    if reverse:
        ishape.reverse()
        spec.reverse()
    out, src, inf = [], 0, -1
    i = 0
    while i < len(spec):
        s = spec[i]
        if s == 0:
            if src >= len(ishape):
                raise MXNetError("Reshape: spec %s consumes more dims than "
                                 "input shape %s has" % (spec, ishape))
            out.append(ishape[src])
            src += 1
        elif s == -1:
            if inf >= 0:
                raise MXNetError("Reshape: one and only one dim can be -1")
            inf = len(out)
            out.append(1)
            src += 1  # the reference consumes an input dim here too
        elif s == -2:
            out.extend(ishape[src:])
            src = len(ishape)
        elif s == -3:
            if src + 1 >= len(ishape):
                raise MXNetError("Reshape -3: needs two input dims to merge")
            out.append(ishape[src] * ishape[src + 1])
            src += 2
        elif s == -4:
            if i + 2 >= len(spec) or src >= len(ishape):
                raise MXNetError("Reshape -4: needs a source dim and two "
                                 "split values")
            d0 = ishape[src]
            src += 1
            d1, d2 = spec[i + 1], spec[i + 2]
            i += 2
            if d1 == -1 and d2 == -1:
                raise MXNetError("Reshape -4: split dims cannot both be -1")
            if 0 in (d1, d2):
                raise MXNetError("Reshape -4: split dims must be positive "
                                 "or -1, got (%s, %s)" % (d1, d2))
            if d1 == -1:
                d1 = d0 // d2
            if d2 == -1:
                d2 = d0 // d1
            if d1 * d2 != d0:
                raise MXNetError("Reshape -4: %d x %d != source dim %d"
                                 % (d1, d2, d0))
            out.extend([d1, d2])
        else:
            out.append(int(s))
            src += 1
        i += 1
    if inf >= 0:
        known = math.prod(out)
        total = math.prod(ishape)
        if known == 0 or total % known:
            raise MXNetError("Reshape: cannot infer -1 (total %d vs known "
                             "%d) for spec %s on %s"
                             % (total, known, spec, ishape))
        out[inf] = total // known
    if reverse:
        out.reverse()
    return tuple(out)


@register_op("Reshape", aliases=("reshape",), param_cls=ReshapeParam)
def _reshape(params, x):
    return x.reshape(infer_reshape_shape(params.shape, x.shape,
                                         params.reverse))


class TransposeParam(Params):
    axes = param_field(tuple, default=())


@register_op("transpose", param_cls=TransposeParam)
def _transpose(params, x):
    axes = params.axes or tuple(reversed(range(x.dim())))
    return x.permute(*axes)


class SwapAxisParam(Params):
    dim1 = param_field(int, default=0)
    dim2 = param_field(int, default=0)


@register_op("SwapAxis", aliases=("swapaxes",), param_cls=SwapAxisParam)
def _swapaxes(params, x):
    return x.transpose(params.dim1, params.dim2)


@register_op("Flatten", aliases=("flatten",))
def _flatten(params, x):
    return x.reshape(x.shape[0], -1)


class ExpandDimsParam(Params):
    axis = param_field(int, default=0)


@register_op("expand_dims", param_cls=ExpandDimsParam)
def _expand_dims(params, x):
    return x.unsqueeze(params.axis)


class SqueezeParam(Params):
    axis = param_field(tuple, default=None)


@register_op("squeeze", param_cls=SqueezeParam)
def _squeeze(params, x):
    if params.axis is None:
        return x.squeeze()
    for ax in sorted((a % x.dim() for a in params.axis), reverse=True):
        if x.shape[ax] != 1:
            raise MXNetError("squeeze: axis %d has size %d, not 1"
                             % (ax, x.shape[ax]))
        x = x.squeeze(ax)
    return x


class SliceParam(Params):
    begin = param_field(tuple, default=())
    end = param_field(tuple, default=())
    step = param_field(tuple, default=())


def _positive_slice(x, axis, b, e, s):
    """``x[b:e:s]`` on ``axis``; a negative step (torch refuses one) as a
    flip of the positive slice numpy would take."""
    idx = [slice(None)] * x.dim()
    if s is None or s > 0:
        idx[axis] = slice(b, e, s)
        return x[tuple(idx)]
    positions = range(x.shape[axis])[slice(b, e, s)]
    index = torch.tensor(list(positions), dtype=torch.long, device=x.device)
    return x.index_select(axis, index)


@register_op("slice", aliases=("crop",), param_cls=SliceParam)
def _slice(params, x):
    step = params.step or (None,) * len(params.begin)
    for ax, (b, e, s) in enumerate(zip(params.begin, params.end, step)):
        x = _positive_slice(x, ax, b, e, s or None)
    return x


class SliceAxisParam(Params):
    axis = param_field(int, default=0)
    begin = param_field(int, default=0)
    end = param_field(int, default=None)


@register_op("slice_axis", param_cls=SliceAxisParam)
def _slice_axis(params, x):
    idx = [slice(None)] * x.dim()
    idx[params.axis] = slice(params.begin, params.end)
    return x[tuple(idx)]


class SliceLikeParam(Params):
    axes = param_field(tuple, default=())


@register_op("slice_like", param_cls=SliceLikeParam,
             input_names=("data", "shape_like"))
def _slice_like(params, x, like):
    axes = params.axes or tuple(range(x.dim()))
    idx = [slice(None)] * x.dim()
    for ax in axes:
        idx[ax] = slice(0, like.shape[ax])
    return x[tuple(idx)]


def _var_inputs(p):
    return tuple("arg%d" % i for i in range(p.num_args if p else 2))


class ConcatParam(Params):
    num_args = param_field(int, default=2)
    dim = param_field(int, default=1)


@register_op("Concat", aliases=("concat",), param_cls=ConcatParam,
             key_var_num_args="num_args", input_names=_var_inputs)
def _concat(params, *args):
    return torch.cat(args, dim=params.dim)


class StackParam(Params):
    num_args = param_field(int, default=2)
    axis = param_field(int, default=0)


@register_op("stack", param_cls=StackParam, key_var_num_args="num_args",
             input_names=_var_inputs)
def _stack(params, *args):
    return torch.stack(args, dim=params.axis)


class SplitParam(Params):
    num_outputs = param_field(int, default=1)
    axis = param_field(int, default=1)
    squeeze_axis = param_field(bool, default=False)


@register_op("SliceChannel", aliases=("split",), param_cls=SplitParam,
             num_outputs=lambda p: p.num_outputs if p else 1)
def _split(params, x):
    n, ax = params.num_outputs, params.axis
    if x.shape[ax] % n:
        raise MXNetError("split: axis %d of size %d does not split into %d"
                         % (ax, x.shape[ax], n))
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if params.squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


class TileParam(Params):
    reps = param_field(tuple, default=())


@register_op("tile", param_cls=TileParam)
def _tile(params, x):
    return x.tile(tuple(params.reps))


class RepeatParam(Params):
    repeats = param_field(int, default=1)
    axis = param_field(int, default=None)


@register_op("repeat", param_cls=RepeatParam)
def _repeat(params, x):
    if params.axis is None:
        return x.reshape(-1).repeat_interleave(params.repeats)
    return x.repeat_interleave(params.repeats, dim=params.axis)


class ReverseParam(Params):
    axis = param_field(tuple, default=())


@register_op("reverse", aliases=("flip",), param_cls=ReverseParam)
def _reverse(params, x):
    return x.flip(tuple(params.axis))


class PadParam(Params):
    mode = param_field(str, default="constant",
                       enum=("constant", "edge", "reflect"))
    pad_width = param_field(tuple, default=())
    constant_value = param_field(float, default=0.0)


@register_op("Pad", aliases=("pad",), param_cls=PadParam)
def _pad(params, x):
    pw = params.pad_width
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    widths = []
    for lo, hi in reversed(pairs):    # torch pads the last dim first
        widths += [lo, hi]
    if params.mode == "constant":
        return torch.nn.functional.pad(x, widths,
                                       value=params.constant_value)
    # torch pads edge/reflect only on the trailing (spatial) dims; the
    # leading pairs are (0, 0) in MXNet's 4-D/5-D use
    lead = 0
    while lead < len(pairs) and pairs[lead] == (0, 0):
        lead += 1
    mode = "replicate" if params.mode == "edge" else "reflect"
    return torch.nn.functional.pad(x, widths[:2 * (len(pairs) - lead)],
                                   mode=mode)


class BroadcastToParam(Params):
    shape = param_field(tuple, default=())


@register_op("broadcast_to", param_cls=BroadcastToParam)
def _broadcast_to(params, x):
    tgt = tuple(t if t != 0 else s for t, s in zip(params.shape, x.shape))
    return x.broadcast_to(tgt)


@register_op("broadcast_like", input_names=("lhs", "rhs"))
def _broadcast_like(params, x, like):
    return x.broadcast_to(like.shape)


@register_op("shape_array")
def _shape_array(params, x):
    return torch.tensor(x.shape, dtype=torch.int64, device=x.device)


@register_op("size_array")
def _size_array(params, x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register_op("zeros_like")
def _zeros_like(params, x):
    return torch.zeros_like(x)


@register_op("ones_like")
def _ones_like(params, x):
    return torch.ones_like(x)


# ---------------------------------------------------------------------------
# reductions (broadcast_reduce_op)
# ---------------------------------------------------------------------------


class ReduceParam(Params):
    axis = param_field(tuple, default=None)
    keepdims = param_field(bool, default=False)
    exclude = param_field(bool, default=False)


def _norm_axis(params, x):
    """The reduced dims as a tuple (all of them for None or ())."""
    axis = params.axis
    if axis in (None, ()):
        return tuple(range(x.dim()))
    axis = tuple(a % x.dim() for a in axis)
    if params.exclude:
        axis = tuple(i for i in range(x.dim()) if i not in axis)
    return axis


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=True)
    return x if keepdim else x.reshape(
        [s for i, s in enumerate(x.shape) if i not in dim])


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


_REDUCE = {
    "sum": torch.sum, "mean": torch.mean, "prod": _prod,
    "max": torch.amax, "min": torch.amin,
    "nansum": torch.nansum, "nanprod": _nanprod,
}


def _make_reduce(fn):
    def op(params, x):
        axis = _norm_axis(params, x)
        if not axis:
            return x
        return fn(x, dim=axis, keepdim=params.keepdims)
    return op


for _name, _fn in _REDUCE.items():
    register_op(_name, aliases={"sum": ("sum_axis",), "max": ("max_axis",),
                                "min": ("min_axis",)}.get(_name, ()),
                param_cls=ReduceParam)(_make_reduce(_fn))


@register_op("_square_sum", param_cls=ReduceParam)
def _square_sum(params, x):
    """Sum of squares along ``axis`` (square_sum-inl.h; dense here)."""
    return torch.sum(torch.square(x), dim=_norm_axis(params, x),
                     keepdim=params.keepdims)


class NormParam(Params):
    ord = param_field(int, default=2)
    axis = param_field(tuple, default=None)
    keepdims = param_field(bool, default=False)


@register_op("norm", param_cls=NormParam)
def _norm(params, x):
    axis = (tuple(range(x.dim())) if params.axis in (None, ())
            else params.axis)
    if params.ord == 1:
        return torch.sum(x.abs(), dim=axis, keepdim=params.keepdims)
    return torch.sqrt(torch.sum(torch.square(x.float()), dim=axis,
                                keepdim=params.keepdims)).to(x.dtype)


class AxisParam(Params):
    axis = param_field(int, default=None)
    keepdims = param_field(bool, default=False)


def _arg_reduce(fn, params, x):
    if params.axis is None:
        out = fn(x.reshape(-1))
        if params.keepdims:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=params.axis, keepdim=params.keepdims)
    return out.to(torch.float32)


@register_op("argmax", param_cls=AxisParam)
def _argmax(params, x):
    return _arg_reduce(torch.argmax, params, x)


@register_op("argmin", param_cls=AxisParam)
def _argmin(params, x):
    return _arg_reduce(torch.argmin, params, x)


@register_op("argmax_channel")
def _argmax_channel(params, x):
    return torch.argmax(x, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# dot / linalg (dot-inl.h, la_op.cc)
# ---------------------------------------------------------------------------


class DotParam(Params):
    transpose_a = param_field(bool, default=False)
    transpose_b = param_field(bool, default=False)
    forward_stype = param_field(str, default=None)


def _t(x, flag):
    return x.transpose(-1, -2) if flag and x.dim() > 1 else x


@register_op("dot", param_cls=DotParam, input_names=("lhs", "rhs"))
def _dot(params, a, b):
    a, b = _t(a, params.transpose_a), _t(b, params.transpose_b)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    # MXNet's dot contracts a's last axis with b's first (tensordot)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register_op("batch_dot", param_cls=DotParam, input_names=("lhs", "rhs"))
def _batch_dot(params, a, b):
    return torch.matmul(_t(a, params.transpose_a), _t(b, params.transpose_b))


@register_op("linalg_gemm2", input_names=("A", "B"), param_cls=DotParam)
def _linalg_gemm2(params, a, b):
    return torch.matmul(_t(a, params.transpose_a), _t(b, params.transpose_b))


@register_op("linalg_potrf", input_names=("A",))
def _potrf(params, a):
    return torch.linalg.cholesky(a)


class SyrkParam(Params):
    transpose = param_field(bool, default=False)
    alpha = param_field(float, default=1.0)


@register_op("linalg_syrk", input_names=("A",), param_cls=SyrkParam)
def _syrk(params, a):
    """alpha * A A^T (or A^T A), la_op.cc linalg_syrk."""
    at = a.transpose(-1, -2)
    out = torch.matmul(a, at) if not params.transpose else torch.matmul(at,
                                                                        a)
    return params.alpha * out


# ---------------------------------------------------------------------------
# indexing (indexing_op.cc)
# ---------------------------------------------------------------------------


class TakeParam(Params):
    axis = param_field(int, default=0)
    mode = param_field(str, default="clip", enum=("clip", "wrap", "raise"))


def index_of(indices):
    """Index input (float or int) as int64, truncated as ``astype(int32)``."""
    return indices.to(torch.int32).long()


@register_op("take", param_cls=TakeParam, input_names=("a", "indices"))
def _take(params, a, indices):
    n = a.shape[params.axis]
    idx = index_of(indices)
    idx = torch.remainder(idx, n) if params.mode == "wrap" else \
        idx.clamp(0, n - 1)
    out = a.index_select(params.axis, idx.reshape(-1))
    ax = params.axis % a.dim()
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register_op("pick", param_cls=AxisParam, input_names=("data", "index"))
def _pick(params, x, index):
    axis = params.axis if params.axis is not None else -1
    idx = index_of(index).unsqueeze(axis)
    picked = torch.gather(x, axis, idx.clamp(0, x.shape[axis] - 1))
    return picked if params.keepdims else picked.squeeze(axis)


class OneHotParam(Params):
    depth = param_field(int, required=True)
    on_value = param_field(float, default=1.0)
    off_value = param_field(float, default=0.0)
    dtype = param_field(str, default="float32")


def one_hot(indices, depth, dtype=torch.float32):
    """One-hot rows by comparison: an index outside [0, depth) gives a row
    of zeros, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(depth, device=indices.device)
    return (index_of(indices).unsqueeze(-1) == classes).to(dtype)


@register_op("one_hot", param_cls=OneHotParam, input_names=("indices",))
def _one_hot(params, indices):
    oh = one_hot(indices, params.depth)
    out = oh * (params.on_value - params.off_value) + params.off_value
    return out.to(torch_dtype(params.dtype))


@register_op("where", input_names=("condition", "x", "y"))
def _where(params, cond, x, y):
    return torch.where(cond != 0, x, y)


@register_op("gather_nd", input_names=("data", "indices"))
def _gather_nd(params, data, indices):
    idx = tuple(index_of(indices[i]) for i in range(indices.shape[0]))
    return data[idx]


class ScatterNDParam(Params):
    shape = param_field(tuple, default=())


@register_op("scatter_nd", param_cls=ScatterNDParam,
             input_names=("data", "indices"))
def _scatter_nd(params, data, indices):
    out = torch.zeros(params.shape, dtype=data.dtype, device=data.device)
    idx = tuple(index_of(indices[i]) for i in range(indices.shape[0]))
    return out.index_put(idx, data, accumulate=True)


# ---------------------------------------------------------------------------
# ordering (ordering_op.cc)
# ---------------------------------------------------------------------------


class TopkParam(Params):
    axis = param_field(int, default=-1)
    k = param_field(int, default=1)
    ret_typ = param_field(str, default="indices",
                          enum=("value", "indices", "mask", "both"))
    is_ascend = param_field(bool, default=False)
    dtype = param_field(str, default="float32")


@register_op("topk", param_cls=TopkParam,
             num_outputs=lambda p: 2 if (p and p.ret_typ == "both") else 1)
def _topk(params, x):
    axis = params.axis if params.axis is not None else -1
    # stable: equal values keep their order, as lax.top_k does
    idx = torch.sort(x, dim=axis, descending=not params.is_ascend,
                     stable=True)[1].narrow(axis, 0, params.k)
    vals = torch.gather(x, axis, idx)
    idxf = idx.to(torch_dtype(params.dtype))
    if params.ret_typ == "value":
        return vals
    if params.ret_typ == "indices":
        return idxf
    if params.ret_typ == "both":
        return vals, idxf
    return torch.zeros_like(x).scatter(axis, idx, 1.0)


class SortParam(Params):
    axis = param_field(int, default=-1)
    is_ascend = param_field(bool, default=True)


@register_op("sort", param_cls=SortParam)
def _sort(params, x):
    out = torch.sort(x, dim=params.axis, stable=True)[0]
    return out if params.is_ascend else out.flip(params.axis)


class ArgsortParam(SortParam):
    dtype = param_field(str, default="float32")


@register_op("argsort", param_cls=ArgsortParam)
def _argsort(params, x):
    out = torch.sort(x, dim=params.axis, stable=True)[1]
    if not params.is_ascend:
        out = out.flip(params.axis)
    return out.to(torch_dtype(params.dtype))


# ---------------------------------------------------------------------------
# init ops (init_op.cc): no tensor inputs, made on ``device``
# ---------------------------------------------------------------------------


class InitParam(Params):
    shape = param_field(tuple, default=())
    dtype = param_field(str, default="float32")
    ctx = param_field(str, default=None)


@register_op("_zeros", param_cls=InitParam, input_names=())
def _zeros_op(params, device=None):
    return torch.zeros(params.shape, dtype=torch_dtype(params.dtype),
                       device=device)


@register_op("_ones", param_cls=InitParam, input_names=())
def _ones_op(params, device=None):
    return torch.ones(params.shape, dtype=torch_dtype(params.dtype),
                      device=device)


class FullParam(InitParam):
    value = param_field(float, default=0.0)


@register_op("_full", param_cls=FullParam, input_names=())
def _full_op(params, device=None):
    return torch.full(params.shape, params.value,
                      dtype=torch_dtype(params.dtype), device=device)


class ArangeParam(Params):
    start = param_field(float, default=0.0)
    stop = param_field(float, default=None)
    step = param_field(float, default=1.0)
    repeat = param_field(int, default=1)
    dtype = param_field(str, default="float32")
    ctx = param_field(str, default=None)


def arange_values(start, stop, step, repeat, dtype, device):
    """numpy's ``arange`` (one argument: ``[0, start)``), then each value
    ``repeat`` times."""
    if stop is None:
        start, stop = 0.0, start
    n = max(int(math.ceil((stop - start) / step)), 0)
    out = (start + step * torch.arange(n, dtype=torch.float64,
                                       device=device)).to(dtype)
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return out


@register_op("_arange", param_cls=ArangeParam, input_names=())
def _arange_op(params, device=None):
    return arange_values(params.start, params.stop, params.step,
                         params.repeat, torch_dtype(params.dtype), device)


# ---------------------------------------------------------------------------
# sequence ops (sequence_{mask,last,reverse}.cc)
# ---------------------------------------------------------------------------


class SequenceParam(Params):
    use_sequence_length = param_field(bool, default=False)
    value = param_field(float, default=0.0)
    axis = param_field(int, default=0)


def _seq_inputs(p):
    if p is not None and p.use_sequence_length:
        return ("data", "sequence_length")
    return ("data",)


def _trailing(t, ndim):
    while t.dim() < ndim:
        t = t.unsqueeze(-1)
    return t


@register_op("SequenceMask", param_cls=SequenceParam, input_names=_seq_inputs)
def _sequence_mask(params, data, sequence_length=None):
    if not params.use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[params.axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :].to(torch.int32)
    if params.axis != 0:
        mask = mask.movedim(0, params.axis)
    mask = _trailing(mask, data.dim())
    return torch.where(mask, data, torch.full((), params.value,
                                              dtype=data.dtype,
                                              device=data.device))


@register_op("SequenceLast", param_cls=SequenceParam, input_names=_seq_inputs)
def _sequence_last(params, data, sequence_length=None):
    if not params.use_sequence_length or sequence_length is None:
        return data.select(params.axis, data.shape[params.axis] - 1)
    moved = data.movedim(params.axis, 0)                 # (T, N, ...)
    idx = (sequence_length.to(torch.int32) - 1).long()
    idx = idx.reshape((1, -1) + (1,) * (moved.dim() - 2)).expand(
        (1,) + moved.shape[1:])
    return torch.gather(moved, 0, idx)[0]


@register_op("SequenceReverse", param_cls=SequenceParam,
             input_names=_seq_inputs)
def _sequence_reverse(params, data, sequence_length=None):
    if not params.use_sequence_length or sequence_length is None:
        return data.flip(0)
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int32)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps).long()
    rev = _trailing(rev, data.dim()).expand(data.shape)
    return torch.gather(data, 0, rev)
