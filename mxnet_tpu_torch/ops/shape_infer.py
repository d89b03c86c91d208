"""Learnable-parameter shape inference hooks.

Counterpart of ``mxnet_tpu/ops/shape_infer.py`` for the port's ops (the
quantized ops' hooks wait for their ops, ROADMAP A9): each
op's output shapes come from running it on ``meta`` tensors
(``OpDef.infer``); these hooks supply the *input* shapes that running the
op cannot derive (weights, aux states, labels).

Hook signature: hook(params, shapes: dict name->shape|None) -> dict of
filled names. Backfill hooks run the other way: a 0 in a known shape
means "unknown dim" (the MXNet convention), filled from a known weight.
"""
from __future__ import annotations

import numpy as _np

PARAM_SHAPE_HOOKS = {}
BACKFILL_SHAPE_HOOKS = {}


def hook(name):
    def deco(fn):
        PARAM_SHAPE_HOOKS[name] = fn
        return fn
    return deco


def backfill_hook(name):
    def deco(fn):
        BACKFILL_SHAPE_HOOKS[name] = fn
        return fn
    return deco


@backfill_hook("FullyConnected")
def _fc_backfill(params, shapes):
    w = shapes.get("weight")
    data = shapes.get("data")
    if w is None or data is None or 0 in w:
        return {}
    in_dim = w[1]
    if params.flatten and len(data) == 2 and data[1] == 0:
        return {"data": (data[0], in_dim)}
    if not params.flatten and data[-1] == 0:
        return {"data": tuple(data[:-1]) + (in_dim,)}
    return {}


@backfill_hook("Convolution")
def _conv_backfill(params, shapes):
    w = shapes.get("weight")
    data = shapes.get("data")
    if w is None or data is None or 0 in w:
        return {}
    if len(data) >= 2 and data[1] == 0:
        return {"data": (data[0], w[1] * params.num_group) + tuple(data[2:])}
    return {}


@hook("FullyConnected")
def _fc(params, shapes):
    data = shapes["data"]
    in_dim = int(_np.prod(data[1:])) if params.flatten else data[-1]
    out = {"weight": (params.num_hidden, in_dim)}
    if not params.no_bias:
        out["bias"] = (params.num_hidden,)
    return out


@hook("Convolution")
def _conv(params, shapes):
    c = shapes["data"][1]
    out = {"weight": (params.num_filter, c // params.num_group)
           + tuple(params.kernel)}
    if not params.no_bias:
        out["bias"] = (params.num_filter,)
    return out


@hook("Deconvolution")
def _deconv(params, shapes):
    c = shapes["data"][1]
    out = {"weight": (c, params.num_filter // params.num_group)
           + tuple(params.kernel)}
    if not params.no_bias:
        out["bias"] = (params.num_filter,)
    return out


@hook("BatchNorm")
def _bn(params, shapes):
    c = shapes["data"][params.axis % len(shapes["data"])]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


@hook("SoftmaxOutput")
def _softmax_output(params, shapes):
    data = shapes.get("data")
    if data is None:
        return {}
    if params.multi_output:
        return {"label": (data[0],) + tuple(data[2:])}
    if params.preserve_shape or len(data) > 2:
        return {"label": tuple(data[:-1])}
    return {"label": (data[0],)}


@hook("LayerNorm")
def _ln(params, shapes):
    c = shapes["data"][params.axis % len(shapes["data"])]
    return {"gamma": (c,), "beta": (c,)}


@hook("InstanceNorm")
def _in(params, shapes):
    c = shapes["data"][1]
    return {"gamma": (c,), "beta": (c,)}


@hook("Embedding")
def _emb(params, shapes):
    return {"weight": (params.input_dim, params.output_dim)}


@hook("LeakyReLU")
def _prelu(params, shapes):
    if params.act_type == "prelu":
        return {"gamma": (shapes["data"][1],)}
    return {}


@hook("SVMOutput")
def _svm_output(params, shapes):
    data = shapes.get("data")
    return {"label": (data[0],)} if data else {}


def _same_label(params, shapes):
    data = shapes.get("data")
    return {"label": tuple(data)} if data else {}


for _name in ("LinearRegressionOutput", "MAERegressionOutput",
              "LogisticRegressionOutput"):
    hook(_name)(_same_label)


@hook("RNN")
def _rnn(params, shapes):
    from .nn import rnn_param_size
    data = shapes["data"]  # (T, N, I)
    d = 2 if params.bidirectional else 1
    n = rnn_param_size(params.mode, data[2], params.state_size,
                       params.num_layers, params.bidirectional)
    out = {"parameters": (n,),
           "state": (params.num_layers * d, data[1], params.state_size)}
    if params.mode == "lstm":
        out["state_cell"] = out["state"]
    return out


@hook("LSoftmax")
def _lsoftmax(params, shapes):
    data = shapes["data"]
    return {"weight": (params.num_hidden, int(_np.prod(data[1:])))}


@hook("IdentityAttachKLSparseReg")
def _kl_sparse_reg(params, shapes):
    # moving_avg tracks each unit's mean activation: data's shape sans batch
    data = shapes.get("data")
    return {"moving_avg": tuple(data[1:])} if data else {}
