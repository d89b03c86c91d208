"""Model helpers of the port: the kvstore wiring of ``Module`` and the
two-file checkpoint (reference: ``mxnet_tpu/model.py`` L26-241).

``prefix-symbol.json`` is the symbol JSON and ``prefix-%04d.params`` the
``arg:``/``aux:``-named arrays in the reference's binary format, so
checkpoints cross between the packages byte for byte. Writing on a
background thread (``background=True``) and ``FeedForward`` are not yet
ported (ROADMAP A8, A3).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "save_params"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def __getattr__(name):
    if name == "FeedForward":
        raise MXNetError("mx.model.FeedForward is not yet ported "
                         "(ROADMAP A3)")
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) for a kvstore given as an object, a
    type name or None (reference: model.py:26)."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore \
                and "tpu" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each gradient, pull each updated weight."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The updater on the worker (update_on_kvstore False)."""
    updates = [[] for _ in range(num_device)]
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updates[k].append((index * num_device + k, g, w))
    for dev_updates in updates:
        for upd in dev_updates:
            updater(*upd)


def save_params(fname, arg_params, aux_params=None):
    """``arg:``/``aux:``-named arrays in the reference's binary format."""
    from .ndarray.utils import save as _nd_save
    data = {}
    for prefix, params in (("arg:", arg_params), ("aux:", aux_params or {})):
        for k, v in params.items():
            data[prefix + k] = v if isinstance(v, NDArray) \
                else array(_np.asarray(v), ctx=cpu())
    _nd_save(fname, data)


def load_params(fname):
    """(arg_params, aux_params) of a ``.params`` file, on the CPU."""
    from .ndarray.utils import load as _nd_load
    data = _nd_load(fname)
    if isinstance(data, (list, tuple)):
        # an empty named save reads back as an empty list
        if data:
            raise MXNetError("load_params: %s holds unnamed arrays, not "
                             "arg:/aux: params" % fname)
        return {}, {}
    arg_params, aux_params = {}, {}
    for k, v in data.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    background=False):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``."""
    if background:
        raise MXNetError("save_checkpoint(background=True) is not yet "
                         "ported (ROADMAP A8)")
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_params("%s-%04d.params" % (prefix, epoch), arg_params, aux_params)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params); the arrays are on the CPU."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params("%s-%04d.params" % (prefix, epoch))
    return symbol, arg_params, aux_params
