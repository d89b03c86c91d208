"""Model helpers of the port: the kvstore wiring of ``Module``, the
two-file checkpoint and ``FeedForward`` (reference: ``mxnet_tpu/model.py``
L26-356).

``prefix-symbol.json`` is the symbol JSON and ``prefix-%04d.params`` the
``arg:``/``aux:``-named arrays in the reference's binary format, so
checkpoints cross between the packages byte for byte.
``save_checkpoint(background=True)`` clones the arrays on the calling
thread (they are mutated in place by the next step) and writes them on a
daemon thread (``background_write``) once a CUDA event says the clones
exist; ``CheckpointHandle.wait`` joins it. ``FeedForward`` is the
reference's thin wrapper over ``Module``.
"""
from __future__ import annotations

import threading
from collections import namedtuple

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params", "save_params", "background_write",
           "CheckpointHandle", "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


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
            if kvstore == "local":
                # MXNET_KVSTORE_BIGARRAY_BOUND: with a param above the
                # bound the workers update, not the store
                from .base import get_env
                bound = get_env("MXNET_KVSTORE_BIGARRAY_BOUND",
                                1024 * 1024 * 16, int)
                max_size = max(_np.prod(param.shape)
                               for param in arg_params.values())
                if max_size > bound:
                    update_on_kvstore = False
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


class CheckpointHandle:
    """Returned by ``save_checkpoint(..., background=True)``; ``wait()``
    joins the writer thread and re-raises its error."""

    def __init__(self, thread, errbox):
        self._thread = thread
        self._errbox = errbox

    def wait(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise MXNetError("checkpoint write still in flight after %ss"
                             % timeout)
        if self._errbox:
            raise self._errbox[0]

    def done(self):
        return not self._thread.is_alive()


_INFLIGHT_WRITERS = []
_INFLIGHT_LOCK = threading.Lock()
_ATEXIT_REGISTERED = False


def _drain_inflight_writers():
    """At a normal exit: let the writers in flight finish."""
    while True:
        with _INFLIGHT_LOCK:
            if not _INFLIGHT_WRITERS:
                return
            t = _INFLIGHT_WRITERS.pop()
        if t.is_alive():
            t.join(timeout=60.0)


def background_write(write_fn, name="mx-checkpoint"):
    """Run ``write_fn`` on a daemon thread; its error surfaces at
    ``CheckpointHandle.wait()``. The caller snapshots what it writes
    first. Writers are joined at a normal exit."""
    import atexit
    errbox = []

    def _write():
        try:
            write_fn()
        except BaseException as e:  # surfaced via handle.wait()
            errbox.append(e)

    thread = threading.Thread(target=_write, name=name, daemon=True)
    global _ATEXIT_REGISTERED
    with _INFLIGHT_LOCK:
        if not _ATEXIT_REGISTERED:
            atexit.register(_drain_inflight_writers)
            _ATEXIT_REGISTERED = True
    # started before it is listed: the prune below must only see started
    # threads
    thread.start()
    with _INFLIGHT_LOCK:
        _INFLIGHT_WRITERS[:] = [t for t in _INFLIGHT_WRITERS
                                if t.is_alive()]
        _INFLIGHT_WRITERS.append(thread)
    return CheckpointHandle(thread, errbox)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    background=False):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``; with
    ``background=True`` on a daemon thread, from clones taken here, and
    return a ``CheckpointHandle``."""
    if not background:
        if symbol is not None:
            symbol.save("%s-symbol.json" % prefix)
        save_params("%s-%04d.params" % (prefix, epoch), arg_params,
                    aux_params)
        return None
    from .checkpoint.state import TrainingState, snapshot_params, \
        _ready_event
    snap = TrainingState(arg_params=snapshot_params(arg_params),
                         aux_params=snapshot_params(aux_params))
    snap.ready = _ready_event(snap.arg_params, snap.aux_params)

    def _write():
        snap.wait_ready()
        if symbol is not None:
            symbol.save("%s-symbol.json" % prefix)
        save_params("%s-%04d.params" % (prefix, epoch), snap.arg_params,
                    snap.aux_params)

    return background_write(_write)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params); the arrays are on the CPU."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params("%s-%04d.params" % (prefix, epoch))
    return symbol, arg_params, aux_params


class FeedForward:
    """The reference's legacy training API (reference: model.py:242), a
    thin wrapper over ``Module``: ``fit``, ``predict``, ``score``, ``save``,
    ``load`` and ``create``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _get_module(self, label_names=("softmax_label",)):
        from .module.module import Module
        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx,
                                  label_names=list(label_names))
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            checkpoint_manager=None):
        """Train through ``Module.fit`` (fresh executors a call, as the
        reference rebuilds them)."""
        from .io import NDArrayIter
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                            shuffle=True)
        label_names = [d.name for d in (X.provide_label or [])] or \
            ["softmax_label"]
        self._module = None
        mod = self._get_module(label_names)
        if logger is not None:
            mod.logger = logger
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=True,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor, checkpoint_manager=checkpoint_manager)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Inference over ``X`` in batches of ``numpy_batch_size`` (through
        ``Module.predict``); a numpy array."""
        from .io import NDArrayIter
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(X, batch_size=self.numpy_batch_size)
        mod = self._get_module()
        if not mod.binded:
            mod.bind(data_shapes=X.provide_data, for_training=False)
            mod.set_params(self.arg_params, self.aux_params or {})
        if reset:
            X.reset()
        out = mod.predict(X, num_batch=num_batch)
        return out.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None):
        from . import metric as metric_mod
        mod = self._get_module()
        if not mod.binded:
            mod.bind(data_shapes=X.provide_data,
                     label_shapes=X.provide_label, for_training=False)
            mod.set_params(self.arg_params, self.aux_params or {})
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        res = mod.score(X, eval_metric, num_batch=num_batch)
        return dict(res)[eval_metric.name]

    def save(self, prefix, epoch=None):
        epoch = epoch if epoch is not None else (self.num_epoch or 0)
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, **kwargs):
        """Train and return a model."""
        fit_kwargs = {k: kwargs.pop(k) for k in
                      ("eval_data", "eval_metric", "epoch_end_callback",
                       "batch_end_callback", "kvstore", "logger")
                      if k in kwargs}
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
        return model.fit(X, y, **fit_kwargs)
