"""``mx.autograd`` of the port (reference: ``mxnet_tpu/autograd.py``).

``record()`` / ``pause()`` / ``train_mode()`` / ``predict_mode()``
scopes, ``backward``, ``grad`` and ``Function`` (a differentiable Python
function), over the imperative runtime (``imperative.py``), which records
on torch's autograd graph.
"""
from __future__ import annotations

import torch

from . import imperative as _imp

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]


def is_recording():
    return _imp.is_recording()


def is_training():
    return _imp.is_training()


def set_recording(is_record):
    return _imp.set_recording(is_record)


def set_training(train_mode_):
    return _imp.set_training(train_mode_)


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = _imp.set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = _imp.set_training(self._enter_train_mode)
        return self

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            _imp.set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            _imp.set_training(self._prev_train_mode)


def record(train_mode=True):
    """Record the ops of the scope for ``backward`` (reference:
    autograd.py:122); ops see ``is_train=train_mode``."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    _imp.mark_variables(variables, gradients, grad_reqs)


def _as_list(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        return [heads], (None if head_grads is None else [head_grads])
    return list(heads), head_grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    heads, head_grads = _as_list(heads, head_grads)
    _imp.backward(heads, head_grads, retain_graph=retain_graph,
                  train_mode=train_mode)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` for ``variables``, as new arrays
    (reference: autograd.py:270; ``create_graph`` raises there too)."""
    heads, head_grads = _as_list(heads, head_grads)
    single = not isinstance(variables, (list, tuple))
    out = _imp.grad(heads, [variables] if single else list(variables),
                    head_grads, retain_graph=retain_graph,
                    create_graph=create_graph)
    return out[0] if single or len(out) == 1 else out


class _Bridge(torch.autograd.Function):
    """A user ``Function``'s forward and backward on torch's graph."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        outs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        func._single = not isinstance(outs, (list, tuple))
        outs = [outs] if func._single else list(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            in_grads = ctx.func.backward(*[NDArray(g) for g in grads])
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        return (None,) + tuple(g._data for g in in_grads)


class Function:
    """A differentiable Python function (reference: autograd.py:364):
    subclass it and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays; both run with autograd
    paused, and ``backward`` returns one gradient an input."""

    def __init__(self):
        self._saved = None
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (is_recording() and any(i._data.requires_grad
                                       for i in inputs)):
            with pause():
                return self.forward(*inputs)
        with pause():
            # torch records the node: grad mode is on and an input
            # requires grad (pause only keeps the user's ops off the graph)
            outs = _Bridge.apply(self, *[i._data for i in inputs])
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if self._single else wrapped
