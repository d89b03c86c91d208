"""The imperative runtime: eager op calls on ``NDArray``s, and autograd.

Counterpart of ``mxnet_tpu/imperative.py`` (reference
``src/imperative/imperative.cc``: ``Invoke`` L86, ``RecordOp`` L182,
``Backward`` L358). Where the JAX package keeps its own tape of per-op
VJP closures, the port records on torch's own autograd graph: an op run
while recording builds the graph through its inputs that require grad,
and ``backward`` asks ``torch.autograd.grad`` for the gradients of the
marked variables. The reference's semantics hold:

- recording and training are two thread-local flags; ``is_train`` of an
  op is the training flag;
- an op outside ``record()`` (or inside ``pause()``) runs under
  ``torch.no_grad()`` and builds no graph, even on arrays with attached
  gradients;
- ``mark_variables`` / ``attach_grad`` make an array a leaf that
  requires grad, with a gradient buffer and a ``grad_req`` of ``write``,
  ``add`` or ``null``; ``backward`` writes each reached variable's
  gradient IN PLACE into its buffer (``copy_`` for write, ``add_`` for
  add: torch accumulates by default), so a ``.grad`` handle a user keeps
  stays valid;
- ``head_grads`` seed the heads (ones where None);
- ``retain_graph=False`` frees the graph: the heads drop it, and a second
  ``backward`` through them raises ``MXNetError``.

The variables live in a weak set: ``backward`` asks for the gradient of
every live variable whose data requires grad, and writes those the
heads reach.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "mark_variables", "backward", "grad", "run_op"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()
_VARIABLES = weakref.WeakSet()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag):
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each array a leaf of the graph with gradient buffer ``grad``
    (reference: ``Imperative::MarkVariables``, imperative.cc:112)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, not %r"
                             % (req,))
        data = var._data.detach()
        if req != "null" and data.is_floating_point():
            data.requires_grad_(True)
        var._data = data
        var._grad = grad
        var._grad_req = req
        _VARIABLES.add(var)


def run_op(fn, tensors):
    """Run ``fn(*tensors)`` as an op of the imperative runtime: recorded
    on the autograd graph only while recording."""
    with torch.set_grad_enabled(_STATE.recording):
        return fn(*tensors)


def _seeds(heads, head_grads):
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(head_grads) != len(heads):
        raise MXNetError("head_grads has %d entries for %d heads"
                         % (len(head_grads), len(heads)))
    seeds = []
    for h, g in zip(heads, head_grads):
        if g is None:
            seeds.append(torch.ones_like(h._data))
        else:
            t = g._data if hasattr(g, "_data") else torch.as_tensor(g)
            seeds.append(t.detach().to(h._data.device, h._data.dtype))
    return seeds


def _grads(heads, head_grads, wrt, retain_graph, create_graph=False):
    """Gradients of ``heads`` for the tensors ``wrt`` (None where not
    reached); frees the heads' graph unless ``retain_graph``."""
    live = [(h, s) for h, s in zip(heads, _seeds(heads, head_grads))
            if h._data.requires_grad]
    if not live:
        raise MXNetError("cannot differentiate: outputs are not connected "
                         "to any recorded computation (did you forget "
                         "autograd.record()?)")
    try:
        grads = torch.autograd.grad(
            [h._data for h, _ in live], wrt, [s for _, s in live],
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e) or "freed" in str(e):
            raise MXNetError("backward: the graph was freed by an earlier "
                             "backward; pass retain_graph=True to keep it")
        raise
    if not retain_graph:
        for h, _ in live:
            if h._data.grad_fn is not None:
                h._data = h._data.detach()
    return grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every reached variable's buffer
    (reference: ``Imperative::Backward``, imperative.cc:358)."""
    variables = [v for v in list(_VARIABLES)
                 if v._grad_req != "null" and v._data.requires_grad]
    wrt = [v._data for v in variables]
    # a head that is itself a variable: its gradient is its seed
    grads = _grads(heads, head_grads, wrt, retain_graph) if wrt else None
    if grads is None:
        raise MXNetError("cannot differentiate: no variable has an "
                         "attached gradient")
    with torch.no_grad():
        for var, g in zip(variables, grads):
            if g is None:
                continue
            dst = var._grad._data
            if var._grad_req == "add":
                dst.add_(g.to(dst.dtype))
            else:
                dst.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False):
    """Gradients of ``heads`` for ``variables`` as new arrays, the
    variables' buffers untouched (reference: autograd.py:270)."""
    from .ndarray.ndarray import NDArray
    if create_graph:
        raise MXNetError("create_graph=True (higher-order autograd) is not "
                         "yet supported")
    if retain_graph is None:
        retain_graph = create_graph
    wrt = []
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("autograd.grad: a variable has no attached "
                             "gradient (call attach_grad before record)")
        wrt.append(v._data)
    grads = _grads(heads, head_grads, wrt, retain_graph)
    return [NDArray(torch.zeros_like(v._data) if g is None else g)
            for v, g in zip(variables, grads)]
