"""``mx.sym`` of the port: Symbol plus one function per registered op.

Counterpart of ``mxnet_tpu/symbol/__init__.py``: the ``mx.sym.<Op>``
functions are generated from the op registry. Missing weight and aux
inputs are auto-created as Variables named ``<node>_<input>``, exactly as
the reference composer names them, and unnamed nodes take the name
manager's ``<op>N``.
"""
from __future__ import annotations

import sys

from ..base import MXNetError
from ..ops import OPS
from ..ops.registry import _ALIASES as _OP_ALIASES
from .symbol import (Group, Node, Symbol, Variable, _NAMES, fromjson, load,
                     load_json, var)

_this = sys.modules[__name__]


def _invoke_symbol(opdef, sym_inputs, attrs, name=None):
    """Create a graph node applying opdef to symbol inputs."""
    attrs = {k: v for k, v in attrs.items() if v is not None}
    params = opdef.make_params(dict(attrs))
    in_names = opdef.list_inputs(params) + opdef.list_aux(params)
    if name is None:
        name = _NAMES.get(opdef.name.lower())
    inputs = []
    for i, nm in enumerate(in_names):
        if i < len(sym_inputs) and sym_inputs[i] is not None:
            s = sym_inputs[i]
            if len(s._outputs) != 1:
                raise MXNetError("op %s input %s must be a single-output "
                                 "symbol" % (opdef.name, nm))
            inputs.append(s._outputs[0])
        else:
            # auto-create the parameter/aux variable (reference composer)
            inputs.append((Node(None, {}, [], "%s_%s" % (name, nm)), 0))
    node = Node(opdef, attrs, inputs, name)
    return Symbol([(node, i) for i in range(opdef.n_outputs(params))])


def _make_sym_function(opdef):
    def sym_func(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        attrs, named_inputs = {}, {}
        for k, v in kwargs.items():
            (named_inputs if isinstance(v, Symbol) else attrs)[k] = v
        sym_args = [a for a in args if isinstance(a, Symbol)]
        pos_attrs = [a for a in args if not isinstance(a, Symbol)]
        if pos_attrs:
            fields = [f for f in opdef.param_cls._fields if f not in attrs]
            for a, f in zip(pos_attrs, fields):
                attrs[f] = a
        probe = opdef.make_params({k: v for k, v in attrs.items()
                                   if v is not None})
        in_names = opdef.list_inputs(probe) + opdef.list_aux(probe)
        inputs = [None] * len(in_names)
        for i, a in enumerate(sym_args[:len(inputs)]):
            inputs[i] = a
        for k, v in named_inputs.items():
            if k not in in_names:
                raise MXNetError("%s: unknown input %r (expects %s)"
                                 % (opdef.name, k, in_names))
            inputs[in_names.index(k)] = v
        out = _invoke_symbol(opdef, inputs, attrs, name=name)
        if attr:
            out._set_attr(**attr)
        return out

    sym_func.__name__ = opdef.name
    sym_func.__doc__ = opdef.doc
    return sym_func


_GENERATED = {}
for _name, _opdef in list(OPS.items()):
    _GENERATED[_name] = _make_sym_function(_opdef)
    setattr(_this, _name, _GENERATED[_name])
for _al, _target in _OP_ALIASES.items():
    if _target in _GENERATED:
        setattr(_this, _al, _GENERATED[_target])


def __getattr__(name):
    # mx.sym.<op> for an op of the reference the port has not registered
    raise AttributeError("mx.sym.%s: operator not yet ported (ROADMAP A3)"
                         % name)


__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "fromjson"] + list(_GENERATED)
