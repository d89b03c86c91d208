"""Symbol — the declarative graph API of the port.

Counterpart of ``mxnet_tpu/symbol/symbol.py``: a Symbol is a DAG of op
nodes (``Node``), built by the ``mx.sym.<Op>`` functions, with the
reference's naming, argument order and JSON format, so graphs, ``.params``
files and ``init_from`` dicts key identically in both packages. Where the
JAX package traces the graph into one jitted program, the port's
``Executor`` interprets it eagerly under ``torch.autograd``.

Ported: ``Variable``/``var``, ``Group``, ``list_arguments`` /
``list_auxiliary_states`` / ``list_outputs``, ``infer_shape`` (output
shapes by running each op on ``meta`` tensors), ``attr_dict``, ``+``
(``elemwise_add`` / ``_plus_scalar``), ``tojson``/``load``/``load_json``
and ``simple_bind``. The rest of the reference's Symbol surface
(composition by call, indexing, ``get_internals``, ``infer_type``,
``bind``, the other operators) raises "not yet ported" (ROADMAP A4).
"""
from __future__ import annotations

import json

import numpy as _np

from ..base import MXNetError
from ..ops import find_op, get_op
from ..ops.shape_infer import BACKFILL_SHAPE_HOOKS, PARAM_SHAPE_HOOKS

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "fromjson"]


class _NameManager:
    """Adapter onto the port's ``name`` manager stack: ``with
    mx.name.NameManager():`` scopes affect symbol auto-naming."""

    def get(self, hint):
        from ..name import current
        return current().get(None, hint.lower())


_NAMES = _NameManager()


class Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "attrs", "inputs", "name", "_extra_attrs")

    def __init__(self, op, attrs, inputs, name):
        self.op = op                      # OpDef or None for variables
        self.attrs = dict(attrs)          # op params (string-coercible)
        self.inputs = list(inputs)        # list of (Node, out_index)
        self.name = name
        self._extra_attrs = {}            # user attrs: __lr_mult__, ...

    @property
    def is_variable(self):
        return self.op is None

    def make_params(self):
        return self.op.make_params(dict(self.attrs))


class Symbol:
    """A set of output endpoints of a graph."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)     # list of (Node, out_index)

    # -- graph traversal ---------------------------------------------------
    def _topo(self):
        order, seen = [], set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for (inp, _) in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._outputs:
            visit(node)
        return order

    def _variables(self):
        return [n for n in self._topo() if n.is_variable]

    def _needs_rng(self):
        """True if any op in the graph draws randomness."""
        return any(n.op.need_rng for n in self._topo() if not n.is_variable)

    def _aux_set(self):
        """ids of the variable nodes that are op aux states (BatchNorm's
        moving_mean / moving_var)."""
        aux = set()
        for node in self._topo():
            if node.is_variable:
                continue
            n_in = len(node.op.list_inputs(node.make_params()))
            for (inp, _) in node.inputs[n_in:]:
                if inp.is_variable:
                    aux.add(id(inp))
        return aux

    # -- introspection -----------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def list_arguments(self):
        aux = self._aux_set()
        return [n.name for n in self._variables() if id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_set()
        return [n.name for n in self._variables() if id(n) in aux]

    def list_outputs(self):
        names = []
        for node, oidx in self._outputs:
            if node.is_variable:
                names.append(node.name)
                continue
            outs = node.op.list_outputs(node.make_params())
            names.append("%s_%s" % (node.name, outs[oidx]))
        return names

    # -- attributes --------------------------------------------------------
    def _set_attr(self, **kwargs):
        for node, _ in self._outputs:
            node._extra_attrs.update({k: str(v) for k, v in kwargs.items()})

    def attr_dict(self):
        out = {}
        for node in self._topo():
            d = dict(node.attrs if node.op is not None else {})
            d.update(node._extra_attrs)
            if d:
                out[node.name] = {k: str(v) for k, v in d.items()}
        return out

    # -- composition operators ---------------------------------------------
    def _apply_op(self, opname, other=None, **attrs):
        from . import _invoke_symbol
        if other is None:
            return _invoke_symbol(get_op(opname), [self], attrs)
        if isinstance(other, Symbol):
            return _invoke_symbol(get_op(opname), [self, other], attrs)
        raise TypeError("unsupported operand type %s" % type(other))

    def __add__(self, other):
        if isinstance(other, Symbol):
            return self._apply_op("elemwise_add", other)
        return self._apply_op("_plus_scalar", scalar=float(other))

    def __radd__(self, other):
        return self.__add__(other)

    def __repr__(self):
        name = self.name
        if name is None:
            return "<Symbol group [%s]>" % ", ".join(
                n.name for n, _ in self._outputs)
        return "<Symbol %s>" % name

    # -- shape inference ---------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(argument shapes, output shapes, aux-state shapes) from the
        given argument shapes, in ``list_arguments`` order or by name."""
        known = {}
        if args:
            for name, shape in zip(self.list_arguments(), args):
                if shape is not None:
                    known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})

        def unknown(s):
            return s is not None and 0 in s

        shapes = {}     # (id(node), oidx) -> shape
        var_shape = {}  # id(node) -> shape
        for node in self._topo():
            if node.is_variable:
                if node.name in known:
                    var_shape[id(node)] = known[node.name]
                elif "__shape__" in node._extra_attrs:
                    var_shape[id(node)] = tuple(int(x) for x in json.loads(
                        node._extra_attrs["__shape__"].replace("(", "[")
                        .replace(")", "]")))
                continue
            params = node.make_params()
            in_names = node.op.list_inputs(params) + node.op.list_aux(params)
            in_shapes = {}
            for nm, (inp, oidx) in zip(in_names, node.inputs):
                in_shapes[nm] = (var_shape.get(id(inp)) if inp.is_variable
                                 else shapes.get((id(inp), oidx)))
            # fill unknown weight shapes, then backfill 0-dims of data from
            # known weights (FInferShape runs both directions)
            for hooks, want in ((PARAM_SHAPE_HOOKS, lambda v: v is None),
                                (BACKFILL_SHAPE_HOOKS, unknown)):
                fn = hooks.get(node.op.name)
                if fn is None or not any(want(v) for v in in_shapes.values()):
                    continue
                try:
                    filled = fn(params, in_shapes)
                except (KeyError, TypeError):
                    filled = {}
                for nm, (inp, _) in zip(in_names, node.inputs):
                    if want(in_shapes[nm]) and nm in filled \
                            and not unknown(filled[nm]):
                        in_shapes[nm] = filled[nm]
                        if inp.is_variable:
                            var_shape[id(inp)] = filled[nm]
            if any(v is None or unknown(v) for v in in_shapes.values()):
                missing = [nm for nm, v in in_shapes.items()
                           if v is None or unknown(v)]
                raise MXNetError("infer_shape: cannot infer %s for node %s"
                                 % (missing, node.name))
            try:
                out = node.op.infer(params, [in_shapes[nm]
                                             for nm in in_names])
            except Exception as e:  # shape error inside the op
                raise MXNetError("infer_shape failed at node %s(%s): %s"
                                 % (node.op.name, node.name, e))
            for i, o in enumerate(out):
                shapes[(id(node), i)] = o

        aux_set = self._aux_set()
        arg_shapes = [var_shape.get(id(n)) for n in self._variables()
                      if id(n) not in aux_set]
        aux_shapes = [var_shape.get(id(n)) for n in self._variables()
                      if id(n) in aux_set]
        out_shapes = [var_shape.get(id(node)) if node.is_variable
                      else shapes.get((id(node), oidx))
                      for node, oidx in self._outputs]
        return arg_shapes, out_shapes, aux_shapes

    # -- serialization (the reference's symbol JSON) -----------------------
    def tojson(self):
        topo = self._topo()
        nid = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for n in topo:
            entry = {"op": "null" if n.is_variable else n.op.name,
                     "name": n.name,
                     "inputs": [[nid[id(i)], oi, 0] for (i, oi) in n.inputs]}
            attrs = {}
            if n.op is not None:
                attrs.update(n.op.make_params(dict(n.attrs)).as_str_dict())
            attrs.update(n._extra_attrs)
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        arg_nodes = [i for i, n in enumerate(topo) if n.is_variable]
        heads = [[nid[id(n)], oi, 0] for (n, oi) in self._outputs]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(topo) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10201]}},
                          indent=2)

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Infer shapes, allocate zeros, bind. ``ctx`` None is the card
        (raising without CUDA); ``mx.cpu()`` binds on the CPU. Argument
        dtypes come from ``type_dict`` (float32 otherwise); the dtype
        inference pass of the reference is not yet ported."""
        from ..context import resolve_device
        from ..executor import Executor
        from ..ndarray.ndarray import zeros
        ctx = resolve_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        if any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError("simple_bind: could not infer shapes for %s"
                             % missing)
        types = type_dict or {}
        args = {n: zeros(s, ctx=ctx, dtype=types.get(n))
                for n, s in zip(arg_names, arg_shapes)}
        req = grad_req if isinstance(grad_req, dict) else {
            n: grad_req for n in arg_names}
        args_grad = {n: zeros(s, ctx=ctx, dtype=types.get(n))
                     for n, s in zip(arg_names, arg_shapes)
                     if req.get(n, "null") != "null"}
        aux_states = {n: zeros(s, ctx=ctx) for n, s in
                      zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)


def _not_ported(name):
    def method(self, *args, **kwargs):
        raise MXNetError("Symbol.%s is not yet ported (ROADMAP A4)" % name)
    method.__name__ = name
    return method


for _name in ("__call__", "__getitem__", "get_internals", "get_children",
              "infer_shape_partial", "infer_type", "__sub__", "__rsub__",
              "__mul__", "__rmul__", "__truediv__", "__rtruediv__",
              "__pow__", "__neg__", "reshape", "transpose", "flatten",
              "astype", "sum", "mean", "slice_axis", "expand_dims",
              "softmax", "attr", "list_inputs", "save", "bind", "eval",
              "grad"):
    setattr(Symbol, _name, _not_ported(_name))


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """A free variable of the graph (reference: symbol.py var())."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    node = Node(None, {}, [], name)
    if shape is not None:
        node._extra_attrs["__shape__"] = str(list(shape))
    if lr_mult is not None:
        node._extra_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        node._extra_attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        node._extra_attrs["__dtype__"] = str(_np.dtype(dtype))
    if init is not None:
        node._extra_attrs["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    if stype is not None:
        node._extra_attrs["__storage_type__"] = stype
    if attr:
        node._extra_attrs.update({k: str(v) for k, v in attr.items()})
    node._extra_attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    data = json.loads(json_str)
    built = []
    for meta in data["nodes"]:
        attrs = meta.get("attrs", meta.get("param", {})) or {}
        if meta["op"] == "null":
            node = Node(None, {}, [], meta["name"])
            node._extra_attrs = {k: str(v) for k, v in attrs.items()}
        else:
            opdef = find_op(meta["op"])
            if opdef is None:
                raise MXNetError("load_json: op %r is not yet ported "
                                 "(ROADMAP A3)" % meta["op"])
            extra = {k: v for k, v in attrs.items() if k.startswith("__")}
            # drop unknown legacy params silently (forward compat)
            valid = set(opdef.param_cls._fields)
            params = {k: v for k, v in attrs.items()
                      if not k.startswith("__") and k in valid}
            inputs = [(built[i], oi) for i, oi, *_ in meta["inputs"]]
            node = Node(opdef, params, inputs, meta["name"])
            node._extra_attrs = extra
        built.append(node)
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    return Symbol([(built[i], oi) for i, oi, *_ in heads])


fromjson = load_json
