"""Symbol — the declarative graph API of the port.

Counterpart of ``mxnet_tpu/symbol/symbol.py``: a Symbol is a DAG of op
nodes (``Node``), built by the ``mx.sym.<Op>`` functions, with the
reference's naming, argument order and JSON format, so graphs, ``.params``
files and ``init_from`` dicts key identically in both packages. Where the
JAX package traces the graph into one jitted program, the port's
``Executor`` interprets it eagerly under ``torch.autograd``.

Ported: ``Variable``/``var``, ``Group``, ``list_arguments`` /
``list_auxiliary_states`` / ``list_outputs`` / ``list_inputs``,
``infer_shape`` (output shapes by running each op on ``meta`` tensors),
``infer_type`` (the reference's dtype unification), ``attr_dict``, ``+``
(``elemwise_add`` / ``_plus_scalar``), composition by call,
``get_internals`` and indexing by position, slice or output name,
``tojson``/``save``/``load``/``load_json``, ``simple_bind``, ``bind`` and
``eval``, and the reference's operators: ``+ - * / ** %`` with symbols
(``elemwise_*``, ``power``, ``mod``) and scalars (``_plus_scalar``, ...,
the reversed ``_rminus_scalar``, ``_rdiv_scalar``, ``_rpower_scalar``,
``_rmod_scalar``), unary minus, the comparisons (``equal``, ...,
``_lesser_equal_scalar``), and the shape and math mirrors (``reshape``,
``transpose``, ``flatten``, ``astype``, ``sum``, ``mean``,
``slice_axis``, ``expand_dims``, ``softmax``), ``get_children``,
``attr`` and ``infer_shape_partial``. Symbols made inside an
``mx.AttrScope`` carry its attributes. ``grad`` raises the reference's
message.
"""
from __future__ import annotations

import json

import numpy as _np

from ..base import MXNetError
from ..ops import get_op
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

    def list_inputs(self):
        return [n.name for n in self._variables()]

    def list_outputs(self):
        names = []
        for node, oidx in self._outputs:
            if node.is_variable:
                names.append(node.name)
                continue
            outs = node.op.list_outputs(node.make_params())
            names.append("%s_%s" % (node.name, outs[oidx]))
        return names

    # -- composition (reference: symbol.py __call__ L140) -------------------
    def __call__(self, *args, **kwargs):
        """A new graph with free variables replaced by the given
        single-output symbols (positional in ``list_inputs`` order, or by
        name); nodes that do not depend on them are shared."""
        name = kwargs.pop("name", None)
        if args and kwargs:
            raise TypeError("compose accepts input Symbols either as "
                            "positional or keyword arguments, not both")
        subs = {}
        if args:
            free = self._variables()
            if len(args) > len(free):
                raise MXNetError("compose: %d positional inputs for %d free "
                                 "variables" % (len(args), len(free)))
            for node, val in zip(free, args):
                subs[node.name] = val
        subs.update(kwargs)
        for key, val in subs.items():
            if not isinstance(val, Symbol):
                raise TypeError("compose: input %r must be a Symbol" % key)
            if len(val._outputs) != 1:
                raise MXNetError("compose: input %r must be single-output"
                                 % key)
        unknown = set(subs) - {n.name for n in self._variables()}
        if unknown:
            raise MXNetError("compose: %s are not free variables of this "
                             "symbol" % sorted(unknown))
        mapping = {}  # id(old node) -> (new node, out index)
        for node in self._topo():
            if node.is_variable:
                mapping[id(node)] = (subs[node.name]._outputs[0]
                                     if node.name in subs else (node, 0))
                continue
            new_inputs = []
            for (inp, oidx) in node.inputs:
                m = mapping[id(inp)]
                if m[0] is inp:
                    new_inputs.append((inp, oidx))
                elif inp.is_variable:     # substituted endpoint
                    new_inputs.append(m)
                else:                     # cloned op node, same out slot
                    new_inputs.append((m[0], oidx))
            clone = Node(node.op, node.attrs, new_inputs, node.name)
            clone._extra_attrs = dict(node._extra_attrs)
            mapping[id(node)] = (clone, 0)
        outputs = [mapping[id(node)] if node.is_variable
                   else (mapping[id(node)][0], oidx)
                   for node, oidx in self._outputs]
        if name is not None and len(outputs) == 1 and \
                not outputs[0][0].is_variable:
            outputs[0][0].name = name
        return Symbol(outputs)

    def get_internals(self):
        outs = []
        for node in self._topo():
            if node.is_variable:
                outs.append((node, 0))
            else:
                n = node.op.n_outputs(node.make_params())
                outs.extend((node, i) for i in range(n))
        return Symbol(outs)

    def get_children(self):
        """The inputs of the output nodes as one Symbol, or None for a
        variable (reference L212)."""
        children = []
        for node, _ in self._outputs:
            children.extend(node.inputs)
        return Symbol(children) if children else None

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index in names:
                return Symbol([self._outputs[names.index(index)]])
            for i, (node, _) in enumerate(self._outputs):   # bare node name
                if node.name == index:
                    return Symbol([self._outputs[i]])
            raise MXNetError("Cannot find output %r; outputs are %s"
                             % (index, names))
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        """The user attribute ``key`` of a single-output symbol (scope
        attributes included), else None (reference L241)."""
        if len(self._outputs) == 1:
            return self._outputs[0][0]._extra_attrs.get(key)
        return None

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

    # -- composition operators (reference symbol.py L263-399) -------------
    def _apply_op(self, opname, other=None, **attrs):
        from . import _invoke_symbol
        if other is None:
            return _invoke_symbol(get_op(opname), [self], attrs)
        if isinstance(other, Symbol):
            return _invoke_symbol(get_op(opname), [self, other], attrs)
        raise TypeError("unsupported operand type %s" % type(other))

    def _arith(self, other, op, scalar_op):
        if isinstance(other, Symbol):
            return self._apply_op(op, other)
        return self._apply_op(scalar_op, scalar=float(other))

    def __add__(self, other):
        return self._arith(other, "elemwise_add", "_plus_scalar")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._arith(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._apply_op("_rminus_scalar", scalar=float(other))

    def __mul__(self, other):
        return self._arith(other, "elemwise_mul", "_mul_scalar")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return self._arith(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._apply_op("_rdiv_scalar", scalar=float(other))

    __div__, __rdiv__ = __truediv__, __rtruediv__

    def __pow__(self, other):
        return self._arith(other, "power", "_power_scalar")

    def __neg__(self):
        return self._apply_op("_mul_scalar", scalar=-1.0)

    def __eq__(self, other):
        return self._arith(other, "equal", "_equal_scalar")

    def __ne__(self, other):
        return self._arith(other, "not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._arith(other, "greater", "_greater_scalar")

    def __ge__(self, other):
        return self._arith(other, "greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._arith(other, "lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._arith(other, "lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def reshape(self, shape=None, **kwargs):
        from . import _invoke_symbol
        if shape is None:
            shape = kwargs.pop("shape", None)
        return _invoke_symbol(get_op("Reshape"), [self], {
            "shape": tuple(shape),
            "reverse": bool(kwargs.pop("reverse", False))})

    def transpose(self, axes=()):
        return self._apply_op("transpose", axes=tuple(axes))

    def flatten(self):
        return self._apply_op("Flatten")

    def sum(self, axis=None, keepdims=False):
        return self._apply_op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._apply_op("mean", axis=axis, keepdims=keepdims)

    def astype(self, dtype):
        return self._apply_op("Cast", dtype=str(_np.dtype(dtype)))

    def slice_axis(self, axis, begin, end):
        return self._apply_op("slice_axis", axis=axis, begin=begin, end=end)

    def expand_dims(self, axis):
        return self._apply_op("expand_dims", axis=axis)

    def softmax(self, axis=-1):
        return self._apply_op("softmax", axis=axis)

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
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """``infer_shape`` that leaves None where a shape cannot be
        inferred, instead of raising (reference L410)."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
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
                if partial:
                    continue
                missing = [nm for nm, v in in_shapes.items()
                           if v is None or unknown(v)]
                raise MXNetError("infer_shape: cannot infer %s for node %s"
                                 % (missing, node.name))
            try:
                # shapes need no training semantics (and torch's train-mode
                # BatchNorm refuses one value per channel, a batch of 1)
                out = node.op.infer(params, [in_shapes[nm]
                                             for nm in in_names],
                                    is_train=False)
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

    # ops whose listed input positions do not share the unified dtype
    # (reference symbol.py L527-539); BatchNorm keeps gamma, beta and the
    # moving statistics in float32
    _TYPE_EXCLUDED_INPUTS = {
        "Embedding": (0,), "SparseEmbedding": (0,), "take": (1,),
        "batch_take": (1,), "gather_nd": (1,), "pick": (1,),
        "one_hot": (0,), "scatter_nd": (1,), "_scatter_set_nd": (2,),
        "sparse_retain": (1,), "SequenceMask": (1,), "SequenceLast": (1,),
        "SequenceReverse": (1,), "BatchNorm": (1, 2, 3, 4),
        "CuDNNBatchNorm": (1, 2, 3, 4)}

    def infer_type(self, *args, **kwargs):
        """(argument, output, aux-state) dtypes by the reference's
        bidirectional unification (``mxnet_tpu/symbol/symbol.py:505``):
        each op unifies its tensor inputs and outputs to one dtype, ``Cast``
        breaks the chain, unknowns default to float32."""
        arg_names = self.list_arguments()
        if args:
            kwargs = dict(kwargs)
            kwargs.update({n: d for n, d in zip(arg_names, args)
                           if d is not None})
        topo = self._topo()
        dtype_of = {}
        for n in topo:
            if not n.is_variable:
                continue
            if kwargs.get(n.name) is not None:
                dtype_of[(id(n), 0)] = _np.dtype(kwargs[n.name])
            elif "__dtype__" in n._extra_attrs:
                dtype_of[(id(n), 0)] = _np.dtype(n._extra_attrs["__dtype__"])
        for _ in range(8):  # fixpoint over forward+backward constraints
            changed = False
            for node in topo:
                if node.is_variable:
                    continue
                params = node.make_params()
                n_vis = node.op.n_outputs(params)
                excl = self._TYPE_EXCLUDED_INPUTS.get(node.op.name, ())
                in_keys = [(id(i), oi)
                           for pos, (i, oi) in enumerate(node.inputs)
                           if pos not in excl]
                out_keys = [(id(node), i) for i in range(n_vis)]
                if node.op.name == "Cast":
                    out_dt = _np.dtype(getattr(params, "dtype", "float32"))
                    for k in out_keys:
                        if k not in dtype_of or dtype_of[k] != out_dt:
                            dtype_of[k] = out_dt
                            changed = True
                    keys = in_keys  # input side unifies independently
                else:
                    keys = in_keys + out_keys
                known = [dtype_of[k] for k in keys if k in dtype_of]
                if not known:
                    continue
                for k in keys:
                    if k not in dtype_of:
                        dtype_of[k] = known[0]
                        changed = True
            if not changed:
                break
        default = _np.dtype(_np.float32)
        name2var = {n.name: n for n in topo if n.is_variable}
        arg_types = [dtype_of.get((id(name2var[n]), 0), default)
                     for n in arg_names]
        aux_types = [dtype_of.get((id(name2var[n]), 0), default)
                     for n in self.list_auxiliary_states()]
        out_types = [dtype_of.get((id(node), oidx), default)
                     for node, oidx in self._outputs]
        return arg_types, out_types, aux_types

    # -- serialization (the reference's symbol JSON) -----------------------
    def save(self, fname):
        from ..base import atomic_write
        atomic_write(fname, self.tojson(), mode="w")

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

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over the given arrays (lists in ``list_arguments``
        order, or dicts); ``ctx`` None is the card."""
        from ..context import resolve_device
        from ..executor import Executor
        return Executor(self, resolve_device(ctx), args, args_grad,
                        grad_req, aux_states)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` (name -> NDArray) and run one inference
        forward; returns the outputs."""
        return self.bind(ctx, kwargs, grad_req="null").forward()

    def grad(self, wrt):
        raise MXNetError("Symbol.grad is deprecated in the reference; use "
                         "bind + backward")


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """A free variable of the graph (reference: symbol.py var())."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    node = Node(None, {}, [], name)
    from ..attribute import current_attrs
    node._extra_attrs.update(current_attrs())
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
            opdef = get_op(meta["op"])
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
