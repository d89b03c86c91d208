"""Executor — binds a Symbol to a device and arrays and runs it.

Counterpart of ``mxnet_tpu/executor.py`` (``Executor`` L26). Where the JAX
package traces the graph into one jitted program per mode, the port
interprets it eagerly: ``run_graph`` (the JAX package's ``_run_graph``,
L187-240) walks the op nodes in topological order and returns the outputs
and the BatchNorm aux updates. It is the one graph interpreter that the
executor and ``parallel.DataParallelTrainStep`` share.

``forward(is_train=True)`` on an executor with gradients records the graph
under ``torch.autograd``; ``backward(out_grads)`` seeds it with
``out_grads`` (ones when none are given, as the JAX package's fused
forward+backward does) and writes ``grad_dict`` in place, or adds to it
for ``grad_req="add"``. The aux states are updated in place. ``outputs``
are built at bind, zeros of the inferred output shapes, and each forward
writes into them, as MXNet's executors write their bind-allocated
outputs: an output held across forwards reads the latest one.
``arg_arrays``/``grad_arrays``/``aux_arrays``, ``output_dict``,
``copy_params_from`` and ``reshape`` are the reference's (L563-631):
``reshape`` binds a new executor that shares every array whose shape
stays.

``warmup()`` (reference L323) captures the inference forward at the
bound shapes as a CUDA graph (``compile.builder.ProgramBuilder`` with
``capture=True``, site ``executor.forward``), which reads the bound
arrays where they lie; from then on ``forward(is_train=False)`` replays
it. On the CPU it registers the signature and the forward stays eager.
``program_cost()`` (L376) counts the fused forward and backward: flops
from ``torch.utils.flop_counter`` on ``meta`` tensors, bytes from the
allocator on the card. ``set_monitor_callback`` / ``monitor_activate`` /
``monitor_flush`` (L472-520) hand each interior node's output of a
forward to a callback (``monitor.Monitor``), collected by ``run_graph``
in the same pass.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .compile.builder import CapturedProgram, ProgramBuilder
from .context import resolve_device
from .ndarray.ndarray import NDArray, zeros

__all__ = ["Executor", "GraphPlan", "run_graph"]


class GraphPlan:
    """A symbol's graph prepared for ``run_graph``: the variables, the op
    nodes in topological order with their params parsed once, and after
    each node the op outputs no later node reads (``release``)."""

    def __init__(self, symbol):
        self.symbol = symbol
        topo = symbol._topo()
        aux_ids = symbol._aux_set()
        self.variables = [(id(n), n.name, id(n) in aux_ids)
                          for n in topo if n.is_variable]
        self.nodes = []
        for node in topo:
            if node.is_variable:
                continue
            params = node.make_params()
            n_in = len(node.op.list_inputs(params))
            n_aux = len(node.op.list_aux(params))
            self.nodes.append((
                node, params, [(id(i), oi) for i, oi in node.inputs],
                node.op.n_outputs(params),
                [node.inputs[n_in + j][0].name for j in range(n_aux)]))
        self.outputs = [(id(n), 0 if n.is_variable else oi)
                        for n, oi in symbol._outputs]
        last = {}
        for i, (node, _, in_keys, n_vis, _) in enumerate(self.nodes):
            for k in in_keys:
                last[k] = i
            for j in range(n_vis):
                last.setdefault((id(node), j), i)
        keep = set(self.outputs)
        ops = {(id(node), j) for node, _, _, n_vis, _ in self.nodes
               for j in range(n_vis)}
        self.release = [[] for _ in self.nodes]
        for k, i in last.items():
            if k in ops and k not in keep:
                self.release[i].append(k)


def run_graph(plan, arg_vals, aux_vals, is_train, collect_interior=False):
    """Interpret ``plan`` on tensors: ``arg_vals`` / ``aux_vals`` map
    variable names to tensors. Returns (outputs tuple, {aux name: updated
    value}); with ``collect_interior`` also the list of (name, value) of
    every op node's outputs in topological order, named
    ``<node>_output`` (one output) or ``<node>_output<i>`` (the
    reference's ``_run_graph``, L187-240). Without it, an op output is
    dropped after the last node that reads it, so memory holds the live
    set, not every activation (autograd keeps what its backward needs)."""
    vals = {}
    for nid, name, is_aux in plan.variables:
        src = aux_vals if is_aux else arg_vals
        if name in src:
            vals[(nid, 0)] = src[name]
    aux_updates = {}
    release = () if collect_interior else plan.release
    for idx, (node, params, in_keys, n_vis, aux_names) in \
            enumerate(plan.nodes):
        try:
            ins = [vals[k] for k in in_keys]
        except KeyError:
            raise MXNetError("executor: missing input for node %s"
                             % node.name) from None
        outs = node.op.apply(params, ins, is_train=is_train)
        for i in range(n_vis):
            vals[(id(node), i)] = outs[i]
        for name, upd in zip(aux_names, outs[n_vis:]):
            aux_updates[name] = upd
        del ins, outs
        if release:
            for k in release[idx]:
                del vals[k]
    outputs = tuple(vals[k] for k in plan.outputs)
    if collect_interior:
        interior = []
        for node, _, _, n_vis, _ in plan.nodes:
            for i in range(n_vis):
                suffix = "_output" if n_vis == 1 else "_output%d" % i
                interior.append((node.name + suffix, vals[(id(node), i)]))
        return outputs, aux_updates, interior
    return outputs, aux_updates


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


class Executor:
    """A symbol bound to arrays on one device (``ctx`` None: the card,
    raising without CUDA; ``mx.cpu()``: the CPU)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._device = resolve_device(ctx)
        self._symbol = symbol
        self._arg_names = arg_names = symbol.list_arguments()
        self._aux_names = aux_names = symbol.list_auxiliary_states()
        self.arg_dict = self._normalize(args, arg_names, "args")
        self.aux_dict = self._normalize(aux_states or {}, aux_names,
                                        "aux_states", allow_missing=True)
        for name in aux_names:
            if name not in self.aux_dict:
                raise MXNetError("missing aux state %r" % name)
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = dict(grad_req)
            for n in arg_names:
                self._grad_req.setdefault(n, "null")
        self.grad_dict = self._normalize(args_grad or {}, arg_names,
                                         "args_grad", allow_missing=True)
        self._grad_names = [n for n in arg_names
                            if self._grad_req.get(n, "null") != "null"]
        for n in self._grad_names:
            if n not in self.grad_dict:
                self.grad_dict[n] = zeros(self.arg_dict[n].shape,
                                          ctx=self._device)
        self._plan = GraphPlan(symbol)
        self._pending = None    # (outputs, grad leaves) of a train forward
        self._fwd_builder = None
        self._fwd_prog = None    # the warmed inference forward's program
        self._modes_run = set()  # is_train values a forward ran with
        self._monitor_cb = None
        self._monitor_active = False
        self._pending_monitor = []
        try:
            _, out_shapes, _ = symbol.infer_shape(
                **{n: a.shape for n, a in self.arg_dict.items()})
            self.outputs = [zeros(s, ctx=self._device) for s in out_shapes]
        except MXNetError:      # shapes known only once a forward runs
            self.outputs = []

    def _normalize(self, arrays, names, what, allow_missing=False):
        if isinstance(arrays, dict):
            out = dict(arrays)
        elif isinstance(arrays, (list, tuple)):
            if len(arrays) != len(names):
                raise MXNetError("%s length %d != expected %d (%s)"
                                 % (what, len(arrays), len(names), names))
            out = dict(zip(names, arrays))
        else:
            raise MXNetError("%s must be list or dict" % what)
        if not allow_missing:
            for n in names:
                if n not in out:
                    raise MXNetError("missing %s entry %r" % (what, n))
        return {n: a if isinstance(a, NDArray) else NDArray(a,
                                                            ctx=self._device)
                for n, a in out.items()}

    def _values(self):
        return ({n: a._data for n, a in self.arg_dict.items()},
                {n: a._data for n, a in self.aux_dict.items()})

    def _run(self, is_train, record, collect=False):
        """One pass of the graph; with ``record``, under autograd with the
        gradient arguments as fresh leaves -> (outputs, aux updates,
        leaves); with ``collect`` the interior outputs go to the monitor's
        pending list."""
        arg_vals, aux_vals = self._values()
        leaves = {}
        if record:
            leaves = {n: arg_vals[n].detach().requires_grad_(True)
                      for n in self._grad_names}
            arg_vals.update(leaves)
        with torch.set_grad_enabled(record):
            res = run_graph(self._plan, arg_vals, aux_vals, is_train,
                            collect_interior=collect)
        if collect:
            outs, aux_upd, interior = res
            self._pending_monitor.extend(
                (name, NDArray(v.detach())) for name, v in interior)
        else:
            outs, aux_upd = res
        return outs, aux_upd, leaves

    def _forward_body(self):
        plan = self._plan

        def fwd(arg_vals, aux_vals):
            return run_graph(plan, arg_vals, aux_vals, False)[0]
        return fwd

    def warmup(self, is_train=False):
        """Build the inference forward's program at the bound shapes
        ahead of time: on the card, capture it as a CUDA graph that reads
        the bound arrays in place, so every later ``forward(
        is_train=False)`` replays it (bit for bit the eager forward); on
        the CPU register its signature (the forward stays eager). A train
        forward, whose aux updates and autograd record run eagerly, has no
        program to build. Returns self."""
        if is_train:
            return self
        if self._fwd_builder is None:
            self._fwd_builder = ProgramBuilder(
                self._forward_body(), site="executor.forward", capture=True,
                static_argnums=(0, 1))
        self._fwd_prog = self._fwd_builder.aot_info(*self._values(),
                                                    mode="aot")[0]
        return self

    def has_compiled_forward(self, is_train=False):
        """Whether a forward of this mode already ran or was built ahead
        of time (the Module's serving router reads it)."""
        return bool(is_train) in self._modes_run or (
            not is_train and self._fwd_prog is not None)

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            self.arg_dict[k][:] = v
        record = bool(is_train and self._grad_names)
        collect = self._monitor_cb is not None and self._monitor_active
        # the warmed program was built at the bound shapes, which an
        # executor keeps (a call copies in any array rebound since, and
        # raises on another shape)
        prog = None if (is_train or collect) else self._fwd_prog
        if isinstance(prog, CapturedProgram):
            outs, aux_upd, leaves = prog(*self._values()), {}, {}
        else:
            outs, aux_upd, leaves = self._run(is_train, record, collect)
        if not (is_train and self._grad_names):
            self._modes_run.add(bool(is_train))
        self._pending = (outs, leaves) if record else None
        with torch.no_grad():
            for name, val in aux_upd.items():
                dst = self.aux_dict[name]._data
                if val is not dst:
                    dst.copy_(val)
        if len(self.outputs) != len(outs):
            self.outputs = [NDArray(torch.empty_like(o)) for o in outs]
        with torch.no_grad():
            for held, o in zip(self.outputs, outs):
                if held._data.shape != o.shape or held._data.dtype != o.dtype:
                    held._data = torch.empty_like(o)
                held._data.copy_(o)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        if not self._grad_names:
            return
        if self._pending is None:
            if out_grads is None:
                raise MXNetError("backward() called before "
                                 "forward(is_train=True)")
            # as the JAX package does: a fresh train-mode pass, whose aux
            # updates are not applied
            outs, _, leaves = self._run(is_train, True)
        else:
            outs, leaves = self._pending
        if out_grads is None:
            seeds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            seeds = [(g._data if isinstance(g, NDArray)
                      else torch.as_tensor(g)).to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
        wrt = [leaves[n] for n in self._grad_names]
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs], wrt,
                                        [s for _, s in pairs],
                                        allow_unused=True,
                                        materialize_grads=True)
        else:
            grads = [torch.zeros_like(w) for w in wrt]
        with torch.no_grad():
            for name, g in zip(self._grad_names, grads):
                dst = self.grad_dict[name]._data
                if self._grad_req.get(name) == "add":
                    dst.add_(g)
                else:
                    dst.copy_(g)
        self._pending = None

    # convenience accessors (reference: executor.py L563-596)
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy (and cast) the given arrays into the bound ones, in place;
        a name the executor lacks raises unless ``allow_extra_params``."""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                array.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in executor arguments"
                                 % name)
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                array.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in executor aux states"
                                 % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound at the given input shapes: arrays whose
        shape stays are shared with this one, the others are new zeros,
        and every gradient array is new."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = {}
        for name, shape in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict[name]
            new_args[name] = cur if tuple(shape) == cur.shape else zeros(
                shape, ctx=self._device, dtype=cur.dtype)
        new_aux = {}
        for name, shape in zip(self._aux_names, aux_shapes):
            cur = self.aux_dict[name]
            new_aux[name] = cur if tuple(shape) == cur.shape else zeros(
                shape, ctx=self._device)
        grads = {n: zeros(a.shape, ctx=self._device)
                 for n, a in new_args.items()
                 if self._grad_req.get(n, "null") != "null"}
        return Executor(self._symbol, self._device, new_args, grads,
                        self._grad_req, new_aux)

    # ------------------------------------------------------------------
    # monitor hooks (reference L472-520)
    # ------------------------------------------------------------------
    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` with each interior node's
        output of every forward while active (``monitor_flush``)."""
        self._monitor_cb = callback
        self._monitor_active = True
        self._pending_monitor = []

    def monitor_activate(self, active):
        """Gate the interior capture (``Monitor.tic``/``toc`` toggle it,
        so batches off the interval pay nothing)."""
        self._monitor_active = bool(active)
        if not active:
            self._pending_monitor = []

    def monitor_flush(self):
        """Hand the collected interior outputs to the callback."""
        cb = self._monitor_cb
        pending, self._pending_monitor = self._pending_monitor, []
        if cb is None:
            return
        for name, arr in pending:
            cb(name, arr)

    # ------------------------------------------------------------------
    # cost (reference L376)
    # ------------------------------------------------------------------
    def program_cost(self):
        """Accounting of the fused forward and backward (the train-mode
        forward when nothing takes a gradient) at the bound shapes:
        ``{"flops", "peak_bytes", "temp_bytes"}``.

        - ``flops``: the products of the graph and its backward as
          ``torch.utils.flop_counter.FlopCounterMode`` counts them, on
          ``meta`` tensors (no data, no device): 2 per multiply-add of
          every convolution and matmul, forward and backward. XLA's cost
          analysis, which the reference returns, also counts each
          elementwise operation (BatchNorm, activations, the loss), so it
          is a few percent higher on a convolution network.
        - On the card, ``temp_bytes`` is the allocator's peak over one
          real forward and backward less what was allocated before it
          (activations, gradients, workspaces), and ``peak_bytes`` adds
          the bound arguments and aux states. The step's gradients and
          aux updates are discarded: no state changes.
        - On the CPU the bytes are this executor's own accounting on the
          ``meta`` pass: ``temp_bytes`` sums every op output of the
          forward (all held for the backward) and the gradients;
          ``peak_bytes`` adds the arguments and aux states.

        XLA reports its buffer assignment's peak instead, which reuses
        dead buffers, so the reference's bytes are lower for the same
        graph; compare bytes only within one package."""
        from torch.utils.flop_counter import FlopCounterMode
        arg_vals, aux_vals = self._values()
        in_bytes = sum(t.numel() * t.element_size()
                       for d in (arg_vals, aux_vals) for t in d.values())
        margs = {n: _meta(t) for n, t in arg_vals.items()}
        maux = {n: _meta(t) for n, t in aux_vals.items()}
        with FlopCounterMode(display=False) as counter:
            interior, grads = self._fwd_bwd(margs, maux, collect=True)
        flops = float(counter.get_total_flops())
        if self._device.type == "cuda":
            dev = self._device
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            res = self._fwd_bwd(arg_vals, aux_vals)
            torch.cuda.synchronize(dev)
            temp = torch.cuda.max_memory_allocated(dev) - base
            del res
        else:
            temp = sum(v.numel() * v.element_size() for _, v in interior)
            temp += sum(g.numel() * g.element_size() for g in grads)
        return {"flops": flops, "peak_bytes": float(in_bytes + temp),
                "temp_bytes": float(temp)}

    def _fwd_bwd(self, arg_vals, aux_vals, collect=False):
        """A train-mode forward and, with gradients, the backward of its
        outputs seeded with ones: (interior outputs, gradients)."""
        arg_vals = dict(arg_vals)
        leaves = {n: arg_vals[n].detach().requires_grad_(True)
                  for n in self._grad_names}
        arg_vals.update(leaves)
        with torch.set_grad_enabled(bool(leaves)):
            res = run_graph(self._plan, arg_vals, aux_vals, True,
                            collect_interior=collect)
            outs = res[0]
            pairs = [o for o in outs if o.requires_grad]
            grads = []
            if leaves and pairs:
                grads = torch.autograd.grad(
                    pairs, list(leaves.values()),
                    [torch.ones_like(o) for o in pairs],
                    allow_unused=True, materialize_grads=True)
        return (res[2] if collect else []), list(grads)
