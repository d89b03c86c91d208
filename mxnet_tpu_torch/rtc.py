"""Runtime-compiled user kernels: ``mx.rtc`` of the port.

Counterpart of ``mxnet_tpu/rtc.py``, which recast MXNet 1.2's
``CudaModule`` (``python/mxnet/rtc.py`` over NVRTC, ``src/common/rtc.cc``)
as Pallas functions for the TPU. On the card it is MXNet's own API again:

- ``CudaModule(source, options, exports)`` compiles CUDA C with NVRTC for
  ``sm_90a`` once, at construction, and loads the CUBIN into each device
  at its first launch there (``kernels/_rtc_driver.py``).
- ``get_kernel(name, signature)`` parses the C signature with MXNet's rule
  (each argument ``(const) type (*) (name)``) and returns a
  ``CudaKernel``; ``CudaKernel.launch(args, ctx, grid_dims, block_dims,
  shared_mem)`` runs it on torch's current stream of ``ctx``, inside
  torch's primary context.
- ``register_cuda_op`` makes a kernel an operator of the registry
  (``ops/registry.py``), so ``find_op``, ``load_json`` and ``Executor``
  run it like any built-in; on ``meta`` tensors it only infers shapes,
  on CPU tensors it runs the caller's plain PyTorch version.
- ``TritonModule`` / ``TritonKernel.launch`` / ``register_triton_op`` are
  the analog of ``PallasModule.add_kernel`` / ``PallasKernel.launch`` /
  ``register_pallas_op`` for a ``@triton.jit`` function, the nearest thing
  on this card to a Pallas kernel function. ``triton`` is imported at the
  first launch.
- ``PallasModule``, ``PallasKernel`` and ``register_pallas_op`` keep their
  names and raise with guidance, as the JAX package's ``CudaModule`` does.

A kernel fills its outputs behind autograd's back, so a user op on an
input that requires grad, under grad mode, raises instead of returning
outputs whose gradient is silently cut (the JAX package's user ops raise
under ``jax.grad`` too). Each kernel object counts its launches in
``launches``; nothing compiles or loads at import.
"""
from __future__ import annotations

import ctypes
import operator
import re
import threading
import time
from collections import namedtuple

import numpy as _np
import torch

from .base import MXNetError
from .kernels import _rtc_driver as _drv
from .ndarray.ndarray import NDArray
from .ops.registry import register_op

__all__ = ["CudaModule", "CudaKernel", "KernelArg", "parse_signature",
           "register_cuda_op", "TritonModule", "TritonKernel",
           "register_triton_op", "PallasModule", "PallasKernel",
           "register_pallas_op"]

#: C type of a kernel argument -> (torch dtype, ctypes scalar type); the
#: reference's ``_DTYPE_CPP_TO_NP`` (``python/mxnet/rtc.py``). ``__half``
#: scalars travel as their 16 bits.
C_TYPES = {"float": (torch.float32, ctypes.c_float),
           "double": (torch.float64, ctypes.c_double),
           "__half": (torch.float16, ctypes.c_uint16),
           "uint8_t": (torch.uint8, ctypes.c_uint8),
           "int": (torch.int32, ctypes.c_int32),
           "int32_t": (torch.int32, ctypes.c_int32),
           "int8_t": (torch.int8, ctypes.c_int8),
           "char": (torch.int8, ctypes.c_int8),
           "int64_t": (torch.int64, ctypes.c_int64)}

#: Integer range of each integer C type, for its scalar arguments.
_RANGES = {k: (torch.iinfo(t).min, torch.iinfo(t).max)
           for k, (t, _) in C_TYPES.items() if not t.is_floating_point}
_INTS = (int, _np.integer)
_NUMBERS = _INTS + (float, _np.floating)

_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")
_SMEM_DEFAULT = 48 * 1024   # dynamic shared memory allowed without opt-in

#: One parsed kernel argument: ``ctype`` a key of ``C_TYPES``.
KernelArg = namedtuple("KernelArg", "is_const ctype is_pointer name")


def parse_signature(signature):
    """The arguments of a C kernel signature, by MXNet's rule: each
    comma-separated argument is ``(const) type (*) (name)``. A malformed
    argument raises ``ValueError``, a type outside ``C_TYPES``
    ``TypeError``."""
    args = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError('Invalid function prototype "%s". Must be in '
                             'the form of "(const) type (*) (name)"' % arg)
        if m.group(2) not in C_TYPES:
            raise TypeError("Unsupported kernel argument type %s. Supported "
                            "types are: %s." % (arg, ",".join(C_TYPES)))
        args.append(KernelArg(bool(m.group(1)), m.group(2),
                              bool(m.group(3)), m.group(4)))
    return args


def _require_cuda(what):
    if not torch.cuda.is_available():
        raise MXNetError("%s needs CUDA: torch.cuda.is_available() is False "
                         "(no card, or a CPU-only build of torch)" % what)


def _gpu_device(ctx):
    """``ctx`` as a CUDA ``torch.device`` with its index; anything else
    raises, as the reference's "Cuda kernel can only be launched on GPU"."""
    dev = ctx if isinstance(ctx, torch.device) else torch.device(ctx)
    if dev.type != "cuda":
        raise MXNetError("Cuda kernel can only be launched on GPU (ctx=%s)"
                         % dev)
    _require_cuda("CudaKernel.launch")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _dims(dims, what):
    try:
        ints = tuple(map(operator.index, dims))
    except TypeError:
        ints = ()
    if len(ints) != 3 or min(ints) < 1:
        raise MXNetError("%s must be a tuple of 3 positive integers, got %r"
                         % (what, dims))
    return ints


def _tensor_of(arg):
    return arg._data if isinstance(arg, NDArray) else arg


def _on_device(arg):
    """An input of a user op or a Triton launch as a tensor: NDArrays and
    tensors as they are; host data (numpy, lists) as ``NDArray`` makes it,
    on the default device with the port's dtype rule."""
    return arg if isinstance(arg, torch.Tensor) else NDArray(arg)._data


def _pack_scalar(value, ctype, i):
    cls = C_TYPES[ctype][1]
    if not isinstance(value, _NUMBERS):
        raise TypeError("The %d-th argument is expected to be a number of "
                        "type %s but got %s" % (i, ctype, type(value)))
    if ctype not in _RANGES:
        if ctype == "__half":
            return cls(int(_np.float16(value).view(_np.uint16)))
        return cls(float(value))
    if not isinstance(value, _INTS):
        raise TypeError("The %d-th argument is %s and takes an integer, got "
                        "%r" % (i, ctype, value))
    lo, hi = _RANGES[ctype]
    if not lo <= value <= hi:
        raise MXNetError("The %d-th argument %d does not fit in %s"
                         % (i, value, ctype))
    return cls(int(value))


class CudaModule:
    """CUDA C source compiled at run time (reference:
    ``mx.rtc.CudaModule``).

    ``options`` are NVRTC options (``"--fmad=false"``); without an
    architecture among them the source compiles for ``sm_90a``.
    ``exports`` are the name expressions (``"saxpy<float>"``) that
    ``get_kernel`` may ask for beside ``extern "C"`` names. The source
    compiles once, here; ``compile_seconds`` and ``log`` keep NVRTC's
    time and messages."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        _require_cuda("CudaModule")
        _drv.driver()
        t0 = time.perf_counter()
        self._cubin, self._lowered, self.log = _drv.compile_program(
            source, tuple(options), tuple(exports))
        self.compile_seconds = time.perf_counter() - t0
        self._modules = {}   # device ordinal -> CUmodule
        self._lock = threading.Lock()

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an exported name expression or an
        ``extern "C"`` name) with the C ``signature`` of its arguments."""
        return CudaKernel(self, name, self._lowered.get(name, name),
                          parse_signature(signature))

    def _module(self, ordinal):
        with self._lock:
            mod = self._modules.get(ordinal)
            if mod is None:
                mod = self._modules[ordinal] = _drv.load_module(ordinal,
                                                                self._cubin)
            return mod


class CudaKernel:
    """A function of a ``CudaModule`` with its parsed signature
    (``args``: ``KernelArg`` per argument). ``launches`` counts the
    launches the driver accepted."""

    def __init__(self, module, name, lowered_name, args):
        self.module = module
        self.name = name
        self.lowered_name = lowered_name
        self.args = list(args)
        self.launches = 0
        self._functions = {}     # device ordinal -> CUfunction
        self._shared_limit = {}  # device ordinal -> dynamic bytes allowed

    def _function(self, ordinal):
        fn = self._functions.get(ordinal)
        if fn is None:
            fn = self._functions[ordinal] = _drv.get_function(
                ordinal, self.module._module(ordinal), self.lowered_name)
        return fn

    def _pack(self, args, dev):
        """Check every argument against the signature before anything
        runs; returns (ctypes values, tensors the kernel writes)."""
        if len(args) != len(self.args):
            raise MXNetError("CudaKernel(%s) expects %d arguments but got %d"
                             % (self.name, len(self.args), len(args)))
        packed, written = [], []
        for i, (arg, spec) in enumerate(zip(args, self.args)):
            if not spec.is_pointer:
                packed.append(_pack_scalar(arg, spec.ctype, i))
                continue
            t = _tensor_of(arg)
            if not isinstance(t, torch.Tensor):
                raise TypeError("The %d-th argument is expected to be a "
                                "NDArray but got %s" % (i, type(arg)))
            want = C_TYPES[spec.ctype][0]
            if t.dtype != want:
                raise MXNetError("The %d-th argument of %s is %s* and takes "
                                 "%s, got %s" % (i, self.name, spec.ctype,
                                                 want, t.dtype))
            if t.device != dev:
                raise MXNetError("The %d-th argument of %s is on %s, not on "
                                 "ctx %s" % (i, self.name, t.device, dev))
            if not t.is_contiguous():
                raise MXNetError("The %d-th argument of %s is not contiguous"
                                 % (i, self.name))
            if not spec.is_const:
                if t.requires_grad and torch.is_grad_enabled():
                    raise MXNetError(
                        "The %d-th argument of %s is written in place and "
                        "requires grad: a kernel launch has no gradient"
                        % (i, self.name))
                written.append(t)
            packed.append(ctypes.c_void_p(t.data_ptr()))
        return packed, written

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU) with ``grid_dims`` x ``block_dims``
        threads and ``shared_mem`` bytes of dynamic shared memory, on
        torch's current stream of ``ctx``. Pointer arguments are NDArrays
        or tensors of the signature's dtype, contiguous, on ``ctx``; scalar
        arguments are Python numbers. A launch the card refuses raises."""
        dev = _gpu_device(ctx)
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        shared_mem = int(shared_mem)
        packed, written = self._pack(args, dev)
        ordinal = dev.index
        fn = self._function(ordinal)
        if shared_mem > max(_SMEM_DEFAULT, self._shared_limit.get(ordinal,
                                                                  0)):
            _drv.set_max_dynamic_shared(ordinal, fn, shared_mem)
            self._shared_limit[ordinal] = shared_mem
        stream = torch.cuda.current_stream(dev).cuda_stream
        _drv.launch(ordinal, fn, grid, block, shared_mem, stream, packed)
        self.launches += 1
        for t in written:
            if not t.is_inference():
                torch.autograd.graph.increment_version(t)


# --- user operators ----------------------------------------------------------


def _refuse_grad(name, inputs):
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        raise MXNetError("user op %s has no gradient: its kernel fills the "
                         "outputs outside autograd, so an input that "
                         "requires grad cannot pass (run it under "
                         "torch.no_grad() or detach the input)" % name)


def _one_device(name, inputs):
    devs = {t.device for t in inputs}
    if len(devs) != 1:
        raise MXNetError("user op %s: inputs on %s, want one device"
                         % (name, sorted(map(str, devs))))
    return devs.pop()


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


class _Outputs:
    """Allocates a user kernel's outputs: ``out_shape_fn`` runs on ``meta``
    tensors once per distinct input shapes and dtypes (all a meta tensor
    carries), and each call allocates the remembered (shape, dtype) pairs
    with ``torch.empty``. Calling it on every launch would cost more host
    time than the launch itself (``torch.empty_like`` of a meta tensor
    takes ~40 us). ``n_out`` None takes any number of outputs."""

    def __init__(self, name, out_shape_fn, n_out):
        self._name = name
        self._fn = out_shape_fn
        self._n_out = n_out
        self._specs = {}

    def __call__(self, inputs, dev):
        key = tuple((t.shape, t.dtype) for t in inputs)
        specs = self._specs.get(key)
        if specs is None:
            metas = _as_list(self._fn(*[torch.empty(shape, dtype=dtype,
                                                    device="meta")
                                        for shape, dtype in key]))
            if self._n_out not in (None, len(metas)) or not all(
                    isinstance(m, torch.Tensor) for m in metas):
                raise MXNetError("user op %s: out_shape_fn must return %s "
                                 "tensor(s), got %r" % (
                                     self._name, self._n_out or "meta",
                                     metas))
            specs = self._specs[key] = [(m.shape, m.dtype) for m in metas]
        return [torch.empty(shape, dtype=dtype, device=dev)
                for shape, dtype in specs]


def _user_op(name, n_out, out_shape_fn, run_cuda, plain_fn):
    """The registry function of a user op: shapes on ``meta`` tensors, the
    kernel on CUDA tensors (``run_cuda(params, inputs, device)``),
    ``plain_fn`` on CPU tensors."""
    def op_fn(params, *inputs):
        _refuse_grad(name, inputs)
        dev = _one_device(name, inputs)
        if dev.type == "meta":
            outs = _as_list(out_shape_fn(*inputs))
        elif dev.type == "cuda":
            outs = run_cuda(params, [t.contiguous() for t in inputs], dev)
        elif dev.type == "cpu":
            if plain_fn is None:
                raise MXNetError("user op %s has no plain_fn, so it cannot "
                                 "run on CPU tensors (its kernel runs only "
                                 "on the card)" % name)
            outs = _as_list(plain_fn(*inputs))
        else:
            raise MXNetError("user op %s: no kernel for device %s"
                             % (name, dev))
        return outs[0] if n_out == 1 else tuple(outs)
    op_fn.__name__ = name
    return op_fn


#: name -> the ``mx.nd`` function of each registered user op
_ND_FUNCTIONS = {}


def nd_function(name):
    """``mx.nd.<name>`` of a user op registered here, or None."""
    return _ND_FUNCTIONS.get(name)


def _nd_function(op_fn):
    def nd_fn(*arrays):
        # not recorded, as in the reference: a user kernel has no
        # gradient (an input that requires grad raises)
        out = op_fn(None, *map(_on_device, arrays))
        if isinstance(out, tuple):
            return [NDArray(o) for o in out]
        return NDArray(out)
    nd_fn.__name__ = op_fn.__name__
    _ND_FUNCTIONS[op_fn.__name__] = nd_fn
    return nd_fn


def register_cuda_op(name, kernel, out_shape_fn, launch_dims, scalars=None,
                     plain_fn=None, input_names=("data",)):
    """Expose a ``CudaKernel`` as a first-class op (the counterpart of
    ``register_pallas_op``; the runtime analog of NNVM_REGISTER_OP).

    The kernel's arguments are the op's inputs, then its outputs, then
    the scalars ``scalars(*inputs)`` returns; its signature fixes how many
    outputs there are. ``out_shape_fn(*inputs)`` receives and returns
    ``meta`` tensors; ``launch_dims(*inputs)`` returns ``(grid_dims,
    block_dims)`` or ``(grid_dims, block_dims, shared_mem)``; ``plain_fn``
    computes the same on CPU tensors. Returns the ``nd`` function, which
    puts host data on the default device as ``NDArray`` does;
    ``find_op``, ``load_json`` and ``Executor`` reach the op by ``name``
    (``mx.sym.<name>`` exists only for ops registered before import)."""
    if not isinstance(kernel, CudaKernel):
        raise TypeError("register_cuda_op: kernel must be a CudaKernel "
                        "(CudaModule.get_kernel), got %s" % type(kernel))
    input_names = tuple(input_names)
    kinds = [a.is_pointer for a in kernel.args]
    n_ptr = kinds.index(False) if False in kinds else len(kinds)
    if any(kinds[n_ptr:]):
        raise MXNetError("register_cuda_op(%s): the signature must list the "
                         "pointers (inputs, then outputs) before the scalars"
                         % name)
    n_out = n_ptr - len(input_names)
    if n_out < 1:
        raise MXNetError("register_cuda_op(%s): the signature has %d "
                         "pointers for %d inputs, so no output"
                         % (name, n_ptr, len(input_names)))
    n_scalar = len(kinds) - n_ptr
    alloc = _Outputs(name, out_shape_fn, n_out)

    def run_cuda(params, inputs, dev):
        outs = alloc(inputs, dev)
        extra = tuple(scalars(*inputs)) if scalars is not None else ()
        if len(extra) != n_scalar:
            raise MXNetError("register_cuda_op(%s): the signature takes %d "
                             "scalars, scalars() gave %d"
                             % (name, n_scalar, len(extra)))
        dims = tuple(launch_dims(*inputs))
        kernel.launch(list(inputs) + outs + list(extra), dev, *dims)
        return outs

    op_fn = _user_op(name, n_out, out_shape_fn, run_cuda, plain_fn)
    register_op(name, input_names=input_names, num_outputs=n_out)(op_fn)
    return _nd_function(op_fn)


# --- the Triton analog -------------------------------------------------------


def _triton():
    try:
        import triton
    except ImportError:
        raise MXNetError("TritonKernel needs the triton package, which is "
                         "not installed") from None
    return triton


#: The grid and keyword arguments of one ``TritonKernel.launch``.
_TritonLaunch = namedtuple("_TritonLaunch", "grid constexprs")


class TritonKernel:
    """A ``@triton.jit`` function as a launchable kernel (the analog of
    ``PallasKernel``). ``out_shape_fn`` maps ``meta`` copies of the inputs
    to ``meta`` outputs, which are allocated and passed after the inputs;
    ``plain_fn`` computes the same on CPU tensors. ``op_fn`` is the
    kernel's registry function: ``launch`` calls it with its own grid and
    keyword arguments, the registered op (``register_triton_op``) with
    its node's attributes, and then ``grid(*inputs)`` and
    ``kwargs(*inputs)`` give them. ``launches`` counts the kernel's
    launches."""

    def __init__(self, name, kernel_fn, out_shape_fn, plain_fn=None,
                 num_outputs=None, grid=None, kwargs=None):
        self.name = name
        self._fn = kernel_fn
        self._grid = grid
        self._kwargs = kwargs
        self._alloc = _Outputs(name, out_shape_fn, num_outputs)
        self.launches = 0
        self.op_fn = _user_op(name, num_outputs, out_shape_fn,
                              self._run_cuda, plain_fn)

    def _run_cuda(self, params, inputs, dev):
        triton = _triton()
        jit_types = tuple(getattr(triton.runtime, n) for n in (
            "KernelInterface", "JITFunction") if hasattr(triton.runtime, n))
        if not isinstance(self._fn, jit_types):
            raise MXNetError("TritonKernel(%s): kernel_fn must be a "
                             "@triton.jit function, got %s"
                             % (self.name, type(self._fn)))
        if isinstance(params, _TritonLaunch):
            grid, constexprs = params
        elif self._grid is None:
            raise MXNetError("TritonKernel(%s) has no grid function: run it "
                             "with launch(args, grid)" % self.name)
        else:
            grid = self._grid(*inputs)
            constexprs = self._kwargs(*inputs) if self._kwargs else {}
        outs = self._alloc(inputs, dev)
        with torch.cuda.device(dev):
            self._fn[grid](*inputs, *outs, **constexprs)
        self.launches += 1
        return outs

    def launch(self, args, grid, **constexprs):
        """Run on ``args`` (NDArrays, tensors, or host data, which goes to
        the default device) over the Triton ``grid`` (a tuple, or a
        function of the meta-parameters); ``constexprs`` are the kernel's
        keyword arguments after its arrays: ``tl.constexpr`` values and
        scalars such as a length. Returns the NDArray output(s)."""
        outs = _as_list(self.op_fn(_TritonLaunch(grid, constexprs),
                                   *map(_on_device, args)))
        return NDArray(outs[0]) if len(outs) == 1 else [NDArray(o)
                                                        for o in outs]


class TritonModule:
    """Holds runtime-defined Triton kernels (the analog of
    ``PallasModule``)."""

    def __init__(self):
        self._kernels = {}

    def add_kernel(self, name, kernel_fn, out_shape_fn, plain_fn=None):
        kernel = TritonKernel(name, kernel_fn, out_shape_fn, plain_fn)
        self._kernels[name] = kernel
        return kernel

    def get_kernel(self, name):
        if name not in self._kernels:
            raise MXNetError("no kernel %r in module" % name)
        return self._kernels[name]


def register_triton_op(name, kernel_fn, out_shape_fn, grid, kwargs=None,
                       plain_fn=None, input_names=("data",)):
    """Expose a ``@triton.jit`` function with one output as a first-class
    op (the analog of ``register_pallas_op``). ``grid(*inputs)`` returns
    the Triton grid and ``kwargs(*inputs)`` the kernel's keyword
    arguments (``tl.constexpr`` values, scalars such as a length); the
    rest as ``register_cuda_op``. The returned ``nd`` function carries the
    ``TritonKernel`` as ``.kernel``."""
    kernel = TritonKernel(name, kernel_fn, out_shape_fn, plain_fn, 1, grid,
                          kwargs)
    register_op(name, input_names=tuple(input_names))(kernel.op_fn)
    nd_fn = _nd_function(kernel.op_fn)
    nd_fn.kernel = kernel
    return nd_fn


# --- the JAX package's Pallas hooks ------------------------------------------

_PALLAS = ("%s is the JAX package's Pallas hook for the TPU and has no "
           "counterpart on the GPU: write the kernel in CUDA C and use "
           "mx.rtc.CudaModule, get_kernel and register_cuda_op, or as a "
           "@triton.jit function with mx.rtc.TritonModule and "
           "register_triton_op")


class PallasModule:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_PALLAS % "PallasModule")


class PallasKernel:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_PALLAS % "PallasKernel")


def register_pallas_op(*args, **kwargs):
    raise MXNetError(_PALLAS % "register_pallas_op")
