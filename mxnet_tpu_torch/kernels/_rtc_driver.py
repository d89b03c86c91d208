"""ctypes bindings to the CUDA driver API and to NVRTC, for ``mx.rtc``.

Counterpart of the reference's ``src/common/rtc.cc`` (``CudaModule``
over NVRTC, L35): NVRTC compiles CUDA C source at run time to a CUBIN
for Hopper (``--gpu-architecture=sm_90a`` unless the caller's options
name an architecture), and the driver API loads it into torch's primary
context and launches its functions on torch's streams. A CUBIN holds
machine code for the card, so the driver loads it with no JIT step.

Nothing loads at import: ``libcuda`` and ``libnvrtc`` are opened on first
use, so the CPU tests can import every module of the port on machines
with neither. Every ``CUresult`` or ``nvrtcResult`` that is not 0 raises
:class:`MXNetError` with the error's name; a failed compile raises with
NVRTC's log. Every pointer in the ``argtypes`` is ``c_void_p``, so ctypes
never cuts a pointer to 32 bits.
"""
from __future__ import annotations

import ctypes
import os
import threading

from ..base import MXNetError

__all__ = ["driver", "nvrtc", "nvrtc_version", "compile_program",
           "primary_context", "context_scope", "load_module",
           "get_function", "set_max_dynamic_shared", "launch",
           "LIBCUDA", "NVRTC_NAMES"]

LIBCUDA = "libcuda.so.1"
#: File names tried for NVRTC in each directory, newest ABI first.
NVRTC_NAMES = ("libnvrtc.so", "libnvrtc.so.13", "libnvrtc.so.12")
#: ``CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES`` (cuda.h).
_ATTR_MAX_DYNAMIC_SHARED = 8

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_U = ctypes.c_uint
_I = ctypes.c_int
_S = ctypes.c_char_p
_SIZE_P = ctypes.POINTER(ctypes.c_size_t)

_lock = threading.RLock()
_state = {"driver": None, "nvrtc": None, "nvrtc_path": None}
_contexts = {}    # device ordinal -> retained primary CUcontext (int)

# name -> (argtypes, restype) of the driver entries used; the ``_v2``
# names are the ones cuda.h's macros select for these entries
_DRIVER_FNS = {
    "cuInit": ([_U], _I),
    "cuDeviceGet": ([ctypes.POINTER(_I), _I], _I),
    "cuDevicePrimaryCtxRetain": ([_PP, _I], _I),
    "cuCtxGetCurrent": ([_PP], _I),
    "cuCtxPushCurrent_v2": ([_P], _I),
    "cuCtxPopCurrent_v2": ([_PP], _I),
    "cuModuleLoadData": ([_PP, _P], _I),
    "cuModuleGetFunction": ([_PP, _P, _S], _I),
    "cuFuncSetAttribute": ([_P, _I, _I], _I),
    "cuLaunchKernel": ([_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP], _I),
    "cuGetErrorName": ([_I, ctypes.POINTER(_S)], _I),
    "cuGetErrorString": ([_I, ctypes.POINTER(_S)], _I),
}

_NVRTC_FNS = {
    "nvrtcVersion": ([ctypes.POINTER(_I), ctypes.POINTER(_I)], _I),
    "nvrtcGetErrorString": ([_I], _S),
    "nvrtcCreateProgram": ([_PP, _S, _S, _I, ctypes.POINTER(_S),
                            ctypes.POINTER(_S)], _I),
    "nvrtcAddNameExpression": ([_P, _S], _I),
    "nvrtcCompileProgram": ([_P, _I, ctypes.POINTER(_S)], _I),
    "nvrtcGetProgramLogSize": ([_P, _SIZE_P], _I),
    "nvrtcGetProgramLog": ([_P, _P], _I),
    "nvrtcGetCUBINSize": ([_P, _SIZE_P], _I),
    "nvrtcGetCUBIN": ([_P, _P], _I),
    "nvrtcGetLoweredName": ([_P, _S, ctypes.POINTER(_S)], _I),
    "nvrtcDestroyProgram": ([_PP], _I),
}


def _bind(lib, table):
    for name, (argtypes, restype) in table.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _cu_error(res):
    lib = _state["driver"]
    name, text = _S(), _S()
    if lib is None or lib.cuGetErrorName(res, ctypes.byref(name)) != 0:
        return "CUresult %d" % res
    lib.cuGetErrorString(res, ctypes.byref(text))
    return "%s (%s)" % (name.value.decode(), (text.value or b"").decode())


def check(res, what):
    """Raise :class:`MXNetError` naming ``what`` when ``res`` is not
    ``CUDA_SUCCESS``."""
    if res != 0:
        raise MXNetError("%s failed: %s" % (what, _cu_error(res)))


def driver():
    """``libcuda`` with its entries typed, after ``cuInit(0)``."""
    with _lock:
        if _state["driver"] is None:
            try:
                lib = ctypes.CDLL(LIBCUDA)
            except OSError as e:
                raise MXNetError("mx.rtc needs the CUDA driver: cannot load "
                                 "%s (%s)" % (LIBCUDA, e)) from None
            _state["driver"] = _bind(lib, _DRIVER_FNS)
            check(lib.cuInit(0), "cuInit")
        return _state["driver"]


def _toolkit():
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvrtc_dirs():
    """Directories searched for NVRTC, in order: ``$CUDA_HOME/lib64``,
    ``/usr/local/cuda/lib64``, and the ``nvidia/cuda_nvrtc/lib`` that
    PyTorch's CUDA wheel ships beside ``torch``."""
    import torch
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(os.path.join(os.environ["CUDA_HOME"], "lib64"))
    dirs.append("/usr/local/cuda/lib64")
    site = os.path.dirname(os.path.dirname(os.path.abspath(torch.__file__)))
    dirs.append(os.path.join(site, "nvidia", "cuda_nvrtc", "lib"))
    return dirs


def nvrtc():
    """``libnvrtc`` with its entries typed; raises naming every path tried."""
    with _lock:
        if _state["nvrtc"] is None:
            tried = []
            for d in _nvrtc_dirs():
                for n in NVRTC_NAMES:
                    path = os.path.join(d, n)
                    tried.append(path)
                    if not os.path.exists(path):
                        continue
                    try:
                        lib = ctypes.CDLL(path)
                    except OSError as e:
                        tried[-1] += " (%s)" % e
                        continue
                    _state["nvrtc"] = _bind(lib, _NVRTC_FNS)
                    _state["nvrtc_path"] = path
                    return lib
            raise MXNetError("mx.rtc needs NVRTC: no loadable libnvrtc in "
                             + ", ".join(tried))
        return _state["nvrtc"]


def nvrtc_version():
    """(major, minor, path of the library) of the NVRTC in use."""
    lib = nvrtc()
    major, minor = _I(), _I()
    _nvrtc_check(lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor)),
                 "nvrtcVersion")
    return major.value, minor.value, _state["nvrtc_path"]


def _nvrtc_check(res, what, log=None):
    if res != 0:
        name = _state["nvrtc"].nvrtcGetErrorString(res)
        msg = "%s failed: %s" % (what, (name or b"nvrtcResult %d" % res)
                                 .decode())
        if log:
            msg += "\n" + log
        raise MXNetError(msg)


def _program_log(lib, prog):
    size = ctypes.c_size_t()
    if lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)) != 0:
        return ""
    buf = ctypes.create_string_buffer(size.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors="replace").strip()


def compile_program(source, options=(), name_expressions=()):
    """Compile CUDA C ``source`` with NVRTC to a CUBIN.

    Returns ``(cubin bytes, {name expression: lowered name}, log)``.
    ``--gpu-architecture=sm_90a`` is added unless ``options`` name an
    architecture, and ``--include-path=<toolkit>/include`` when that
    directory exists, so a source may ``#include <cuda_fp16.h>``. The name
    expressions (``"saxpy<float>"``) are added before the compile and
    their lowered names read before the program is destroyed."""
    lib = nvrtc()
    opts = [str(o) for o in options]
    if not any(o.startswith(("--gpu-architecture", "-arch")) for o in opts):
        opts.append("--gpu-architecture=sm_90a")
    include = os.path.join(_toolkit(), "include")
    if os.path.isdir(include):
        opts.append("--include-path=" + include)
    prog = _P()
    _nvrtc_check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        b"mx_rtc.cu", 0, None, None),
                 "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _nvrtc_check(lib.nvrtcAddNameExpression(prog, expr.encode()),
                         "nvrtcAddNameExpression(%r)" % expr)
        c_opts = (_S * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), c_opts)
        log = _program_log(lib, prog)
        _nvrtc_check(res, "nvrtcCompileProgram (options %s)" % opts, log)
        size = ctypes.c_size_t()
        _nvrtc_check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        lowered = {}
        for expr in name_expressions:
            out = _S()
            _nvrtc_check(lib.nvrtcGetLoweredName(prog, expr.encode(),
                                                 ctypes.byref(out)),
                         "nvrtcGetLoweredName(%r)" % expr)
            lowered[expr] = out.value.decode()
        return buf.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def primary_context(ordinal):
    """The primary context of device ``ordinal`` (the one torch's runtime
    uses), retained once per device and kept for the process's life."""
    ctx = _contexts.get(ordinal)
    if ctx is not None:
        return ctx
    with _lock:
        ctx = _contexts.get(ordinal)
        if ctx is None:
            lib = driver()
            dev, handle = _I(), _P()
            check(lib.cuDeviceGet(ctypes.byref(dev), ordinal), "cuDeviceGet")
            check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(handle),
                                               dev.value),
                  "cuDevicePrimaryCtxRetain")
            ctx = _contexts[ordinal] = handle.value
        return ctx


class context_scope:
    """``with context_scope(ordinal):`` makes the device's primary context
    current: it pushes the context when another one (or none: a thread
    that never touched CUDA has none) is current, and pops it again on
    exit. On a thread where torch made it current already, nothing is
    pushed."""

    def __init__(self, ordinal):
        self._ctx = primary_context(ordinal)
        self._pushed = False

    def __enter__(self):
        lib = _state["driver"]
        current = _P()
        check(lib.cuCtxGetCurrent(ctypes.byref(current)), "cuCtxGetCurrent")
        if current.value != self._ctx:
            check(lib.cuCtxPushCurrent_v2(self._ctx), "cuCtxPushCurrent")
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            popped = _P()
            check(_state["driver"].cuCtxPopCurrent_v2(ctypes.byref(popped)),
                  "cuCtxPopCurrent")
        return False


def load_module(ordinal, cubin):
    """Load ``cubin`` into device ``ordinal``'s primary context; returns
    the ``CUmodule`` handle."""
    mod = _P()
    with context_scope(ordinal):
        check(driver().cuModuleLoadData(ctypes.byref(mod), cubin),
              "cuModuleLoadData")
    return mod.value


def get_function(ordinal, module, name):
    """The ``CUfunction`` called ``name`` (a lowered name for a template
    instance) in ``module``."""
    fn = _P()
    with context_scope(ordinal):
        check(driver().cuModuleGetFunction(ctypes.byref(fn), module,
                                           name.encode()),
              "cuModuleGetFunction(%r)" % name)
    return fn.value


def set_max_dynamic_shared(ordinal, function, nbytes):
    """Allow ``function`` ``nbytes`` of dynamic shared memory (needed above
    48 KB; the card refuses more than its per-block limit)."""
    with context_scope(ordinal):
        check(driver().cuFuncSetAttribute(function, _ATTR_MAX_DYNAMIC_SHARED,
                                          int(nbytes)),
              "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES, %d)"
              % nbytes)


def launch(ordinal, function, grid, block, shared_mem, stream, params):
    """``cuLaunchKernel`` on ``stream`` (a ``CUstream`` as an int; 0 is the
    legacy default stream). ``params`` are ctypes objects, one per kernel
    argument, in order; the driver copies their values at the launch."""
    arr = (_P * len(params))(*[ctypes.addressof(p) for p in params])
    with context_scope(ordinal):
        res = _state["driver"].cuLaunchKernel(
            function, grid[0], grid[1], grid[2], block[0], block[1],
            block[2], shared_mem, stream, arr, None)
    check(res, "cuLaunchKernel(grid=%s, block=%s, shared_mem=%d)"
          % (tuple(grid), tuple(block), shared_mem))
