"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface under ``mxnet_tpu_torch/_build/`` (listed in
``.gitignore``). Nothing includes PyTorch's headers, so a build takes
seconds. A source may carry flags of its own (``EXTRA_FLAGS``: the fused
optimizer update builds with ``--fmad=false``, so that it equals its plain
PyTorch version bit for bit). A library is named by a hash of its source
and its flags, so an edited source (or shared ``csrc/*.cuh`` header) or
flag rebuilds and an unchanged one is loaded as it is. All sources build
at once, one ``nvcc`` each, started together.

Nothing here runs at import: the CPU tests import every module of the
port, on machines that may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "EXTRA_FLAGS", "nvcc_path", "build_all", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

#: Kernel library name -> source file under ``csrc/``.
SOURCES = {"flash_fwd_offs": "flash_fwd_offs.cu",
           "flash_fwd": "flash_fwd.cu",
           "flash_bwd_offs": "flash_bwd_offs.cu",
           "flash_fwd_grid": "flash_fwd_grid.cu",
           "flash_fwd_offs_grid": "flash_fwd_offs_grid.cu",
           "flash_bwd_grid": "flash_bwd_grid.cu",
           "opt_update": "opt_update.cu"}

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel library name -> nvcc flags of its own, after ``_FLAGS``.
#: ``--fmad=false``: no a*b + c contracted into an FMA, which separate
#: torch kernels never do.
EXTRA_FLAGS = {"opt_update": ("--fmad=false",)}


def _flags(name):
    return _FLAGS + EXTRA_FLAGS.get(name, ())

_lock = threading.Lock()
_libs = {}
#: name -> {"seconds": build wall time (0.0 when loaded from a previous
#: build), "ptxas": the compiler's register/shared-memory report}
build_info = {}
#: (csrc directory, name) -> the same, for builds of another checkout's
#: sources (``build_all(csrc=...)``)
csrc_build_info = {}


def nvcc_path():
    """The ``nvcc`` to build with, or None when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def _lib_path(name, csrc=_CSRC):
    src = os.path.join(csrc, SOURCES[name])
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    headers = sorted(n for n in os.listdir(csrc) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(csrc, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(_BUILD_DIR, "lib%s-%s.so"
                             % (name, digest.hexdigest()[:16]))


def build_all(names=None, csrc=None):
    """Compile every source whose library is missing, all in parallel;
    returns ``{name: path}``. Raises RuntimeError with the compiler's
    output when a build fails or ``nvcc`` is missing. ``csrc``: build the
    sources of another checkout's ``csrc/`` directory (same names and
    flags; recorded in ``csrc_build_info``, not ``build_info``)."""
    names = list(SOURCES) if names is None else list(names)
    own = csrc is None
    todo, paths = [], {}
    for name in names:
        src, path = _lib_path(name, _CSRC if own else csrc)
        paths[name] = path
        if os.path.exists(path):
            if own:
                build_info.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        else:
            todo.append((name, src, path))
    if not todo:
        return paths
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)"
                           ": cannot build %s" % [t[0] for t in todo])
    os.makedirs(_BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, src, path in todo:
        tmp = "%s.%d.tmp" % (path, os.getpid())
        procs.append((name, path, tmp, subprocess.Popen(
            [nvcc, *_flags(name), "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode,
                                                      log))
            continue
        os.replace(tmp, path)   # atomic: a concurrent loader never sees half
        info = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if own:
            build_info[name] = info
        else:
            csrc_build_info[csrc, name] = info
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel library ``name``, building it
    on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build_all([name])[name])
        return lib
