"""Build the port's kernel sources for the host CPU, against a small
emulator of the CUDA they use, so that the kernels' own logic (indexing,
fragment layouts, masks, splits, the online softmax, the optimizer
update's leaf table and chunks) runs in the CPU tests.

The emulator (``emu/cuda_runtime.h``, ``emu/emu.cpp``) runs every block of
a launch in turn and its threads as host threads: ``__syncthreads`` and
the warp-collective ``__shfl_xor_sync`` and ``mma.sync`` (TF32 m16n8k8,
bf16 m16n8k16) meet at barriers, ``cp.async`` copies at once, and the
bf16 round (``cvt.rn.bf16x2.f32``) is done on the bits. On the way to
``g++`` each source is rewritten: the PTX helpers of
``csrc/tf32_mma.cuh`` and ``csrc/bf16_mma.cuh`` call the emulator,
a ``<<<...>>>`` launch becomes ``emu_launch``, and dynamic shared memory
comes from the launch. An emulated MMA rounds its sum to nearest, where
the tensor cores round toward zero, so results agree with the card's to
rounding, not bit for bit. The optimizer update has no MMA and builds
with ``-ffp-contract=off`` (the card's ``--fmad=false``), so its results
are the card's bit for bit. The emulator is slow (a host thread per CUDA
thread, a thread switch per barrier): tests give it a few blocks.

Builds under ``mxnet_tpu_torch/_build/emu/``, named by a hash of the
rewritten sources, and needs ``g++``. The C entries keep their argument
lists; their stream argument is ignored. One launch at a time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

from . import _build

__all__ = ["compiler", "load", "entry"]

_EMU = os.path.join(_build._HERE, "emu")
_OUT = os.path.join(_build._BUILD_DIR, "emu")
#: the PTX helpers of csrc/tf32_mma.cuh and bf16_mma.cuh -> their
#: emulated bodies
_HELPERS = {
    "cp_async16": "{ emu_cp_async(dst, src, valid, 16); }",
    "cp_async4": "{ emu_cp_async(dst, src, valid, 4); }",
    "cp_async_commit": "{}",
    "cp_async_wait_all": "{}",
    "mma_tf32": "{ emu_mma_tf32(c, a, b); }",
    "mma_bf16": "{ emu_mma_bf16(c, a, b); }",
    "pack_bf16x2": "{ d = emu_pack_bf16x2(lo, hi); }",
}
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                     re.S)
#: library name -> g++ flags of its own (as ``_build.EXTRA_FLAGS``)
EXTRA_FLAGS = {"opt_update": ("-ffp-contract=off",)}
_lock = threading.Lock()
_libs = {}


def compiler():
    """The host C++ compiler the emulator builds with, or None."""
    return shutil.which("g++")


def _rewrite(text):
    """``text`` of a csrc file with its PTX and launches emulated."""
    for name, body in _HELPERS.items():
        start = text.find("void %s(" % name)
        if start < 0:
            continue
        open_ = text.index(") {\n", start) + 2
        close = text.index("\n}\n", open_)
        text = text[:open_] + body + text[close + 2:]
    text = text.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = emu_smem();")
    text = _LAUNCH.sub(lambda m: "emu_launch(%s, [&] { %s(%s); });" % (
        ", ".join(m.group(2).split(",")[:3]), m.group(1), m.group(3)), text)
    if "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError("the emulator has no counterpart for inline PTX "
                           "outside %s" % sorted(_HELPERS))
    return text


def _build_lib(name):
    src_dir = _build._CSRC
    files = {n: _rewrite(open(os.path.join(src_dir, n)).read())
             for n in sorted(os.listdir(src_dir))
             if n.endswith(".cuh") or n == _build.SOURCES[name]}
    emu = {n: open(os.path.join(_EMU, n)).read()
           for n in ("cuda_runtime.h", "emu.cpp")}
    flags = EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha256(" ".join(flags).encode())
    for n, text in sorted(files.items()) + sorted(emu.items()):
        digest.update(n.encode() + b"\0" + text.encode())
    work = os.path.join(_OUT, digest.hexdigest()[:16])
    path = os.path.join(work, "lib%s.so" % name)
    if os.path.exists(path):
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("g++ not found: cannot emulate %s" % name)
    os.makedirs(work, exist_ok=True)
    for n, text in files.items():
        with open(os.path.join(work, n), "w") as f:
            f.write(text)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", *flags,
         "-I", _EMU, "-I", work, "-include", "cuda_runtime.h",
         "-x", "c++", os.path.join(work, _build.SOURCES[name]),
         "-x", "none", os.path.join(_EMU, "emu.cpp"), "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("emulated build of %s failed:\n%s"
                           % (name, proc.stdout))
    os.replace(tmp, path)
    return path


def load(name):
    """The ``ctypes.CDLL`` of kernel library ``name`` built for the host."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_build_lib(name))
        return lib


def entry(name):
    """C entry ``name`` (``flash_attention._ENTRIES`` or
    ``opt_update._ENTRIES``) of the emulated library; call it with host
    pointers and ``None`` for the stream."""
    from . import flash_attention, opt_update
    if name in opt_update._ENTRIES:
        lib, argtypes = "opt_update", opt_update._ENTRIES[name]
    else:
        lib, argtypes = flash_attention._ENTRIES[name]
    fn = getattr(load(lib), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn
