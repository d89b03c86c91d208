"""Build the port's kernel sources for the host CPU, against a small
emulator of the CUDA they use, so that the kernels' own logic (indexing,
fragment layouts, shared-memory descriptors and swizzles, masks, splits,
the online softmax, the optimizer update's leaf table and chunks) runs in
the CPU tests.

The emulator (``emu/cuda_runtime.h``, ``emu/emu.cpp``) runs every block of
a launch in turn and its threads as host threads: ``__syncthreads`` and
the warp-collective ``__shfl_xor_sync`` and ``mma.sync`` (TF32 m16n8k8)
meet at barriers. The warpgroup's ``wgmma.mma_async`` (bf16 m64nNk16, A
from registers or through a shared-memory descriptor, B through one: the
descriptor's start address, leading and stride byte offsets and swizzle
mode are decoded, and the operand is read through the hardware's address
swizzle) is asynchronous as on the card: issuing one records it and sets
its accumulators to NaN, and the ``wgmma.wait_group`` that retires its
``commit_group`` runs it, the warpgroup meeting there, reading A's
registers and the shared tiles then and writing the accumulators last. So
accumulators read before their wait, or A registers and tiles overwritten
before it, show in the results. What it cannot see: a missing
``wgmma.fence`` (the card may read registers written just before the
product without one), and anything ptxas does with the products.
``cp.async`` copies at once (so its ``wait_group`` and
``fence.proxy.async`` have nothing to do), and the bf16 round
(``cvt.rn.bf16x2.f32``) is done on the bits. On the way to ``g++`` each
source is rewritten: the PTX helpers of ``csrc/tf32_mma.cuh``,
``csrc/bf16_mma.cuh`` and ``csrc/bf16_wgmma.cuh`` call the emulator, a
``<<<...>>>`` launch becomes ``emu_launch``, and dynamic shared memory
comes from the launch. An emulated product sums in double and rounds once,
where the tensor cores round toward zero, so results agree with the card's
to rounding, not bit for bit. The optimizer update has no product and
builds with ``-ffp-contract=off`` (the card's ``--fmad=false``), so its
results are the card's bit for bit. The emulator is slow (a host thread
per CUDA thread, a thread switch per barrier): tests give it a few blocks.

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

__all__ = ["compiler", "load", "load_source", "entry"]

_EMU = os.path.join(_build._HERE, "emu")
_OUT = os.path.join(_build._BUILD_DIR, "emu")
#: the PTX helpers of csrc/tf32_mma.cuh, bf16_mma.cuh and bf16_wgmma.cuh
#: -> their emulated bodies
_HELPERS = {
    "cp_async16": "{ emu_cp_async(dst, src, valid, 16); }",
    "cp_async4": "{ emu_cp_async(dst, src, valid, 4); }",
    "cp_async_commit": "{}",
    "cp_async_wait_all": "{}",
    "cp_async_wait": "{}",
    "mma_tf32": "{ emu_mma_tf32(c, a, b); }",
    "pack_bf16x2": "{ d = emu_pack_bf16x2(lo, hi); }",
    "wgmma_rs": "{ emu_wgmma(d, N, a, 0, desc_b, scale_d, 0, kTransB); }",
    "wgmma_ss": ("{ emu_wgmma(d, N, nullptr, desc_a, desc_b, scale_d, 0, "
                 "kTransB); }"),
    "wgmma_fence": "{ emu_warpgroup_sync(); }",
    "wgmma_commit": "{ emu_wgmma_commit(); }",
    "wgmma_wait": "{ emu_wgmma_wait(N); }",
    "fence_regs": "{}",
    "fence_frags": "{}",
    "fence_proxy_async": "{}",
}
#: dynamic shared memory declarations -> the launch's
_SMEM = {
    "extern __shared__ __align__(16) float smem[];":
        "float* smem = emu_smem();",
    "extern __shared__ __align__(1024) unsigned char mx_smem[];":
        "unsigned char* mx_smem = reinterpret_cast<unsigned char*>("
        "emu_smem());",
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
    for decl, emulated in _SMEM.items():
        text = text.replace(decl, emulated)
    text = _LAUNCH.sub(lambda m: "emu_launch(%s, [&] { %s(%s); });" % (
        ", ".join(m.group(2).split(",")[:3]), m.group(1), m.group(3)), text)
    if "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError("the emulator has no counterpart for inline PTX "
                           "outside %s" % sorted(_HELPERS))
    return text


def _build_lib(name, text=None):
    """Library ``name`` built from its csrc source, or from ``text`` (a
    source of its own, as ``name``.cu, that may include the csrc headers)."""
    src_dir = _build._CSRC
    main = _build.SOURCES[name] if text is None else name + ".cu"
    files = {n: _rewrite(open(os.path.join(src_dir, n)).read())
             for n in sorted(os.listdir(src_dir))
             if n.endswith(".cuh") or n == main}
    if text is not None:
        files[main] = _rewrite(text)
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
         "-x", "c++", os.path.join(work, main),
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


def load_source(name, text):
    """The ``ctypes.CDLL`` of a CUDA source of the caller's own (``text``,
    which may include the csrc headers, as a test's kernels do) built for
    the host under the library name ``name``."""
    with _lock:
        lib = _libs.get((name, text))
        if lib is None:
            lib = _libs[name, text] = ctypes.CDLL(_build_lib(name, text))
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
