"""Run an MXNet script written for ``mxnet_tpu`` against this package.

    python -m mxnet_tpu_torch.run_script [--np-seed N] SCRIPT [ARGS...]

The script runs unchanged as ``__main__`` (``runpy``), with ``sys.argv``
set to ``[SCRIPT, ARGS...]``. Before it starts, a ``sys.meta_path`` finder
resolves ``mxnet_tpu`` and every ``mxnet_tpu.<sub>`` import to the module
objects of ``mxnet_tpu_torch`` (``mxnet_tpu.models`` is
``mxnet_tpu_torch.models``, the same object): no file of the JAX package
runs. The launcher refuses to start when ``jax`` or ``mxnet_tpu`` is
already imported. ``--np-seed`` seeds numpy's global RNG first (the
iterators shuffle with it). When the script returns, the launcher prints
``run_script: jax not in sys.modules``, or exits 1 if something imported
jax after all.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.abc
import importlib.machinery
import runpy
import sys

ALIAS = "mxnet_tpu"
TARGET = __package__     # this package, also under python -m


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, module):
        self._module = module

    def create_module(self, spec):
        return self._module

    def exec_module(self, module):
        pass   # the module object already ran, under its own name


class AliasFinder(importlib.abc.MetaPathFinder):
    """Resolves ``mxnet_tpu[.sub]`` to ``mxnet_tpu_torch[.sub]``."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != ALIAS and not fullname.startswith(ALIAS + "."):
            return None
        module = importlib.import_module(TARGET + fullname[len(ALIAS):])
        return importlib.machinery.ModuleSpec(
            fullname, _AliasLoader(module),
            is_package=hasattr(module, "__path__"))


def install():
    """Put the alias finder first on ``sys.meta_path``; raises when jax or
    the JAX package is already imported."""
    loaded = [m for m in ("jax", ALIAS) if m in sys.modules]
    if loaded:
        raise RuntimeError("run_script: %s already imported; the port must "
                           "start in a process without them" % loaded)
    importlib.import_module(TARGET)
    sys.meta_path.insert(0, AliasFinder())


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="run an mxnet_tpu script against mxnet_tpu_torch")
    parser.add_argument("--np-seed", type=int, default=None,
                        help="seed numpy's global RNG before the script")
    parser.add_argument("script")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    ns = parser.parse_args(argv)
    install()
    if ns.np_seed is not None:
        import numpy as np
        np.random.seed(ns.np_seed)
    sys.argv = [ns.script] + ns.args
    runpy.run_path(ns.script, run_name="__main__")
    if "jax" in sys.modules:
        print("run_script: jax was imported", file=sys.stderr)
        return 1
    print("run_script: jax not in sys.modules", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
