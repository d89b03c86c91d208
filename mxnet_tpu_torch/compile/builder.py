"""ProgramBuilder — one program family's dispatch seam and counters.

Counterpart of ``mxnet_tpu/compile/builder.py``. The JAX builder lowers
and compiles one XLA executable per distinct shape/dtype signature; the
port runs the program body eagerly, so what it keeps of that seam is the
bookkeeping callers rely on: each distinct signature is one "program",
``program_count()`` counts them (the decode engine's ``len(buckets) + 1``
invariant), and the per-site compile counters record whether a signature
was first seen ahead of time (``warmup``) or on demand (first dispatch).
``torch.compile`` and CUDA-graph capture would plug in here, keyed by the
same signature.
"""
from __future__ import annotations

import threading
from collections import namedtuple

from .. import profiler as _prof

__all__ = ["ProgramBuilder", "TensorSpec"]

#: Abstract argument for ahead-of-time registration (the analog of
#: ``jax.ShapeDtypeStruct``): anything with ``shape`` and ``dtype``.
TensorSpec = namedtuple("TensorSpec", ["shape", "dtype"])


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                            TensorSpec):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class ProgramBuilder:
    """Signature cache over an eager program body.

    Parameters
    ----------
    fn : callable
        The program body, called with the dispatch arguments as given.
    site : str
        Label the compile counters aggregate under.
    donate_argnums : tuple of int
        Arguments the body updates in place and returns (the decode
        engine's KV pages): the eager analog of XLA buffer donation, kept
        as ``self.donate_argnums`` for callers and for later capture.
    """

    def __init__(self, fn, site="program", donate_argnums=()):
        self._fn = fn
        self.site = str(site)
        self.donate_argnums = tuple(donate_argnums or ())
        self._lock = threading.Lock()
        self._sigs = set()

    @staticmethod
    def _sig(args):
        sig = []
        for leaf in _leaves(args):
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is None or dtype is None:
                sig.append(type(leaf))
            else:
                sig.append((tuple(int(d) for d in shape), str(dtype)))
        return tuple(sig)

    def aot_info(self, *args, mode="aot"):
        """Register the signature of ``args`` (tensors or
        :class:`TensorSpec`); returns ``(fn, built)`` with ``built`` True
        only for the call that first saw it. ``mode`` labels the counter:
        "aot" for warmup, "ondemand" for a first dispatch."""
        key = self._sig(args)
        with self._lock:
            built = key not in self._sigs
            self._sigs.add(key)
        if built:
            _prof.record_compile(self.site, aot=(mode == "aot"))
        else:
            _prof.record_compile_hit(self.site)
        return self._fn, built

    def __call__(self, *args):
        """Run the body; a signature seen for the first time here is
        counted as an on-demand program."""
        key = self._sig(args)
        with self._lock:
            known = key in self._sigs
        if not known:
            self.aot_info(*args, mode="ondemand")
        return self._fn(*args)

    def program_count(self):
        """Number of distinct signatures this builder has seen."""
        with self._lock:
            return len(self._sigs)
