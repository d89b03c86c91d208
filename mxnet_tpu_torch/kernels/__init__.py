"""Hand-written Hopper kernels of the port, each beside its plain version.

Kernel sources live in ``csrc/`` and build on first use
(``_build.py``); importing this package builds nothing.
"""
from . import flash_attention, opt_update

__all__ = ["flash_attention", "opt_update"]
