"""Device meshes of the port (reference: ``mxnet_tpu/parallel/mesh.py``,
L1-57).

A mesh is an array of ``torch.device``s with axis names (``Mesh``); a
``PartitionSpec`` is a tuple of axis names (or None) per array axis, and
a ``NamedSharding`` pairs the two. They hold no JAX type and carry the
reference's vocabulary: ``data_parallel_mesh`` (one ``dp`` axis) and
``get_mesh`` (``dp``, ``tp``, ``pp``, ``sp``, with the reference's size
check). ``DataParallelTrainStep`` and ``Module`` take such a mesh, or a
plain list of devices.

A mesh whose entries all name one physical device (``[gpu(0), gpu(0)]``;
every ``cpu(i)`` is the one host device of torch) runs the whole batch on
that device: ``one_physical_device``. Entries on different physical
devices in one process (a sharded step) raise: ROADMAP A7 part 3.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["Mesh", "get_mesh", "data_parallel_mesh", "ShardingConfig",
           "PartitionSpec", "NamedSharding", "mesh_devices",
           "one_physical_device"]


class PartitionSpec(tuple):
    """Per array axis, the mesh axis it is split over (or None)."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)


class Mesh:
    """An n-d array of devices with one name per axis."""

    def __init__(self, devices, axis_names):
        if isinstance(devices, _np.ndarray):
            arr = devices.astype(object)
        else:
            arr = _np.empty(len(devices), dtype=object)
            arr[:] = list(devices)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError("mesh of %d axes given %d names"
                             % (arr.ndim, len(self.axis_names)))

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __iter__(self):
        return iter(self.devices.flat)


class NamedSharding:
    def __init__(self, mesh, spec=PartitionSpec()):
        self.mesh = mesh
        self.spec = spec


def data_parallel_mesh(devices=None):
    """A 1-d ``dp`` mesh over ``devices`` (default: the card)."""
    devices = [resolve_device(None)] if devices is None else list(devices)
    return Mesh([resolve_device(d) for d in devices], ("dp",))


def get_mesh(dp=1, tp=1, pp=1, sp=1, devices=None):
    """A (dp, tp, pp, sp) mesh; unit axes are kept for uniform specs."""
    devices = [resolve_device(None)] if devices is None else list(devices)
    n = dp * tp * pp * sp
    if n != len(devices):
        raise ValueError("mesh size %d != device count %d"
                         % (n, len(devices)))
    arr = _np.empty(n, dtype=object)
    arr[:] = [resolve_device(d) for d in devices]
    return Mesh(arr.reshape(dp, tp, pp, sp), ("dp", "tp", "pp", "sp"))


class ShardingConfig:
    """Parameter-sharding rules: name substring -> PartitionSpec."""

    def __init__(self, mesh, rules=(), default=PartitionSpec()):
        self.mesh = mesh
        self.rules = list(rules)
        self.default = default

    def spec_for(self, name):
        for pat, spec in self.rules:
            if pat in name:
                return spec
        return self.default

    def sharding_for(self, name):
        return NamedSharding(self.mesh, self.spec_for(name))

    def batch_sharding(self):
        return NamedSharding(self.mesh, PartitionSpec("dp"))


def mesh_devices(mesh):
    """The entries of a ``Mesh`` or a list/tuple of devices, resolved to
    ``torch.device``s."""
    if isinstance(mesh, (Mesh, list, tuple)):
        entries = list(mesh)
    else:
        raise MXNetError("a mesh is a parallel.mesh.Mesh or a list of "
                         "devices, not %s" % type(mesh).__name__)
    if not entries:
        raise MXNetError("a mesh needs at least one device")
    return [resolve_device(d) for d in entries]


def _physical(device):
    # every cpu(i) is torch's one host device
    return torch.device("cpu") if device.type == "cpu" else device


def one_physical_device(devices, what):
    """The one physical device that ``devices`` name; entries on several
    raise (ROADMAP A7 part 3)."""
    found = []
    for d in devices:
        p = _physical(torch.device(d))
        if p not in found:
            found.append(p)
    if len(found) != 1:
        raise MXNetError("%s over the devices %s: a step sharded over "
                         "several physical devices in one process is not "
                         "yet ported (ROADMAP A7 part 3)"
                         % (what, [str(d) for d in found]))
    return found[0]
