"""Cross-process collectives of the port (reference:
``mxnet_tpu/parallel/collectives.py``, L1-105).

``ensure_distributed()`` joins a ``torch.distributed`` process group from
the environment the repo's launcher sets (``tools/launch.py``):
``JAX_COORDINATOR_ADDRESS`` (host:port of rank 0's store),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, or their ``DMLC_*``
aliases (``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``,
``DMLC_WORKER_ID``), so one launcher starts workers of either package.
With one process, or no such environment, it does nothing.

The backend is gloo: it runs on the host, and it is the one backend that
two ranks sharing one card can use (NCCL refuses two ranks on one GPU).
``allreduce_hosts`` stages a CUDA tensor through a pinned host buffer
(torch's caching host allocator keeps those buffers), sums there over
the processes and copies the sum back to the tensor's device. Every
join, collective and barrier has a timeout (``MXNET_DIST_TIMEOUT_S``,
default 300 s): a peer that never comes raises instead of hanging.

The reference's ``shard_map`` (JAX's manual SPMD resolver) has no
counterpart: its users are the sharded islands of ROADMAP A7 part 3.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..base import MXNetError, get_env

__all__ = ["ensure_distributed", "allreduce_hosts", "host_barrier",
           "process_count", "process_index"]


def _timeout():
    return datetime.timedelta(seconds=get_env("MXNET_DIST_TIMEOUT_S", 300.0,
                                              float))


def _env_world():
    """(num_processes, process_id, coordinator "host:port" or None) from
    the launcher's environment; (1, 0, None) without one."""
    env = os.environ
    n = int(env.get("JAX_NUM_PROCESSES") or env.get("DMLC_NUM_WORKER")
            or "1")
    rank = int(env.get("JAX_PROCESS_ID") or env.get("DMLC_WORKER_ID")
               or "0")
    addr = env.get("JAX_COORDINATOR_ADDRESS")
    if not addr and env.get("DMLC_PS_ROOT_URI"):
        addr = "%s:%s" % (env["DMLC_PS_ROOT_URI"],
                          env.get("DMLC_PS_ROOT_PORT", "9091"))
    return n, rank, addr


def ensure_distributed():
    """Join the launcher's process group once (gloo, with a timeout); a
    no-op with one process or no launcher environment."""
    if dist.is_initialized():
        return
    n, rank, addr = _env_world()
    if n <= 1:
        return
    if not addr:
        raise MXNetError("%d processes named but no coordinator address "
                         "(JAX_COORDINATOR_ADDRESS)" % n)
    dist.init_process_group("gloo", init_method="tcp://" + addr,
                            world_size=n, rank=rank, timeout=_timeout())


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def allreduce_hosts(value):
    """The SUM of ``value`` (a tensor) over every process, as a new tensor
    on ``value``'s device; ``value`` itself with one process."""
    if process_count() == 1:
        return value
    with torch.no_grad():
        if value.device.type == "cpu":
            host = value.detach().clone()
        else:
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            host.copy_(value.detach())   # waits for the copy: gloo reads it
        work = dist.all_reduce(host, op=dist.ReduceOp.SUM, async_op=True)
        work.wait(_timeout())
        if value.device.type == "cpu":
            return host
        return host.to(value.device, copy=True)


def host_barrier():
    """Every process reaches this point before any leaves it (a timeout
    names the ranks that did not)."""
    if process_count() == 1:
        return
    dist.monitored_barrier(timeout=_timeout())
