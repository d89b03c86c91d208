"""KVStore of the port (reference: ``mxnet_tpu/kvstore.py`` L50-319).

``KVStore`` keeps the reference's local semantics: ``init`` copies a
value into the store; ``push`` merges the pushed device copies (each
staged onto the first copy's device and summed in list order, one add a
copy: reference L88-117), sums the result over the worker processes,
then, with an optimizer set (``set_optimizer``), runs the store's
``Updater`` on the stored weight, on the weight's device, or without one
copies the sum into the store; ``pull`` copies the stored value into the
given arrays. ``set_gradient_compression({'type': '2bit', ...})`` sends
each device copy through the 2-bit round trip of
``gradient_compression`` before the merge, with one error-feedback
residual per (key, copy slot).

``rank`` and ``num_workers`` come from the ``torch.distributed`` process
group (``parallel.collectives``), for every store. ``create`` dispatches
on the name as the reference does: ``tpu`` and ``dist`` join the
launcher's process group (gloo) and return ``KVStoreTPUSync`` (its
``type`` the name for ``dist*``), whose push sums over the workers;
``nccl``, ``device`` and ``local`` return ``KVStore``. ``Module`` turns a
``tpu_sync`` store, or ``device`` over several contexts, into its fused
train step (``parallel.DataParallelTrainStep``); ``dist_sync`` goes
through push and pull with the per-parameter ``Updater``, as in the
reference.

Not yet ported, and raising: the asynchronous stores (``*async*``, a
parameter server: ROADMAP A7 part 2) and row-sparse push and pull
(ROADMAP A9 part 2). ``save_optimizer_states``/``load_optimizer_states``
write and read the store's updater as ``checkpoint/state.py``'s tagged
payload.
"""
from __future__ import annotations

import torch

from .base import MXNetError, atomic_write
from .gradient_compression import GradientCompression
from .ndarray.ndarray import NDArray
from . import optimizer as opt_mod
from .parallel import collectives

__all__ = ["KVStore", "KVStoreTPUSync", "create"]


def _key_list(keys):
    single = not isinstance(keys, (list, tuple))
    return ([keys] if single else list(keys)), single


def _val_list(vals, n):
    if isinstance(vals, (list, tuple)) and vals and \
            isinstance(vals[0], (list, tuple)):
        return list(vals)
    if isinstance(vals, (list, tuple)) and n > 1:
        assert len(vals) == n   # one value list per key
        return [[v] if not isinstance(v, (list, tuple)) else list(v)
                for v in vals]
    if isinstance(vals, (list, tuple)) and n == 1:
        return [list(vals)]
    return [[vals]]


def _not_ported(what, item):
    raise MXNetError("%s is not yet ported (ROADMAP %s)" % (what, item))


class KVStore:
    """The store with the reference's local semantics."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._gc = GradientCompression()
        self._residuals = {}  # (key, device slot) -> error-feedback residual

    # -- identity ----------------------------------------------------------
    @property
    def rank(self):
        return collectives.process_index()

    def get_rank(self):
        return self.rank

    @property
    def num_workers(self):
        return collectives.process_count()

    def get_group_size(self):
        return self.num_workers

    # -- core API ----------------------------------------------------------
    def init(self, key, value):
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            self._store[str(k)] = vlist[0].copy()

    @torch.no_grad()
    def _merge(self, vlist):
        """The sum of the device copies, in list order, on the first
        copy's device (reference: CommDevice::Reduce)."""
        if len(vlist) == 1:
            return vlist[0].copy()
        dev = vlist[0].context
        acc = vlist[0]._data.detach()
        for v in vlist[1:]:
            acc = acc + v._data.detach().to(dev)
        return NDArray(acc)

    def _compress_vlist(self, k, vlist):
        """Each device copy through the 2-bit round trip, with one
        residual per (key, slot)."""
        out = []
        for slot, v in enumerate(vlist):
            rkey = (k, slot)
            if rkey not in self._residuals:
                self._residuals[rkey] = torch.zeros(
                    v.size, dtype=torch.float32, device=v.context)
            recv, self._residuals[rkey] = self._gc.compress_decompress(
                v._data.detach(), self._residuals[rkey])
            out.append(NDArray(recv))
        return out

    def push(self, key, value, priority=0):
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            k = str(k)
            if self._gc.active:
                vlist = self._compress_vlist(k, vlist)
            merged = self._allreduce_across_workers(self._merge(vlist))
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % k)
            if self._updater is not None:
                self._updater(self._updater_key(k), merged, self._store[k])
            else:
                merged.copyto(self._store[k])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, _ = _key_list(key)
        for k, olist in zip(keys, _val_list(out, len(keys))):
            k = str(k)
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % k)
            for o in olist:
                self._store[k].copyto(o)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        _not_ported("KVStore.row_sparse_pull (sparse storage)", "A9 part 2")

    # -- the cross-worker sum (tpu_sync / dist) ----------------------------
    def _allreduce_across_workers(self, merged):
        if self.num_workers == 1:
            return merged
        return NDArray(collectives.allreduce_hosts(merged._data))

    # -- optimizer plumbing ------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    _update_rule = set_updater

    def _updater_key(self, k):
        try:
            return int(k)
        except ValueError:
            return k

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self.set_updater(opt_mod.get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        """2-bit error-feedback compression on the push path (reference:
        set_gradient_compression -> SetParams)."""
        self._gc.set_params(compression_params)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        atomic_write(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        from .checkpoint.state import _first_device, apply_updater_payload
        with open(fname, "rb") as f:
            apply_updater_payload(self._updater, f.read(),
                                  ctx=_first_device(self._store))

    def barrier(self):
        if self.num_workers > 1:
            collectives.host_barrier()

    # the ps-lite compat surface (reference: kvstore.h:254-304)
    @staticmethod
    def is_worker_node():
        return True

    @staticmethod
    def is_server_node():
        return False

    @staticmethod
    def is_scheduler_node():
        return False

    def send_command_to_servers(self, head, body):
        pass


class KVStoreTPUSync(KVStore):
    """The data-parallel store: ``Module`` runs its fused train step
    (forward, backward and update in one call) instead of push/pull; its
    push sums over the worker processes."""

    def __init__(self):
        super().__init__("tpu_sync")


def create(name="local"):
    """reference: kvstore.cc substring dispatch."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "async" in name:
        _not_ported("kvstore %r (asynchronous parameter servers)" % name,
                    "A7 part 2")
    if "tpu" in name or "dist" in name:
        # join the launcher's process group, if it named one
        collectives.ensure_distributed()
    if "tpu" in name:
        return KVStoreTPUSync()
    if "dist" in name:
        kv = KVStoreTPUSync()
        kv.type = name
        return kv
    if "nccl" in name or "device" in name or "local" in name:
        return KVStore(name)
    raise MXNetError("unknown kvstore type %r" % name)
