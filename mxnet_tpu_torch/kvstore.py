"""KVStore of the port on one process (reference: ``mxnet_tpu/kvstore.py``
L50-319).

``KVStore`` keeps the reference's local semantics: ``init`` copies a
value into the store, ``push`` merges the pushed copies and, with an
optimizer set (``set_optimizer``), runs the store's ``Updater`` on the
stored weight, on the weight's device; ``pull`` copies the stored value
into the given arrays. ``KVStoreTPUSync`` (``create("tpu_sync")``) is the
same store; ``Module`` turns it into its fused train step
(``parallel.DataParallelTrainStep``).

One process, one device: ``rank`` is 0 and ``num_workers`` 1. A push of
more than one device copy, ``dist*`` and ``*async*`` stores and gradient
compression are not yet ported (ROADMAP A7), nor the optimizer-state
files (ROADMAP A8).
"""
from __future__ import annotations

from .base import MXNetError
from . import optimizer as opt_mod

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
    """Single-process store with the reference's local semantics."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    # -- identity ----------------------------------------------------------
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- core API ----------------------------------------------------------
    def init(self, key, value):
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            self._store[str(k)] = vlist[0].copy()

    def _merge(self, vlist):
        if len(vlist) != 1:
            _not_ported("KVStore.push of %d device copies (multi-device "
                        "stores)" % len(vlist), "A7")
        return vlist[0].copy()

    def push(self, key, value, priority=0):
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            k = str(k)
            merged = self._merge(vlist)
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
        _not_ported("KVStore.row_sparse_pull (sparse storage)", "A9")

    # -- optimizer plumbing ------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    def _updater_key(self, k):
        try:
            return int(k)
        except ValueError:
            return k

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self.set_updater(opt_mod.get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        _not_ported("KVStore.set_gradient_compression", "A7")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        _not_ported("KVStore.save_optimizer_states", "A8")

    def load_optimizer_states(self, fname):
        _not_ported("KVStore.load_optimizer_states", "A8")

    def barrier(self):
        pass


class KVStoreTPUSync(KVStore):
    """The data-parallel store: ``Module`` runs its fused train step
    (forward, backward and update in one call) instead of push/pull."""

    def __init__(self):
        super().__init__("tpu_sync")


def create(name="local"):
    """reference: kvstore.py create — substring dispatch."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "async" in name or "dist" in name:
        _not_ported("kvstore %r (distributed stores)" % name, "A7")
    if "tpu" in name:
        return KVStoreTPUSync()
    if "nccl" in name or "device" in name or "local" in name:
        return KVStore(name)
    raise MXNetError("unknown kvstore type %r" % name)
