"""Training-state capture and restore: params, optimizer slots, RNG and
schedules (reference: ``mxnet_tpu/checkpoint/state.py``).

The capture functions run on the TRAINING thread and cost one device
copy: the port's arrays are mutated in place (the fused step writes params
and slots in place, and so do ``NDArray`` ops), so a point-in-time view
is a clone of each device tensor, enqueued on the current stream before
the next step is. A CUDA event recorded after the clones is the capture's
``ready`` mark. The writer thread waits on it, then copies the clones to
the host and serializes them; it never reads a live tensor. (The
reference pins its immutable JAX buffers instead, with no copy.)

Optimizer state is a tagged payload, the reference's format:

* ``kind="updater"`` — ``optimizer.Updater`` slots (multi-precision
  master tuples included) and the optimizer object (num_update,
  per-index counts, lr scheduler) with ``param_dict`` emptied.
* ``kind="fused"`` — the fused step's slot tree and its optimizer's name;
  the port adds ``module_optimizer``, the Module's optimizer object, so
  num_update and the scheduler position resume with it.
* ``kind="kvstore"`` (slots on ``dist_async`` servers) is not yet ported
  (ROADMAP A7 part 2), nor are the multi-host ``params.hostNNN-of-MMM`` files.

Payloads are pickles. The port reads them through :class:`_Unpickler`,
which maps ``mxnet_tpu.<mod>.<Name>`` to the port's class of the same name
and refuses any other module but numpy's and a few builtins, so a fit
checkpointed by the JAX package resumes here without importing it. A
legacy bare pickle that holds JAX arrays needs JAX by construction and
raises ``MXNetError``. The port's RNG state (its generators and numpy's)
goes to ``rng.pkl``; the two packages' RNGs never have to agree.
"""
from __future__ import annotations

import copy
import importlib
import io
import os
import pickle

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from . import layout

__all__ = ["TrainingState", "snapshot_params", "snapshot_tree",
           "tree_to_numpy", "tree_from_numpy", "capture_module",
           "capture_params", "optimizer_payload_bytes",
           "apply_optimizer_payload", "updater_payload_bytes",
           "apply_updater_payload", "save_params_files",
           "load_params_files", "from_legacy", "loads"]

_OPT_FORMAT_KEY = "mx_ckpt_opt"
_SAFE_BUILTINS = frozenset(("set", "frozenset", "slice", "complex", "range",
                            "bytearray", "bytes", "int", "float", "str",
                            "list", "dict", "tuple", "bool"))


# ---------------------------------------------------------------------------
# reading pickles without the JAX package
# ---------------------------------------------------------------------------

class _Unpickler(pickle.Unpickler):
    """Resolves the JAX package's classes to the port's of the same name;
    refuses every module but the port's, numpy's and safe builtins."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "mxnet_tpu":
            module = "mxnet_tpu_torch" + module[len("mxnet_tpu"):]
            top = "mxnet_tpu_torch"
        if top == "mxnet_tpu_torch":
            try:
                return getattr(importlib.import_module(module), name)
            except (ImportError, AttributeError):
                raise MXNetError("checkpoint payload names %s.%s, which the "
                                 "port does not have" % (module, name))
        if top in ("jax", "jaxlib"):
            raise MXNetError("checkpoint payload holds JAX arrays (%s.%s): "
                             "a legacy pickle that only the JAX package can "
                             "read" % (module, name))
        if top == "numpy" or (module == "builtins"
                              and name in _SAFE_BUILTINS) or \
                (module == "collections" and name == "OrderedDict"):
            return super().find_class(module, name)
        raise MXNetError("checkpoint payload names %s.%s, which a checkpoint "
                         "may not hold" % (module, name))


def loads(blob):
    """Unpickle a checkpoint payload with :class:`_Unpickler`."""
    return _Unpickler(io.BytesIO(blob)).load()


# ---------------------------------------------------------------------------
# snapshot / conversion trees
# ---------------------------------------------------------------------------

def snapshot_tree(x):
    """Point-in-time snapshot of a state tree, on the calling thread:
    NDArray and tensor leaves are cloned on their device; containers are
    shallow-copied; numpy leaves are copied; scalars and None pass."""
    if isinstance(x, NDArray):
        return NDArray(x._data.detach().clone())
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: snapshot_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(snapshot_tree(v) for v in x)
    if isinstance(x, _np.ndarray):
        return x.copy()
    return x


def snapshot_params(params):
    """Clone every array of a name -> NDArray dict (see snapshot_tree)."""
    return {k: snapshot_tree(v) for k, v in (params or {}).items()}


def _ready_event(*trees):
    """A CUDA event after the capture's clones, or None off the card."""
    def on_cuda(x):
        if isinstance(x, NDArray):
            x = x._data
        if isinstance(x, torch.Tensor):
            return x.is_cuda
        if isinstance(x, dict):
            return any(on_cuda(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return any(on_cuda(v) for v in x)
        return False
    if not any(on_cuda(t) for t in trees):
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def tree_to_numpy(x):
    """A snapshot tree on the host: NDArray and tensor leaves become numpy.
    Runs on the writer thread, after the capture's ready event."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: tree_to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_to_numpy(v) for v in x)
    return x


def tree_from_numpy(x, ctx=None):
    """Inverse of tree_to_numpy for optimizer slots: numpy leaves come back
    as NDArrays on ``ctx``."""
    if isinstance(x, _np.ndarray):
        return array(x, ctx=ctx, dtype=x.dtype)
    if isinstance(x, dict):
        return {k: tree_from_numpy(v, ctx) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_from_numpy(v, ctx) for v in x)
    return x


def _first_device(tree):
    if isinstance(tree, NDArray):
        return tree._data.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _first_device(v)
            if dev is not None:
                return dev
    return None


# ---------------------------------------------------------------------------
# optimizer payloads
# ---------------------------------------------------------------------------

def _clean_optimizer(opt):
    """A pickle-safe point-in-time copy: ``param_dict`` (live parameters)
    is dropped and the rest deep-copied, so the writer never sees later
    counter updates. LBSGD's pending accumulations are device tensors that
    no restore reads: they are dropped too. A string (the fused step
    names its optimizer) passes."""
    if opt is None or not hasattr(opt, "param_dict"):
        return opt
    out = copy.copy(opt)
    out.param_dict = {}
    if hasattr(out, "cumgrads"):
        out.cumgrads = {}
    return copy.deepcopy(out)


def restore_optimizer_attrs(dst, src):
    """Carry the schedule state of a restored optimizer object onto the
    live one: update counters, lr and wd, the multipliers and the lr
    scheduler object."""
    if dst is None or src is None or dst is src:
        return
    if not hasattr(dst, "__dict__") or not hasattr(src, "__dict__"):
        return  # a string-named optimizer carries no schedule
    for attr in ("num_update", "begin_num_update", "lr", "wd"):
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    for attr in ("_index_update_count", "lr_mult", "wd_mult", "idx2name"):
        if hasattr(src, attr):
            setattr(dst, attr, dict(getattr(src, attr)))
    if hasattr(src, "m_schedule"):   # Nadam's running product
        dst.m_schedule = src.m_schedule
    if getattr(src, "lr_scheduler", None) is not None:
        dst.lr_scheduler = src.lr_scheduler


def _module_updater(mod):
    """The Updater that holds a Module's slots: its own, or a local
    kvstore's when it updates on the store."""
    if getattr(mod, "_update_on_kvstore", False) and \
            getattr(mod, "_kvstore", None) is not None:
        return getattr(mod._kvstore, "_updater", None)
    return getattr(mod, "_updater", None)


def capture_optimizer(mod):
    """The payload dict (device clones) of a Module's optimizer state, or
    None before ``init_optimizer``."""
    if not getattr(mod, "optimizer_initialized", False):
        return None
    step = getattr(mod, "_fused_step", None)
    if step is not None:
        return {_OPT_FORMAT_KEY: 1, "kind": "fused",
                "optimizer": step.optimizer,
                "module_optimizer": _clean_optimizer(
                    getattr(mod, "_optimizer", None)),
                "state": snapshot_tree(step.opt_state)}
    updater = _module_updater(mod)
    if updater is None:
        return None
    return {_OPT_FORMAT_KEY: 1, "kind": "updater",
            "optimizer": _clean_optimizer(updater.optimizer),
            "states": snapshot_tree(updater.states)}


def optimizer_payload_bytes(mod):
    """A Module's optimizer payload, serialized (its host copy waits for
    the clones)."""
    payload = capture_optimizer(mod)
    if payload is None:
        raise MXNetError("module has no optimizer state to save")
    return _serialize_opt_payload(payload)


def _serialize_opt_payload(payload):
    out = dict(payload)
    for key in ("states", "state"):
        if key in out:
            out[key] = tree_to_numpy(out[key])
    return pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL)


def _parse_opt_payload(blob):
    """Every optimizer-state format (tagged, legacy fused, the reference's
    ``(states, optimizer)`` and bare states) as the tagged payload."""
    payload = loads(blob) if isinstance(blob, (bytes, bytearray)) else blob
    if isinstance(payload, dict) and payload.get(_OPT_FORMAT_KEY):
        return payload
    if isinstance(payload, dict) and "fused" in payload and \
            "state" in payload:
        return {_OPT_FORMAT_KEY: 1, "kind": "fused",
                "optimizer": payload["fused"], "state": payload["state"]}
    if isinstance(payload, tuple) and len(payload) == 2:
        return {_OPT_FORMAT_KEY: 1, "kind": "updater",
                "optimizer": payload[1], "states": payload[0]}
    if isinstance(payload, dict):
        return {_OPT_FORMAT_KEY: 1, "kind": "updater", "optimizer": None,
                "states": payload}
    raise MXNetError("unrecognized optimizer states payload (%s)"
                     % type(payload).__name__)


def _kind_not_ported(kind):
    raise MXNetError("optimizer payload kind %r (slots on dist_async "
                     "servers) is not yet ported (ROADMAP A7 part 2)"
                     % (kind,))


@torch.no_grad()
def _copy_tree_into(dst, src, where):
    """Copy a numpy slot tree into the fused step's tensors in place."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise MXNetError("checkpoint's fused optimizer state does not "
                             "match this step's (%s)" % where)
        for k in dst:
            _copy_tree_into(dst[k], src[k], "%s/%s" % (where, k))
        return
    if dst is None:
        if src is not None:
            raise MXNetError("checkpoint holds slots %s that this step has "
                             "not" % where)
        return
    value = torch.from_numpy(_np.array(src))   # a copy; 0-d stays 0-d
    if tuple(value.shape) != tuple(dst.shape):
        raise MXNetError("checkpoint slot %s has shape %s, the step's %s"
                         % (where, tuple(value.shape), tuple(dst.shape)))
    dst.copy_(value.to(dst.dtype))


def apply_optimizer_payload(mod, blob):
    """Restore a Module's optimizer state from payload bytes or dict."""
    payload = _parse_opt_payload(blob)
    kind = payload["kind"]
    if kind == "fused":
        step = getattr(mod, "_fused_step", None)
        if step is None:
            raise MXNetError("checkpoint holds fused-step optimizer state "
                             "but this module has no fused step")
        if payload.get("zero"):
            raise MXNetError("checkpoint holds ZeRO-sharded slots: not yet "
                             "ported (ROADMAP A7 part 3)")
        _copy_tree_into(step.opt_state, tree_to_numpy(payload["state"]),
                        "opt_state")
        src = payload.get("module_optimizer") or payload.get("optimizer")
        restore_optimizer_attrs(getattr(mod, "_optimizer", None), src)
        return
    if kind == "updater":
        if getattr(mod, "_fused_step", None) is not None:
            raise MXNetError("optimizer states hold worker-updater slots "
                             "but this module trains with the fused step")
        updater = _module_updater(mod)
        if updater is None:
            raise MXNetError("checkpoint holds optimizer slots but this "
                             "module has no updater")
        apply_updater_payload(updater, payload, ctx=mod._context[0])
        if getattr(mod, "_optimizer", None) is not None and \
                mod._optimizer is not updater.optimizer:
            restore_optimizer_attrs(mod._optimizer, payload.get("optimizer"))
        return
    if kind == "kvstore":
        _kind_not_ported(kind)
    raise MXNetError("unknown optimizer payload kind %r" % (kind,))


def updater_payload_bytes(updater, dump_optimizer=False):
    """An ``optimizer.Updater``'s payload bytes: its slots and, with
    ``dump_optimizer``, the optimizer's schedule counters."""
    payload = {_OPT_FORMAT_KEY: 1, "kind": "updater",
               "optimizer": _clean_optimizer(updater.optimizer)
               if dump_optimizer else None,
               "states": snapshot_tree(updater.states)}
    return _serialize_opt_payload(payload)


def apply_updater_payload(updater, blob, ctx=None):
    """Restore an Updater from payload bytes (any format). The slots land
    on ``ctx``, by default the device of the updater's current slots, else
    the default device. Returns the payload's optimizer object, or None."""
    payload = _parse_opt_payload(blob)
    if payload["kind"] != "updater":
        if payload["kind"] == "kvstore":
            _kind_not_ported(payload["kind"])
        raise MXNetError("payload kind %r cannot restore an Updater"
                         % (payload["kind"],))
    if ctx is None:
        ctx = _first_device(updater.states)
    updater.states = tree_from_numpy(tree_to_numpy(payload["states"]), ctx)
    updater.states_synced = {k: False for k in updater.states}
    opt = payload.get("optimizer")
    if opt is not None:
        restore_optimizer_attrs(updater.optimizer, opt)
    return opt


# ---------------------------------------------------------------------------
# RNG
# ---------------------------------------------------------------------------

def capture_rng():
    """The port's RNG state: ``mx.random``'s seed and each generator's
    state, and numpy's global state. Host reads only."""
    from .. import random as _rnd
    with _rnd._lock:
        gens = {str(dev): gen.get_state().numpy().tobytes()
                for dev, gen in _rnd._generators.items()}
        seed = _rnd._seed
    return {"seed": seed, "generators": gens,
            "numpy": _np.random.get_state()}


def restore_rng(state):
    from .. import random as _rnd
    with _rnd._lock:
        _rnd._seed = int(state["seed"])
    for dev, blob in state.get("generators", {}).items():
        dev = torch.device(dev)
        if dev.type == "cuda" and not torch.cuda.is_available():
            continue   # a card's stream, restored on a host without one
        gen = _rnd.generator(dev)
        gen.set_state(torch.frombuffer(bytearray(blob), dtype=torch.uint8))
    if state.get("numpy") is not None:
        _np.random.set_state(state["numpy"])


# ---------------------------------------------------------------------------
# params files
# ---------------------------------------------------------------------------

def save_params_files(path, arg_params, aux_params):
    """Write ``params.nd`` (``model.save_params``' container, which either
    package's ``load_params`` reads). Returns the manifest's shard index:
    always {} here, the multi-host layout being not yet ported (A7 part 2)."""
    from ..model import save_params
    save_params(os.path.join(path, layout.PARAMS_FILE), arg_params or {},
                aux_params or {})
    return {}


def load_params_files(path, meta=None):
    """(arg_params, aux_params) of a checkpoint directory, on the CPU."""
    from ..model import load_params
    single = os.path.join(path, layout.PARAMS_FILE)
    if os.path.isfile(single):
        return load_params(single)
    if layout.list_host_params_files(path):
        raise MXNetError("checkpoint %s holds multi-host params files: not "
                         "yet ported (ROADMAP A7 part 2)" % path)
    raise MXNetError("checkpoint %s has no params file" % path)


# ---------------------------------------------------------------------------
# TrainingState + capture entry points
# ---------------------------------------------------------------------------

class TrainingState:
    """Everything one checkpoint carries, captured on the training thread:
    device clones, and ``ready``, the CUDA event after them (None off the
    card)."""

    __slots__ = ("arg_params", "aux_params", "symbol_json", "optimizer",
                 "extra_writers", "rng", "epoch", "step", "meta_extra",
                 "ready")

    def __init__(self, arg_params=None, aux_params=None, symbol_json=None,
                 optimizer=None, extra_writers=(), rng=None, epoch=None,
                 step=None, meta_extra=None, ready=None):
        self.arg_params = arg_params or {}
        self.aux_params = aux_params or {}
        self.symbol_json = symbol_json
        self.optimizer = optimizer
        self.extra_writers = list(extra_writers)
        self.rng = rng
        self.epoch = epoch
        self.step = step
        self.meta_extra = dict(meta_extra or {})
        self.ready = ready

    def wait_ready(self):
        """Block the calling (writer) thread until the clones exist."""
        if self.ready is not None:
            self.ready.synchronize()


def capture_params(symbol=None, arg_params=None, aux_params=None, epoch=None,
                   step=None, **meta_extra):
    """TrainingState from explicit parts (``do_checkpoint``)."""
    args, auxs = snapshot_params(arg_params), snapshot_params(aux_params)
    return TrainingState(
        arg_params=args, aux_params=auxs,
        symbol_json=symbol.tojson() if symbol is not None else None,
        rng=capture_rng(), epoch=epoch, step=step, meta_extra=meta_extra,
        ready=_ready_event(args, auxs))


def capture_module(mod, epoch=None, step=None, arg_params=None,
                   aux_params=None, **meta_extra):
    """TrainingState of a Module: params and aux states, optimizer slots
    and RNG. ``arg_params``/``aux_params`` may pass the dicts fit already
    read at the epoch's end."""
    if arg_params is None or aux_params is None:
        arg_params, aux_params = mod.get_params()
    args, auxs = snapshot_params(arg_params), snapshot_params(aux_params)
    payload = capture_optimizer(mod)
    symbol = getattr(mod, "symbol", None)
    return TrainingState(
        arg_params=args, aux_params=auxs,
        symbol_json=symbol.tojson() if symbol is not None else None,
        optimizer=payload, rng=capture_rng(), epoch=epoch, step=step,
        meta_extra=meta_extra,
        ready=_ready_event(args, auxs, (payload or {}).get("state"),
                           (payload or {}).get("states")))


def from_legacy(prefix, epoch):
    """TrainingState of a two-file checkpoint (``prefix-symbol.json`` and
    ``prefix-%04d.params``)."""
    from ..model import load_checkpoint
    symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
    return TrainingState(
        arg_params=arg_params, aux_params=aux_params,
        symbol_json=symbol.tojson() if symbol is not None else None,
        epoch=epoch, step=epoch,
        meta_extra={"legacy_source": os.path.abspath(prefix)})
