"""Fused optimizer update (TPU kernel #7) of the port: the gradient
prologue (rescale -> clip -> + wd * weight) fused with the SGD, momentum
or Adam update, in place, over every float32 leaf of an update in one
launch.

Counterpart of ``mxnet_tpu/kernels/opt_update.py``. The TPU kernels
``_sgd_kernel`` / ``_sgd_mom_kernel`` / ``_adam_kernel`` (L96/L103/L113,
launched per leaf by ``_run_leaf_kernel``, L130) and the lax tier the
JAX package runs beside them for the leaves they reject (L194-238, which
XLA fuses into the same step program) are one multi-tensor CUDA kernel of
``csrc/opt_update.cu`` here, one C entry per update kind
(``mx_optupdate_multi_{sgd,sgd_mom,adam}_f32``), built with
``--fmad=false``.

- ``fused_update_step`` puts every float32 CUDA leaf into a table of
  (param, grad, slots) records and launches the kernel once per
  ``_MAX_LEAVES`` leaves, in tree order: one launch for a ResNet-50
  update. A float32 CUDA leaf launches the kernel or raises (a build or
  launch error, a grad or slot that is not float32, contiguous and of the
  same size), checked for every leaf before anything is built or written.
  A leaf of another dtype takes the plain expression, as the reference's
  lax tier does for it; CPU tensors take the plain expression and launch
  nothing; any other device raises. ``_kernel_eligible`` keeps the
  reference's rule (L125-127) and only names the leaves that are the TPU
  kernel's.
- ``fused_update_step_plain`` is the plain PyTorch version of the whole
  update, per leaf: the expressions of the JAX package's lax tier over
  ``_prologue``, with its operations in its order. On the card the kernel
  equals it bit for bit.
- Params and slots are dicts (nested dicts work: the update walks tree
  leaves in sorted-key order) and are updated IN PLACE, the eager analog
  of the jitted step's buffer donation; both functions return them.
- ``hp["lr"]`` is a float or a float32 0-d tensor on the params' device.
  The kernel reads lr (Adam: ``lr * corr``) through a device pointer, and
  Adam's step ``t`` and ``corr`` are computed on the device in plain torch,
  so an lr schedule changes no launch argument and needs no host sync.

The ctypes writes bypass autograd's version counter: a caller must not
keep an autograd graph that saved a param across the update.
"""
from __future__ import annotations

import array
import ctypes
import math

import torch

from ..base import MXNetError

__all__ = ["fused_update_step", "fused_update_step_plain",
           "optupdate_ideal_bytes", "optupdate_kernel_bytes"]

_LANES = 128
#: Leaves one launch takes at most: ``kMaxLeaves`` of ``csrc/opt_update.cu``
#: (the table is the kernel's parameter); a longer table goes out as
#: several launches.
_MAX_LEAVES = 160

#: Launches of the kernel for each update kind, and the leaves those
#: launches updated (plain-expression leaves are not counted); callers may
#: reset them to 0.
launches_sgd = 0
launches_sgd_mom = 0
launches_adam = 0
leaves_sgd = 0
leaves_sgd_mom = 0
leaves_adam = 0


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def _kernel_eligible(leaf):
    """The reference's rule for the TPU kernel's leaves: float32 ``[rows,
    128]`` lane blocks of at least 8 rows."""
    n = leaf.numel()
    return (leaf.dtype == torch.float32 and n >= 8 * _LANES
            and n % _LANES == 0)


def _prologue(p, g, rescale, clip, wd):
    """The reference optimizer order: rescale -> clip -> + wd * weight.
    ``g + wd * p`` is unconditional, as in the JAX package (``0 * inf`` is
    NaN)."""
    g = g * rescale
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    return g + wd * p


def _sqrt(v):
    """The correctly rounded float32 square root, on any device: the
    float64 root rounded once to float32 (53 >= 2 * 24 + 2 bits, so the
    double rounding is exact). torch's vectorized CPU sqrt is off by one
    ulp on some inputs; XLA's, CUDA's ``sqrtf`` and IEEE's are not."""
    return torch.sqrt(v.double()).to(v.dtype)


def _plain_leaf(optimizer, hp, lr, p, g, slots, rescale, clip, wd):
    """One leaf by the plain expression, written back in place."""
    g = _prologue(p, g, rescale, clip, wd)
    if optimizer == "adam":
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
        m, v = slots
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        p.copy_(p - lr * m_new / (_sqrt(v_new) + eps))
        m.copy_(m_new)
        v.copy_(v_new)
    elif slots:
        (mom,) = slots
        mom_new = hp.get("momentum", 0.0) * mom - lr * g
        p.copy_(p + mom_new)
        mom.copy_(mom_new)
    else:
        p.copy_(p - lr * g)


# --- the CUDA wrappers -----------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: rescale, clip, lo, hi, wd: the prologue's arguments of every entry
_PRO = [_F, _I, _F, _F, _F]
#: C entry -> argument types (records, count, lr, the kind's scalars, the
#: prologue's, stream); every entry returns a CUDA error.
_ENTRIES = {
    "mx_optupdate_multi_sgd_f32": [_P, _I, _P] + _PRO + [_P],
    "mx_optupdate_multi_sgd_mom_f32": [_P, _I, _P, _F] + _PRO + [_P],
    "mx_optupdate_multi_adam_f32": [_P, _I, _P] + [_F] * 5 + _PRO + [_P],
}
#: update kind -> its C entry
_ENTRY = {"sgd": "mx_optupdate_multi_sgd_f32",
          "sgd_mom": "mx_optupdate_multi_sgd_mom_f32",
          "adam": "mx_optupdate_multi_adam_f32"}
_fns = {}


def _entry(name):
    """The C entry ``name``, its library built on first use."""
    fn = _fns.get(name)
    if fn is None:
        from . import _build
        fn = getattr(_build.load("opt_update"), name)
        fn.argtypes = _ENTRIES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _call(fn, device, *args):
    """``fn(*args, stream)`` with ``device`` current, on its current
    stream."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _on_cuda(t):
    """True on CUDA, False on the CPU; any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise MXNetError("fused_update_step: no kernel for device %s" % t.device)


def _check_leaf(p, others):
    for name, t in others:
        if t.device != p.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.numel() != p.numel():
            raise MXNetError(
                "fused_update_step: %s of a kernel leaf must be a contiguous "
                "float32 tensor of %d elements on %s, got %s %s of %d on %s"
                % (name, p.numel(), p.device, "contiguous" if
                   t.is_contiguous() else "non-contiguous", t.dtype,
                   t.numel(), t.device))
    if not p.is_contiguous():
        raise MXNetError("fused_update_step: param is not contiguous")


def _kind(optimizer, slots):
    if optimizer == "adam":
        return "adam"
    return "sgd_mom" if slots else "sgd"


def _records(leaves):
    """The ``MxOptLeaf`` array of ``leaves`` ((p, g, slots) each) as int64
    words: the pointers (0 for a slot the kind lacks), n, and whether every
    pointer is 16-byte aligned and n % 4 == 0 (an ``array.array``: a ctypes
    array of as many words takes several times longer to build)."""
    words = []
    for p, g, slots in leaves:
        ptrs = [p.data_ptr(), g.data_ptr()] + [t.data_ptr() for t in slots]
        ptrs += [0] * (4 - len(ptrs))
        n = p.numel()
        aligned = n % 4 == 0 and not (ptrs[0] | ptrs[1] | ptrs[2]
                                      | ptrs[3]) & 15
        words += ptrs + [n, int(aligned)]
    return array.array("q", words)


def _launch(optimizer, hp, lr_t, leaves, rescale, clip, wd):
    """Launch the kernel of ``optimizer`` over ``leaves`` ((p, g, slots)
    of one CUDA device, nonempty, whose tensors ``_check_leaf`` passed),
    in order, at most ``_MAX_LEAVES`` a launch; ``lr_t`` is the float32
    device scalar it reads (Adam: lr * corr)."""
    kind = _kind(optimizer, leaves[0][2])
    pro = (float(rescale), int(clip is not None),
           -float(clip) if clip is not None else 0.0,
           float(clip) if clip is not None else 0.0, float(wd))
    if kind == "adam":
        b1, b2 = hp["beta1"], hp["beta2"]
        args = (b1, 1 - b1, b2, 1 - b2, hp["eps"]) + pro
    elif kind == "sgd_mom":
        args = (hp.get("momentum", 0.0),) + pro
    else:
        args = pro
    fn = _entry(_ENTRY[kind])
    device = leaves[0][0].device
    for i in range(0, len(leaves), _MAX_LEAVES):
        part = leaves[i:i + _MAX_LEAVES]
        records = _records(part)
        err = _call(fn, device, records.buffer_info()[0], len(part),
                    lr_t.data_ptr(), *args)
        if err != 0:
            raise MXNetError("%s launch failed: CUDA error %d"
                             % (_ENTRY[kind], err))
        counters = globals()
        counters["launches_" + kind] += 1
        counters["leaves_" + kind] += len(part)


def _scalar(x, device):
    """``x`` (float or 0-d tensor) as a float32 0-d tensor on ``device``,
    without a host sync (a fill, or a device-side cast)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


@torch.no_grad()
def _update(optimizer, hp, params, opt_state, grads, rescale, clip, wd,
            use_kernel):
    ps, gs = _tree_leaves(params), _tree_leaves(grads)
    if optimizer == "adam":
        slots = list(zip(_tree_leaves(opt_state["m"]),
                         _tree_leaves(opt_state["v"])))
    elif optimizer == "sgd":
        mom = opt_state.get("mom")
        slots = ([(m,) for m in _tree_leaves(mom)] if mom is not None
                 else [()] * len(ps))
    else:
        raise ValueError("unknown optimizer %r" % optimizer)
    kernel = [use_kernel and _on_cuda(p) and p.dtype == torch.float32
              for p in ps]
    # the kernel's table per device, in tree order
    tables = {}
    for p, g, sl, k in zip(ps, gs, slots, kernel):
        if k:
            # check every kernel leaf and build the library before
            # anything is written: a failure leaves params and state as
            # they were
            _check_leaf(p, [("grad", g)] + [("slot", t) for t in sl])
            if p.numel():
                tables.setdefault(p.device, []).append((p, g, sl))
    if tables:
        _entry(_ENTRY[_kind(optimizer, slots[0])])
    lr = hp["lr"]
    if optimizer == "adam":
        b1, b2 = hp["beta1"], hp["beta2"]
        t = opt_state["t"]
        t.add_(1)
        tf = t.float()
        corr = torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        lr = lr * corr   # the reference's ((lr * corr) * m) association
    for p, g, sl, k in zip(ps, gs, slots, kernel):
        if not k:
            _plain_leaf(optimizer, hp, lr, p, g, sl, rescale, clip, wd)
    for device, leaves in tables.items():
        _launch(optimizer, hp, _scalar(lr, device), leaves, rescale, clip,
                wd)
    return params, opt_state


def fused_update_step(optimizer, hp, params, opt_state, grads, *,
                      rescale=1.0, clip=None, wd=0.0):
    """(params, opt_state) updated IN PLACE from raw ``grads``; returns
    them. The gradient prologue (rescale -> clip -> + wd * weight) is fused
    into the update: one kernel launch over the float32 CUDA leaves, the
    plain expression on the others (see the module docstring). ``hp``
    carries lr and the optimizer's static scalars (momentum / beta1 /
    beta2 / eps)."""
    return _update(optimizer, hp, params, opt_state, grads, rescale, clip,
                   wd, use_kernel=True)


def fused_update_step_plain(optimizer, hp, params, opt_state, grads, *,
                            rescale=1.0, clip=None, wd=0.0):
    """The plain PyTorch version of :func:`fused_update_step` on every
    leaf (the JAX package's lax tier, L194-238), in place; launches
    nothing."""
    return _update(optimizer, hp, params, opt_state, grads, rescale, clip,
                   wd, use_kernel=False)


# --- byte accounting -------------------------------------------------------

def _opt_rw_counts(optimizer, opt_state):
    """(reads, writes) of p-sized operands per update sweep."""
    if optimizer == "adam":
        return 4, 3              # r: p,g,m,v  w: p,m,v
    mom = (opt_state or {}).get("mom") if optimizer == "sgd" else None
    if mom:
        return 3, 2              # r: p,g,mom  w: p,mom
    return 2, 1                  # r: p,g      w: p


def _leaf_bytes(leaf):
    return math.prod(leaf.shape) * leaf.element_size()


def optupdate_ideal_bytes(optimizer, params, opt_state=None):
    """Roofline floor of one update sweep: the bytes that must cross device
    memory — read p + g (+ slots), write p (+ slots)."""
    r, w = _opt_rw_counts(optimizer, opt_state)
    return int((r + w) * sum(_leaf_bytes(v) for v in _tree_leaves(params)))


def optupdate_kernel_bytes(optimizer, params, opt_state=None):
    """Device-memory traffic of the kernel's launches: one pass over each
    float32 leaf plus the 4-byte lr scalar each launch reads (one launch
    per ``_MAX_LEAVES`` nonempty float32 leaves; the GPU's launch
    arithmetic: no 512-row blocks, so nothing is re-read); other leaves
    are counted at the plain expression's floor, the same read/write
    sweep."""
    r, w = _opt_rw_counts(optimizer, opt_state)
    leaves = _tree_leaves(params)
    table = sum(1 for v in leaves
                if v.dtype == torch.float32 and v.numel())
    return int(sum((r + w) * _leaf_bytes(v) for v in leaves)
               + 4 * -(-table // _MAX_LEAVES))
