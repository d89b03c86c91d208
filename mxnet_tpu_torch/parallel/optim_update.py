"""Tree-level optimizer updates of the train step.

Counterpart of ``mxnet_tpu/parallel/optim_update.py`` for the replicated
layout (``layout=None``). Parameters and slots are nested dicts of
tensors, as in the JAX package. Where JAX returns fresh arrays and the
jitted step donates the old ones, the port updates params and slots IN
PLACE under ``torch.no_grad()`` — the eager analog of donation — and
returns the same objects. The arithmetic keeps the JAX expressions and
their association, so the in-place result equals the functional one:
``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``,
``corr = sqrt(1-b2^t)/(1-b1^t)`` in float32 on the device (no host sync),
then ``p - lr*corr*m/(sqrt(v)+eps)``.

Leaves that are not all float32 (a bf16 or float16 model's params, slots
and grads) take jnp's promotion, which the JAX expressions carry: Python
scalars are weak, a float32 array is not, so Adam's ``lr * corr`` (corr a
float32 array) makes ``p`` float32, ``m`` and ``v`` take ``promote(slot,
g)``, and SGD's ``p`` takes ``promote(p, g)``. Where the promoted dtype
is the leaf's own the update stays in place; where it differs the leaf's
dict entry is rebound to the new tensor (keeping ``requires_grad``), as
the JAX step returns it. ``_jnp_cast`` gives the port's other
float32-scalar products (the step's clip scale) the same promotion.

The ZeRO form ``apply_update_sharded`` arrives with distribution (ROADMAP
A7 part 3).
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["init_opt_state", "apply_update", "grad_prologue", "tree_map",
           "tree_leaves"]


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts (sorted keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree):
    """Leaves of nested dicts in sorted-key order (``jax.tree_util``'s
    order for dicts), ``None`` dropped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def init_opt_state(optimizer, params, momentum=0.0, layout=None):
    """Optimizer state for 'sgd' (momentum optional) or 'adam'; adam's
    step ``t`` is an int32 0-d tensor on the params' device."""
    if layout is not None:
        raise MXNetError("init_opt_state: the ZeRO layout is not yet ported "
                         "(distribution, ROADMAP A7 part 3)")
    if optimizer == "adam":
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}
    if optimizer == "sgd":
        if not momentum:
            return {"mom": None}
        return {"mom": tree_map(torch.zeros_like, params)}
    raise ValueError("unknown optimizer %r" % optimizer)


def grad_prologue(params, grads, rescale=1.0, clip=None, wd=0.0):
    """Reference optimizer order (optimizer_op.cc): rescale -> clip ->
    + wd*weight, over a flat ``{name: tensor}`` dict, as in the JAX
    package. Returns fresh tensors."""
    grads = {n: g * rescale for n, g in grads.items()}
    if clip is not None:
        grads = {n: torch.clamp(g, -clip, clip) for n, g in grads.items()}
    # unconditional, as in the JAX package: `g + 0.0*p` and `g` differ in
    # the non-finite edge cases
    return {n: g + wd * params[n] for n, g in grads.items()}


def _slots(tree):
    """(dict, key) of every leaf of nested dicts, in :func:`tree_leaves`'
    order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _slots(v)
        elif v is not None:
            out.append((tree, k))
    return out


def _store(slot, new):
    """``new`` into the leaf at ``slot``: in place when the dtype stays,
    else the dict entry is rebound (keeping ``requires_grad``)."""
    tree, key = slot
    old = tree[key]
    if new.dtype == old.dtype:
        old.copy_(new)
    else:
        tree[key] = new.detach().requires_grad_(old.requires_grad)


def _jnp_cast(x, scalar):
    """``x`` in the dtype jnp gives ``x * scalar`` when ``scalar`` is a
    float32 array (torch keeps a 0-d tensor out of the promotion)."""
    return x.to(torch.promote_types(x.dtype, scalar.dtype))


@torch.no_grad()
def apply_update(optimizer, hp, params, opt_state, grads, verdict=None):
    """(params, opt_state) updated IN PLACE from ``grads``; returns them.
    A leaf whose dtype jnp's promotion changes is rebound instead (see
    the module docstring).

    hp: dict with lr and, per optimizer, momentum / beta1 / beta2 / eps.
    Weight decay and clipping are the caller's concern. ``verdict`` (a
    0-d bool tensor) keeps the update only where it holds: every leaf of
    params and opt_state, Adam's ``t`` included, is as it was after a
    false one (the reference's ``jnp.where`` carry, leaf by leaf)."""
    if verdict is None:
        return _apply_update(optimizer, hp, params, opt_state, grads)
    old = [x.clone() for x in tree_leaves(params) + tree_leaves(opt_state)]
    _apply_update(optimizer, hp, params, opt_state, grads)
    for new, prev in zip(tree_leaves(params) + tree_leaves(opt_state), old):
        new.copy_(torch.where(verdict, new, prev.to(new.dtype)))
    return params, opt_state


def _apply_update(optimizer, hp, params, opt_state, grads):
    lr = hp["lr"]
    f32 = torch.float32
    ps, gs = _slots(params), tree_leaves(grads)
    if optimizer == "adam":
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
        t = opt_state["t"]
        t.add_(1)
        tf = t.float()
        corr = torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        lc = lr * corr
        for sp, sm, sv, g in zip(ps, _slots(opt_state["m"]),
                                 _slots(opt_state["v"]), gs):
            p, m, v = sp[0][sp[1]], sm[0][sm[1]], sv[0][sv[1]]
            if p.dtype == m.dtype == v.dtype == g.dtype == f32:
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lc * m / (torch.sqrt(v) + eps))
                continue
            gm = g.to(torch.promote_types(m.dtype, g.dtype))
            gv = g.to(torch.promote_types(v.dtype, g.dtype))
            m = b1 * m.to(gm.dtype) + (1 - b1) * gm
            v = b2 * v.to(gv.dtype) + (1 - b2) * gv * gv
            step = lc * _jnp_cast(m, lc) / _jnp_cast(torch.sqrt(v) + eps, lc)
            _store(sm, m)
            _store(sv, v)
            _store(sp, _jnp_cast(p, lc) - step)
        return params, opt_state
    if optimizer == "sgd":
        momentum = hp.get("momentum", 0.0)
        if opt_state["mom"] is not None:
            for sp, so, g in zip(ps, _slots(opt_state["mom"]), gs):
                p, mo = sp[0][sp[1]], so[0][so[1]]
                if p.dtype == mo.dtype == g.dtype == f32:
                    mo.mul_(momentum).sub_(lr * g)
                    p.add_(mo)
                    continue
                mo = _jnp_cast(mo, g)
                mo = momentum * mo - lr * g.to(mo.dtype)
                _store(so, mo)
                _store(sp, _jnp_cast(p, mo) + mo)
            return params, opt_state
        for sp, g in zip(ps, gs):
            p = sp[0][sp[1]]
            if p.dtype == g.dtype == f32:
                p.sub_(lr * g)
                continue
            _store(sp, _jnp_cast(p, g) - lr * g)
        return params, opt_state
    raise ValueError("unknown optimizer %r" % optimizer)
