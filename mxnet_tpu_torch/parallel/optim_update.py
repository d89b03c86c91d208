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

The ZeRO form ``apply_update_sharded`` arrives with distribution (ROADMAP
A10).
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
                         "(distribution, ROADMAP A10)")
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


@torch.no_grad()
def apply_update(optimizer, hp, params, opt_state, grads):
    """(params, opt_state) updated IN PLACE from ``grads``; returns them.

    hp: dict with lr and, per optimizer, momentum / beta1 / beta2 / eps.
    Weight decay and clipping are the caller's concern."""
    lr = hp["lr"]
    ps, gs = tree_leaves(params), tree_leaves(grads)
    if optimizer == "adam":
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
        t = opt_state["t"]
        t.add_(1)
        tf = t.float()
        corr = torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        lc = lr * corr
        for p, m, v, g in zip(ps, tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"]), gs):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lc * m / (torch.sqrt(v) + eps))
        return params, opt_state
    if optimizer == "sgd":
        momentum = hp.get("momentum", 0.0)
        if opt_state["mom"] is not None:
            for p, mo, g in zip(ps, tree_leaves(opt_state["mom"]), gs):
                mo.mul_(momentum).sub_(lr * g)
                p.add_(mo)
            return params, opt_state
        for p, g in zip(ps, gs):
            p.sub_(lr * g)
        return params, opt_state
    raise ValueError("unknown optimizer %r" % optimizer)
