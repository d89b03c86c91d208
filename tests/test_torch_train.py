"""The port's training slice held against the JAX package's on the CPU.

- ``transformer_forward`` / ``transformer_loss`` and their gradients
  against ``jax.value_and_grad`` of the JAX loss with
  MXNET_TPU_MESH_KERNEL_TIER=interpret (the Pallas flash kernels in
  interpret mode), ``remat`` on and off, targets containing -1. The port
  runs its plain tier (``blockwise_attention`` differentiated by
  autograd) and, in a second case, its kernel tier's autograd Function,
  which runs the kernels' plain versions on CPU tensors; a third case
  builds both models with ``attn_variant="grid"`` (the JAX grid kernels
  in interpret mode against the port's split-KV plain versions).
- ``grad_prologue`` (rescale -> clip -> + wd * weight) against the JAX
  one on a flat dict with out-of-range and non-finite entries.
- Three steps of the port's ``ShardedTrainStep`` (Adam with
  ``grad_clip=1.0``; SGD with momentum and ``wd``) against the JAX
  ``ShardedTrainStep`` on a one-device CPU mesh, whose loss is called
  with ``mesh=None`` so both run the same attention path.

Small model: 2 layers, d_model 32, 2 heads, sequence 16, attention
blocks of 8. Params and batches come from numpy seeds; params move to
the port with ``params_from_jax``.

Tolerance: float32 on both sides in another order of summation — 1e-5
for forward values (logits, loss), 1e-4 relative / 1e-5 absolute for
gradients and post-step params.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mxnet_tpu.models import transformer as jtr
from mxnet_tpu.parallel import optim_update as jou
from mxnet_tpu.parallel.sharded_step import ShardedTrainStep as JaxStep

from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.models import transformer as ttr
from mxnet_tpu_torch.parallel import ShardedTrainStep, grad_prologue

# float32 stays float32 (matters on a card, where cuBLAS may use TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TIER = "MXNET_TPU_MESH_KERNEL_TIER"
V, L, H, DM, S, B = 61, 2, 2, 32, 16, 2


def _cfgs(remat=False, dropout=0.0, variant="stream"):
    kw = dict(vocab_size=V, num_layers=L, num_heads=H, d_model=DM,
              max_len=S, block_k=8, remat=remat, dropout=dropout,
              attn_variant=variant)
    return jtr.TransformerConfig(**kw), ttr.TransformerConfig(**kw)


def _np_params(seed):
    """The JAX init's structure with every leaf drawn from numpy: scales
    near 1, everything else small and nonzero, so every gradient is."""
    jcfg, _ = _cfgs()
    shapes = jax.tree_util.tree_map(np.shape, jtr.init_transformer(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)

    def draw(path, shape):
        x = 0.05 * rng.standard_normal(shape).astype(np.float32)
        return x + 1.0 if "scale" in jax.tree_util.keystr(path) else x
    return jax.tree_util.tree_map_with_path(draw, shapes,
                                            is_leaf=lambda x: isinstance(
                                                x, tuple))


def _batch(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[0, :3] = -1          # ignored positions
    targets[1, -2:] = -1
    return toks[:, :-1], targets


def _jax_loss_and_grads(monkeypatch, params, tokens, targets, remat,
                        variant="stream"):
    jcfg, _ = _cfgs(remat=remat, variant=variant)
    monkeypatch.setenv(TIER, "interpret")
    loss, grads = jax.value_and_grad(jtr.transformer_loss)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens),
        jnp.asarray(targets), jcfg)
    monkeypatch.delenv(TIER)
    return loss, grads


def _flat(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_transformer_forward_matches_jax(monkeypatch):
    params = _np_params(0)
    tokens, _ = _batch(1)
    jcfg, tcfg = _cfgs()
    monkeypatch.setenv(TIER, "interpret")
    ref = jtr.transformer_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(tokens), jcfg)
    monkeypatch.delenv(TIER)
    got = ttr.transformer_forward(ttr.params_from_jax(params, "cpu"),
                                  torch.from_numpy(tokens), tcfg)
    assert got.shape == (B, S, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("tier", ["plain", "function", "grid"])
def test_transformer_loss_and_grads_match_jax(monkeypatch, remat, tier):
    """``grid``: both configs with ``attn_variant="grid"`` (the JAX side
    runs its grid kernels in interpret mode, the port the grid kernel
    tier's Function, whose CPU path is the grid kernels' plain
    versions)."""
    params = _np_params(2)
    tokens, targets = _batch(3)
    variant = "grid" if tier == "grid" else "stream"
    ref_loss, ref_grads = _jax_loss_and_grads(monkeypatch, params, tokens,
                                              targets, remat, variant)
    if tier != "plain":
        # the kernel tier's autograd Function; on CPU tensors it runs the
        # kernels' plain versions (forward and the written-out backward)
        monkeypatch.setattr(tfa, "resolve_kernel_tier",
                            lambda mode, device: True)
    _, tcfg = _cfgs(remat=remat, variant=variant)
    tp = ttr.params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(tp)]
    loss = ttr.transformer_loss(tp, torch.from_numpy(tokens),
                                torch.from_numpy(targets), tcfg)
    if tier != "plain":
        assert "_FlashAttentionBackward" in str(_grad_fns(loss))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **FWD_TOL)
    got = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tp), [t.grad.numpy() for t in leaves])
    for (path, g), (_, r) in zip(_flat(got), _flat(ref_grads)):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(path),
                                   **GRAD_TOL)


def _grad_fns(t):
    """Names of the autograd nodes below ``t``."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


@pytest.mark.parametrize("opt", ["adam", "sgd_momentum_wd"])
def test_sharded_train_step_matches_jax(monkeypatch, opt):
    params = _np_params(4)
    batches = [_batch(10 + i) for i in range(3)]
    jcfg, tcfg = _cfgs()
    kw = (dict(optimizer="adam", lr=1e-2, grad_clip=1.0) if opt == "adam"
          else dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-2))

    monkeypatch.setenv(TIER, "interpret")
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jstep = JaxStep(
        lambda p, b: jtr.transformer_loss(p, b["tokens"], b["targets"], jcfg,
                                          mesh=None),
        mesh, jax.tree_util.tree_map(lambda _: P(), params), **kw)
    jstep.init(jax.tree_util.tree_map(jnp.asarray, params))
    ref_losses = [float(jstep({"tokens": t, "targets": y}))
                  for t, y in batches]
    ref_params = jax.tree_util.tree_map(np.asarray, jstep.params)
    monkeypatch.delenv(TIER)

    step = ShardedTrainStep(
        lambda p, b: ttr.transformer_loss(p, b["tokens"], b["targets"], tcfg),
        **kw, device="cpu").init(ttr.params_from_jax(params, "cpu"))
    losses = [step({"tokens": t, "targets": y}).item() for t, y in batches]
    np.testing.assert_allclose(losses, ref_losses, **FWD_TOL)
    assert step.step_count == 3 and step.program_count() == 1
    got = jax.tree_util.tree_map(lambda t: t.detach().numpy(), step.params)
    for (path, g), (_, r) in zip(_flat(got), _flat(ref_params)):
        np.testing.assert_allclose(g, r, err_msg=str(path), **GRAD_TOL)


def test_sharded_train_step_skips_nonfinite():
    """A step whose loss is not finite leaves params and Adam's slots
    (step count included) as they were, and says so in last_good."""
    params = _np_params(5)
    tokens, targets = _batch(6)
    _, tcfg = _cfgs()
    poison = {"on": False}

    def loss_fn(p, b):
        loss = ttr.transformer_loss(p, b["tokens"], b["targets"], tcfg)
        return loss * float("nan") if poison["on"] else loss
    step = ShardedTrainStep(loss_fn, optimizer="adam", grad_clip=1.0,
                            skip_nonfinite=True, device="cpu")
    step.init(ttr.params_from_jax(params, "cpu"))
    batch = {"tokens": tokens, "targets": targets}
    step(batch)
    assert bool(step.last_good)
    before = [t.detach().clone() for t in jax.tree_util.tree_leaves(
        (step.params, step.opt_state))]
    poison["on"] = True
    step(batch)
    assert not bool(step.last_good)
    after = jax.tree_util.tree_leaves((step.params, step.opt_state))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(step.opt_state["t"]) == 1


def test_dropout_masks_replay_under_remat():
    """With dropout, remat recomputes each block from the same per-layer
    seed: loss and grads equal those without remat. train=False (or no
    rng) runs no dropout."""
    params = _np_params(7)
    tokens, targets = (torch.from_numpy(a) for a in _batch(8))
    results = []
    for remat in (False, True):
        _, tcfg = _cfgs(remat=remat, dropout=0.25)
        tp = ttr.params_from_jax(params, "cpu")
        leaves = [t.requires_grad_(True)
                  for t in jax.tree_util.tree_leaves(tp)]
        loss = ttr.transformer_loss(tp, tokens, targets, tcfg,
                                    rng=torch.Generator().manual_seed(3))
        loss.backward()
        results.append((loss.item(), [t.grad.clone() for t in leaves]))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1],
                                                 results[1][1]))
    _, tcfg = _cfgs(dropout=0.25)
    tp = ttr.params_from_jax(params, "cpu")
    plain = ttr.transformer_loss(tp, tokens, targets, tcfg, train=False,
                                 rng=torch.Generator().manual_seed(3))
    assert plain.item() != results[0][0]
    assert plain.item() == ttr.transformer_loss(tp, tokens, targets,
                                                tcfg).item()



@pytest.mark.parametrize("clip", [None, 0.5])
def test_grad_prologue_matches_jax(clip):
    rng = np.random.RandomState(9)
    params = {n: rng.standard_normal((3, 5)).astype(np.float32)
              for n in ("a", "b")}
    grads = {n: 2.0 * rng.standard_normal((3, 5)).astype(np.float32)
             for n in ("a", "b")}
    grads["b"][0, 0] = np.inf
    ref = jou.grad_prologue(params, grads, rescale=0.25, clip=clip, wd=1e-2)
    got = grad_prologue({n: torch.from_numpy(x) for n, x in params.items()},
                        {n: torch.from_numpy(x) for n, x in grads.items()},
                        rescale=0.25, clip=clip, wd=1e-2)
    for n in params:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(ref[n]),
                                   **FWD_TOL)
