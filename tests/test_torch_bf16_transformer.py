"""The bf16 transformer in the port held against the JAX package on the
CPU: serving through the decode bodies and ``DecodeEngine``, and one
``ShardedTrainStep``.

Small model: vocab 64, 2 layers, 2 heads, d_model 64, max_len 64, block_k
16, every param a seeded numpy draw rounded to bf16 once and handed to
both packages. The JAX side runs its flash kernels in interpret mode (its
lax tier's scan refuses the float32 carry bf16 attention produces, ROADMAP
C); the port runs its kernels' CPU path, the plain bf16 versions. The JAX
engine keeps float32 pages holding the bf16 K and V; the port's pages take
the params' dtype, bf16.

- Serving: one prefill chunk and one batched step through both packages'
  bodies, pages within ``PAGE_ULPS`` bf16 ulps of each page's largest
  magnitude (the JAX attention reads its float32 pages in float32: it
  does not round p to bf16, and its step runs the second layer in
  float32, so the second layer's K and V sit a few ulps off); the engines'
  streams agree token for token except where the float32 logits of the
  same weights have a top-2 margin within ``MARGIN_ULPS`` bf16 ulps of the
  top logit (a tie at bf16's resolution, which the JAX step's float32
  attention and the port's bf16 one may break either way), and the port's
  batched streams equal its solo streams bit for bit.
- Training: the loss and gradients of one batch, also through the grid
  (split-KV) attention kernels at 64 tokens; one step of
  ``ShardedTrainStep`` (Adam, grad_clip 1.0; SGD
  with momentum) from the same bf16 params and batch. The dtypes each
  step leaves are pinned as read from the JAX run: Adam returns float32
  params and float32 m and v (its float32 corr and clip scale promote
  them), SGD-momentum keeps bf16. Loss within ``LOSS_RTOL``; gradients of
  one loss within ``GRAD_TOL`` of each leaf's max abs (bf16 rounds every
  intermediate, in other places in the two frameworks: about 8 bf16 ulps
  of the leaf's scale); SGD's post-step params within ``PARAM_TOL`` of
  each leaf's max abs. Adam's first step is ``lr * sign(g)`` up to eps,
  so where a gradient sits within bf16 noise of 0 the two steps go
  opposite ways: every element within ``2 lr`` of the reference and at
  most ``ADAM_FLIPS`` of a leaf's elements farther than ``lr / 10``.
  Where the JAX step's second Adam step raises (its layer scan's carry
  turns float32), the port's trains on with float32 masters.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mxnet_tpu.parallel.sharded_step import ShardedTrainStep as JaxStep
from mxnet_tpu.serving import DecodeEngine as JaxDecodeEngine

from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import ShardedTrainStep
from mxnet_tpu_torch.serving import DecodeEngine

jt = importlib.import_module("mxnet_tpu.models.transformer")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAGE_ULPS = 4.0
ADAM_FLIPS = 0.02
MARGIN_ULPS = 2.0
LOSS_RTOL = 1e-2
GRAD_TOL = 3e-2
PARAM_TOL = 1e-2
TIER = "MXNET_TPU_MESH_KERNEL_TIER"
KW = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=64, max_len=64,
          block_k=16)
PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3], [8, 9, 7, 9, 3, 2],
           [2, 7, 1, 8, 2, 8], [1], [4, 4, 4, 4]]
BUDGETS = [6, 9, 4, 12, 7, 10, 5]


def _ulp(x):
    top = float(np.abs(x).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def models():
    """(jcfg, tcfg, jparams, tparams): one seeded numpy draw in the JAX
    init's structure (norm scales near 1), rounded to bf16 once."""
    jcfg = jt.TransformerConfig(**KW, dtype=jnp.bfloat16)
    tcfg = tt.TransformerConfig(**KW, dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    shapes = jax.tree_util.tree_map(np.shape, jt.init_transformer(
        jcfg, jax.random.PRNGKey(0)))

    def draw(path, shape):
        x = 0.05 * rng.standard_normal(shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            x = x + 1.0
        return torch.from_numpy(x).to(torch.bfloat16)
    tparams = jax.tree_util.tree_map_with_path(
        draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
        tparams)
    return jcfg, tcfg, jparams, tparams


def test_bf16_prefill_and_step_match_jax(models):
    """A 12-token prompt as a 16-token chunk, then one step with an
    inactive row: the K/V pages both packages write, and the tokens."""
    jcfg, tcfg, jparams, tparams = models
    nb, bs, mb = 8, 16, 2
    jk = jnp.zeros((nb, bs, 2, 64), jnp.float32)
    jv = jnp.zeros_like(jk)
    tk = torch.zeros((nb, bs, 2, 64), dtype=torch.bfloat16)
    tv = torch.zeros_like(tk)
    toks = np.zeros(16, np.int32)
    toks[:12] = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    table = np.array([3, 5], np.int32)
    jtok, jk, jv = jax.jit(lambda p, *a: jt.transformer_decode_prefill(
        p, jcfg, *a, use_pallas=False, interpret=True))(
            jparams, jk, jv, toks, np.int32(0), np.int32(12), table)
    ttok, tk, tv = tt.transformer_decode_prefill(
        tparams, tcfg, tk, tv, torch.from_numpy(toks.astype(np.int64)),
        torch.tensor(0), torch.tensor(12),
        torch.from_numpy(table.astype(np.int64)), use_kernel=True)
    assert tk.dtype == torch.bfloat16 and jk.dtype == jnp.float32
    for got, want in ((tk, jk), (tv, jv)):
        want = np.asarray(want)[1:]
        err = np.abs(_np(got)[1:] - want).max() / _ulp(want)
        assert err <= PAGE_ULPS, err
    assert int(ttok) == int(jtok)
    ids = np.array([int(jtok), 0], np.int32)
    pos = np.array([12, 0], np.int32)
    tabs = np.array([table, [0, 0]], np.int32)
    active = np.array([True, False])
    jids, jk, jv = jax.jit(lambda p, *a: jt.transformer_decode_step(
        p, jcfg, *a))(jparams, jk, jv, ids, pos, tabs, active)
    tids, tk, tv = tt.transformer_decode_step(
        tparams, tcfg, tk, tv, *(torch.from_numpy(x.astype(np.int64))
                                 for x in (ids, pos, tabs)),
        torch.from_numpy(active))
    assert int(tids[0]) == int(jids[0])
    for got, want in ((tk, jk), (tv, jv)):
        want = np.asarray(want)[1:]
        err = np.abs(_np(got)[1:] - want).max() / _ulp(want)
        assert err <= PAGE_ULPS, err


def test_bf16_engines_agree_across_frameworks(models):
    jcfg, tcfg, jparams, tparams = models
    jmodel = jt.TransformerDecodeModel(jcfg, params=jparams,
                                       flash="interpret")
    jeng = JaxDecodeEngine(jmodel.params, name="jbf", num_blocks=64,
                           batch_size=3, max_seq_len=64,
                           prefill_buckets=(16,), kv_shape=jmodel.kv_shape,
                           prefill_fn=jmodel.prefill_fn,
                           step_fn=jmodel.step_fn)
    jout = [s.result_wait(120.0) for s in [
        jeng.submit(p, max_new_tokens=m) for p, m in zip(PROMPTS, BUDGETS)]]
    jeng.stop()
    model = tt.TransformerDecodeModel(tcfg, params=tparams, device="cpu")
    model.use_kernel = True     # the kernel tier's CPU path: plain #1
    teng = DecodeEngine(name="tbf", num_blocks=64, batch_size=3,
                        max_seq_len=64, prefill_buckets=(16,),
                        **model.engine_kwargs())
    assert teng._k_pages.dtype == torch.bfloat16
    tout = [s.result_wait(60.0) for s in [
        teng.submit(p, max_new_tokens=m) for p, m in zip(PROMPTS, BUDGETS)]]
    solo = [teng.generate(p, max_new_tokens=m, timeout=60.0)
            for p, m in zip(PROMPTS, BUDGETS)]
    teng.stop()
    assert solo == tout, "batched bf16 streams must equal solo streams"
    agreed = 0
    f32cfg = tt.TransformerConfig(**KW)
    f32params = jax.tree_util.tree_map(lambda t: t.float(), tparams)
    for prompt, a, b in zip(PROMPTS, jout, tout):
        logits = tt.transformer_forward(
            f32params, torch.tensor([prompt + b[:-1]]), f32cfg)[0]
        logits = logits[len(prompt) - 1:]
        diverge = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       None)
        if diverge is None:
            agreed += 1
            continue
        top2 = logits[diverge].topk(2).values
        margin = (top2[0] - top2[1]).item()
        assert margin <= MARGIN_ULPS * _ulp(top2[0].item()), (
            "prompt %s: JAX %s vs port %s diverge at %d, top-2 margin %g"
            % (prompt, a, b, diverge, margin))
    assert agreed >= len(PROMPTS) - 1


def _batch(seed, b=2, s=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, KW["vocab_size"], (b, s + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[0, :3] = -1
    return toks[:, :-1], targets


def _err(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("variant,seq", [("stream", 16), ("grid", 64)])
def test_bf16_loss_and_grads_match_jax(models, monkeypatch, variant, seq):
    """The loss and gradients of one batch. ``"grid"``: the long-context
    variant at the model's max_len, 64 tokens, so its 16-key blocks are
    several key splits (the JAX grid kernels' 4 blocks, the port's 32-key
    split unit: 2 splits)."""
    jcfg, tcfg, jparams, tparams = models
    jcfg = jt.TransformerConfig(**KW, dtype=jnp.bfloat16,
                                attn_variant=variant)
    tcfg = tt.TransformerConfig(**KW, dtype=torch.bfloat16,
                                attn_variant=variant)
    tokens, targets = _batch(1, s=seq)
    monkeypatch.setenv(TIER, "interpret")
    ref_loss, ref_grads = jax.value_and_grad(jt.transformer_loss)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    monkeypatch.delenv(TIER)
    monkeypatch.setattr("mxnet_tpu_torch.kernels.flash_attention."
                        "resolve_kernel_tier", lambda mode, device: True)
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                tparams)
    loss = tt.transformer_loss(tp, torch.from_numpy(tokens),
                               torch.from_numpy(targets), tcfg)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * float(ref_loss)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref_grads),
                            jax.tree_util.tree_leaves(tp)):
        assert g.grad.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        assert _err(g.grad, r) <= GRAD_TOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("opt", ["adam", "sgd_momentum"])
def test_bf16_sharded_step_matches_jax(models, monkeypatch, opt):
    jcfg, tcfg, jparams, tparams = models
    kw = (dict(optimizer="adam", lr=1e-2, grad_clip=1.0) if opt == "adam"
          else dict(optimizer="sgd", lr=0.1, momentum=0.9))
    tokens, targets = _batch(2)
    batch = {"tokens": tokens, "targets": targets}
    monkeypatch.setenv(TIER, "interpret")
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jstep = JaxStep(
        lambda p, b: jt.transformer_loss(p, b["tokens"], b["targets"], jcfg,
                                         mesh=None),
        mesh, jax.tree_util.tree_map(lambda _: P(), jparams), **kw)
    jstep.init(jax.tree_util.tree_map(jnp.array, jparams))
    ref_loss = float(jstep(batch))
    ref_params = jax.tree_util.tree_map(np.asarray, jstep.params)
    want = jnp.float32 if opt == "adam" else jnp.bfloat16
    assert {x.dtype for x in jax.tree_util.tree_leaves(jstep.params)} \
        == {np.dtype(want)}
    slots = jstep.opt_state["m" if opt == "adam" else "mom"]
    assert {x.dtype for x in jax.tree_util.tree_leaves(slots)} \
        == {np.dtype(want)}
    if opt == "adam":
        # the reference's second step: its layer scan refuses the float32
        # params its first step returned
        with pytest.raises(TypeError, match="carry"):
            jstep(batch)
    monkeypatch.delenv(TIER)

    monkeypatch.setattr("mxnet_tpu_torch.kernels.flash_attention."
                        "resolve_kernel_tier", lambda mode, device: True)
    step = ShardedTrainStep(
        lambda p, b: tt.transformer_loss(p, b["tokens"], b["targets"], tcfg),
        **kw, device="cpu").init(tparams)
    loss = step(batch).item()
    assert abs(loss - ref_loss) <= LOSS_RTOL * ref_loss
    tdt = torch.float32 if opt == "adam" else torch.bfloat16
    leaves = jax.tree_util.tree_leaves(step.params)
    assert {t.dtype for t in leaves} == {tdt}
    assert all(t.requires_grad for t in leaves)
    tslots = step.opt_state["m" if opt == "adam" else "mom"]
    assert {t.dtype for t in jax.tree_util.tree_leaves(tslots)} == {tdt}
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref_params),
                            leaves):
        where = jax.tree_util.keystr(path)
        if opt == "sgd_momentum":
            assert _err(g, r) <= PARAM_TOL, where
            continue
        diff = np.abs(_np(g) - _np(r))
        assert diff.max() <= 2 * kw["lr"] * (1 + 1e-3), where
        assert (diff > kw["lr"] / 10).mean() <= ADAM_FLIPS, where
    # the port trains on: float32 masters, the forward in bf16
    second = step(batch).item()
    assert math.isfinite(second) and second < loss
