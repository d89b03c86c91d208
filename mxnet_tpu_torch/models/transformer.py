"""Transformer LM decode bodies for the port's DecodeEngine.

Counterpart of ``mxnet_tpu/models/transformer.py``: ``TransformerConfig``,
``init_transformer``, ``params_from_jax``, the training forward and loss
``transformer_forward`` / ``transformer_loss`` (single device; a mesh
raises until distribution is ported, ROADMAP A7), and the paged-KV
decode bodies ``transformer_decode_prefill`` / ``transformer_decode_step``
behind ``TransformerDecodeModel``.

Parameters keep the JAX package's nested dict and layouts (``h @ w`` with
``w`` shaped ``(d_in, d_out)``, per-layer params stacked on axis 0), so
weights move across with no transposes.

KV page layout, as in the JAX package: ``(num_blocks, block_size,
num_layers, d_model)`` for each of K and V; position ``p`` of layer ``l``
lives at ``pages[table[p // bs], p % bs, l]``. Reads mask additively with
-1e30: ``exp(-1e30 - m)`` is exactly 0.0 in float32, so unwritten or
foreign page content never perturbs a real row's bits — what makes chunked
prefill and continuous batching bit-identical to whole-prompt, solo
decode. The bodies update the pages IN PLACE (``index_put_``) and return
them: the eager analog of the JAX engine donating its page buffers.
Duplicate scatter targets only ever fall in the null block (padding rows
and inactive slots), which no real read sees, so which duplicate wins is
harmless.

Index arguments are ``int64`` tensors (torch's index type) on the
model's device; the only host syncs of a request are the engine's reads
of the sampled tokens.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError
from ..context import resolve_device
from ..kernels.flash_attention import (blockwise_attention, flash_attention,
                                       flash_attention_with_lse,
                                       masked_value, resolve_kernel_tier)
from ..parallel import mesh_kernels
from ..serving.kvcache import NULL_BLOCK

__all__ = ["TransformerConfig", "init_transformer", "params_from_jax",
           "transformer_forward", "transformer_loss",
           "transformer_decode_prefill", "transformer_decode_step",
           "TransformerDecodeModel"]


class TransformerConfig:
    """Decoder-only LM config (GPT-style, pre-LN)."""

    def __init__(self, vocab_size, num_layers=2, num_heads=4, d_model=128,
                 d_ff=None, max_len=512, dtype=torch.float32, remat=False,
                 attn_impl="ring", block_k=512, dropout=0.0,
                 attn_variant="stream"):
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.d_model = d_model
        self.d_ff = d_ff or 4 * d_model
        self.max_len = max_len
        self.dtype = dtype
        # torch.utils.checkpoint around each block (jax.checkpoint there)
        self.remat = remat
        # 'ring' | 'ulysses' | 'full': how a mesh's 'sp' axis splits the
        # sequence; read only with a mesh (not yet ported, ROADMAP A7)
        self.attn_impl = attn_impl
        self.block_k = block_k
        self.dropout = dropout
        # attention kernel family: 'stream' or 'grid' (split-KV here; KV
        # as a sequential grid axis in the JAX package)
        self.attn_variant = attn_variant
        assert attn_variant in ("stream", "grid"), attn_variant
        assert d_model % num_heads == 0


def init_transformer(cfg, generator, device):
    """Params dict; layer params stacked on axis 0. Draws from
    ``generator`` on its own device, then moves to ``device``."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    gdev = generator.device

    def norm(*shape):
        t = torch.randn(shape, generator=generator, device=gdev) * 0.02
        return t.to(device=device, dtype=cfg.dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    return {
        "embed": norm(cfg.vocab_size, d),
        "pos_embed": norm(cfg.max_len, d),
        "ln_f_scale": const(1.0, d),
        "ln_f_bias": const(0.0, d),
        "layers": {
            "wq": norm(L, d, d),
            "wk": norm(L, d, d),
            "wv": norm(L, d, d),
            "wo": norm(L, d, d),
            "w1": norm(L, d, f),
            "b1": const(0.0, L, f),
            "w2": norm(L, f, d),
            "b2": const(0.0, L, d),
            "ln1_scale": const(1.0, L, d),
            "ln1_bias": const(0.0, L, d),
            "ln2_scale": const(1.0, L, d),
            "ln2_bias": const(0.0, L, d),
        },
    }


def params_from_jax(np_params, device):
    """The JAX package's nested parameter dict, as numpy arrays, as the
    port's dict of tensors on ``device`` (same keys, same layouts)."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    return torch.from_numpy(_np.array(np_params)).to(device)


def _in_dtype(tree, dtype):
    """Nested dicts of tensors cast to ``dtype`` (no copy where they are
    in it already)."""
    if isinstance(tree, dict):
        return {k: _in_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


class _Rsqrt(torch.autograd.Function):
    """``torch.rsqrt`` whose derivative, -0.5 g rsqrt(x)^3, multiplies g
    by one factor at a time. rsqrt(x)^3 alone (torch's rule) or x^-1.5 (the
    reference's ``lax.rsqrt`` rule, ans / x) is past float16's 65504 for x
    below 6.2e-4, which a layer norm's variance reaches at the model's
    init (ROADMAP C, faults of the reference); the product with g is not.
    Other dtypes see the same derivative to rounding."""

    @staticmethod
    def forward(ctx, x):
        y = torch.rsqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * -0.5 * y * y * y


def _layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * _Rsqrt.apply(var + eps) * scale + bias


def _mlp(x, lp):
    h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    # jax.nn.gelu defaults to the tanh form; torch's default is erf
    h = F.gelu(h @ lp["w1"] + lp["b1"], approximate="tanh")
    return x + (h @ lp["w2"] + lp["b2"])


def _attention(q, k, v, cfg, mesh):
    """[B, H, S, D] causal attention on one device. The tier follows
    MXNET_TPU_MESH_KERNEL_TIER (``parallel.mesh_kernels``): the CUDA
    kernels of ``cfg.attn_variant`` ("stream": forward ``flash_fwd.cu``,
    backward ``flash_bwd_offs.cu``; "grid": ``flash_fwd_grid.cu`` and
    ``flash_bwd_grid.cu``, key splits of ``cfg.block_k``) or the plain
    ``blockwise_attention`` with ``cfg.block_k``."""
    if mesh is not None:
        raise MXNetError("transformer attention over a mesh: distribution "
                         "is not yet ported (ROADMAP A7)")
    use_kernel = mesh_kernels.resolve_kernel_tier(device=q.device)
    return flash_attention(q, k, v, causal=True, block_k=cfg.block_k,
                           use_pallas=use_kernel, variant=cfg.attn_variant)


def _dropout(x, rate, generator):
    """Inverted dropout with an explicit ``torch.Generator`` on x's
    device: keep with probability ``1 - rate`` (uniform < keep, as
    ``jax.random.bernoulli``), scale kept values by ``1 / keep``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _block(x, lp, cfg, mesh, seed=None):
    """One pre-LN decoder block. x: [B, S, D]. ``seed`` (an int) enables
    dropout from a generator seeded with it inside the block, so a
    recomputation under ``remat`` draws the same masks."""
    B, S, d = x.shape
    H, Dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    gen = None
    if seed is not None:
        gen = torch.Generator(device=x.device).manual_seed(seed)
    h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    # contiguous (B, H, S, Dh): the kernels take no strides
    q = (h @ lp["wq"]).reshape(B, S, H, Dh).transpose(1, 2).contiguous()
    k = (h @ lp["wk"]).reshape(B, S, H, Dh).transpose(1, 2).contiguous()
    v = (h @ lp["wv"]).reshape(B, S, H, Dh).transpose(1, 2).contiguous()
    a = _attention(q, k, v, cfg, mesh)
    a = a.transpose(1, 2).reshape(B, S, d) @ lp["wo"]
    if gen is not None:
        a = _dropout(a, cfg.dropout, gen)
    x = x + a
    h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    # jax.nn.gelu defaults to the tanh form
    h = F.gelu(h @ lp["w1"] + lp["b1"], approximate="tanh")
    h = h @ lp["w2"] + lp["b2"]
    if gen is not None:
        h = _dropout(h, cfg.dropout, gen)
    return x + h


def transformer_forward(params, tokens, cfg, mesh=None, rng=None,
                        train=False):
    """tokens: [B, S] int tensor -> logits [B, S, vocab].

    A Python loop over the stacked layer params (``lax.scan`` there);
    ``cfg.remat`` wraps each block in ``torch.utils.checkpoint``. Dropout
    runs only when ``train`` and ``cfg.dropout > 0`` and ``rng`` (a
    ``torch.Generator``) is given: each layer draws one seed from ``rng``,
    the analog of the per-layer key split. The JAX package's random bits
    are not reproduced. ``mesh`` must be None (distribution is not yet
    ported, ROADMAP A7).

    Computes in ``cfg.dtype``: every param is cast to it first, a no-op
    for params in it (the JAX forward's case). float32 params of a bf16
    or float16 config, what such a model's first Adam step leaves, are
    float32 masters whose gradients flow back through the cast; the JAX forward
    raises on them (its layer scan's carry changes dtype, ROADMAP C)."""
    if mesh is not None:
        raise MXNetError("transformer_forward(mesh=...): distribution is "
                         "not yet ported (ROADMAP A7)")
    params = _in_dtype(params, cfg.dtype)
    B, S = tokens.shape
    tokens = tokens.long()
    x = params["embed"][tokens].to(cfg.dtype)
    x = x + params["pos_embed"][:S].to(cfg.dtype)
    use_dropout = train and cfg.dropout > 0.0 and rng is not None
    lp_all = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in lp_all.items()}
        seed = None
        if use_dropout:
            seed = int(torch.randint(0, 2 ** 62, (), generator=rng,
                                     device=rng.device))
        if cfg.remat:
            x = checkpoint(_block, x, lp, cfg, mesh, seed,
                           use_reentrant=False)
        else:
            x = _block(x, lp, cfg, mesh, seed)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    return x @ params["embed"].T.to(cfg.dtype)


def transformer_loss(params, tokens, targets, cfg, mesh=None, rng=None,
                     train=True):
    """Mean next-token cross-entropy. targets: [B, S] int (-1 = ignore);
    the mean is over the targets that are not ignored."""
    logits = transformer_forward(params, tokens, cfg, mesh=mesh, rng=rng,
                                 train=train).float()
    targets = targets.long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = targets.clamp(min=0)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    mask = (targets >= 0).float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)


def _decode_attn_prefill(q, ks, vs, start, offs, cfg, use_kernel):
    """Chunk attention over gathered pages. q: (C, H, Dh); ks/vs:
    (T, H, Dh) gathered from the sequence's block table; causal at global
    offset ``start`` (query row i sits at position start + i).

    Kernel tier: the CUDA flash kernel of ``cfg.attn_variant`` with
    ``offs = [start, 0]`` on the device (the kernel reads it; no host round
    trip), given the JAX call's block sizes, which set the grid kernel's
    splits. Plain tier: ``blockwise_attention`` with ``q_offset=start``,
    the same masking."""
    C, H, Dh = q.shape
    T = ks.shape[0]
    sm = 1.0 / math.sqrt(Dh)
    q4 = q.permute(1, 0, 2)[None].contiguous()          # (1, H, C, Dh)
    k4 = ks.permute(1, 0, 2)[None].contiguous()
    v4 = vs.permute(1, 0, 2)[None].contiguous()
    # the JAX call's block sizes, which must tile C and T exactly there
    bq = C if C % min(cfg.block_k, C) else min(cfg.block_k, C)
    bk = T if T % min(cfg.block_k, T) else min(cfg.block_k, T)
    if use_kernel:
        out, _ = flash_attention_with_lse(q4, k4, v4, offs, sm, True, bq, bk,
                                          variant=cfg.attn_variant)
    else:
        out, _ = blockwise_attention(q4, k4, v4, causal=True, sm_scale=sm,
                                     block_k=bk, q_offset=start, k_offset=0)
    return out[0].permute(1, 0, 2)                      # (C, H, Dh)


def transformer_decode_prefill(params, cfg, k_pages, v_pages, tokens,
                               start, length, table, *, use_kernel=False):
    """Bucketed batch-1 prefill chunk: write K/V for global positions
    ``start .. start+length-1`` into the paged cache, return the greedy
    next token after the chunk's last real position.

    ``tokens (C,)``, ``start ()``, ``length ()`` and ``table (MB,)`` are
    int64 tensors on the pages' device. Whole-prompt prefill is the
    ``start=0`` call; chunked prefill calls the same bucket shape again
    with advancing ``start``."""
    C = tokens.shape[0]
    bs = k_pages.shape[1]
    mb = table.shape[0]
    H, Dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    T = mb * bs
    dev = tokens.device
    idx = torch.arange(C, device=dev)
    pos = start + idx
    x = params["embed"][tokens].to(cfg.dtype)
    x = x + params["pos_embed"][pos.clamp(0, cfg.max_len - 1)].to(cfg.dtype)
    tpos = pos.clamp(0, T - 1)
    blk = torch.where(idx < length, table[tpos // bs], NULL_BLOCK)
    slot = tpos % bs
    offs = None
    if use_kernel:
        offs = torch.stack([start, torch.zeros_like(start)]).to(torch.int32)
    lp_all = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in lp_all.items()}
        h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q = (h @ lp["wq"]).reshape(C, H, Dh)
        kl, vl = k_pages[:, :, l], v_pages[:, :, l]     # views of layer l
        kl.index_put_((blk, slot), h @ lp["wk"])
        vl.index_put_((blk, slot), h @ lp["wv"])
        # gather only layer l's pages (indexing the layer first reads the
        # same values as the JAX package's pages[table][:, :, l])
        ks = kl[table].reshape(T, H, Dh)
        vs = vl[table].reshape(T, H, Dh)
        a = _decode_attn_prefill(q, ks, vs, start, offs, cfg, use_kernel)
        x = x + a.reshape(C, cfg.d_model) @ lp["wo"]
        x = _mlp(x, lp)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    last = (length - 1).clamp(0, C - 1).reshape(1)
    x_last = x.index_select(0, last)[0]
    logits = x_last @ params["embed"].T.to(cfg.dtype)
    return torch.argmax(logits), k_pages, v_pages


def transformer_decode_step(params, cfg, k_pages, v_pages, token_ids,
                            positions, tables, active):
    """Fixed-shape batched decode step: one token per active row.

    ``token_ids (B,)``, ``positions (B,)`` and ``tables (B, MB)`` are int64
    tensors, ``active (B,)`` bool. Every per-row contraction runs over
    that row's own gathered blocks only, and the batch shape never
    changes, so the same matmul algorithm serves a row solo or batched:
    batched decode stays bit-identical to solo decode. Plain PyTorch by
    design, as in the JAX package: a 1-token query per row at per-row
    lengths is no flash-kernel shape."""
    B, mb = tables.shape
    bs = k_pages.shape[1]
    H, Dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    T = mb * bs
    sm = 1.0 / math.sqrt(Dh)
    dev = token_ids.device
    x = params["embed"][token_ids].to(cfg.dtype)
    x = x + params["pos_embed"][positions.clamp(0, cfg.max_len - 1)] \
        .to(cfg.dtype)
    blk = torch.gather(tables, 1, (positions // bs)[:, None])[:, 0]
    blk = torch.where(active, blk, NULL_BLOCK)
    slot = positions % bs
    visible = torch.arange(T, device=dev)[None, None, :] \
        <= positions[:, None, None]
    lp_all = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in lp_all.items()}
        h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q = (h @ lp["wq"]).reshape(B, H, Dh)
        kl, vl = k_pages[:, :, l], v_pages[:, :, l]
        kl.index_put_((blk, slot), h @ lp["wk"])
        vl.index_put_((blk, slot), h @ lp["wv"])
        ks = kl[tables].reshape(B, T, H, Dh)
        vs = vl[tables].reshape(B, T, H, Dh)
        scores = torch.einsum("bhd,bthd->bht", q, ks) * sm
        scores = torch.where(visible, scores, masked_value(scores.dtype))
        w = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bht,bthd->bhd", w, vs).reshape(B, cfg.d_model)
        x = x + ctx @ lp["wo"]
        x = _mlp(x, lp)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    logits = x @ params["embed"].T.to(cfg.dtype)
    return torch.argmax(logits, dim=-1), k_pages, v_pages


class TransformerDecodeModel:
    """Adapter: a multi-layer TransformerConfig wired for the DecodeEngine.

    >>> model = TransformerDecodeModel(TransformerConfig(vocab_size=256,
    ...     num_layers=2, num_heads=4, d_model=64, max_len=128))
    >>> eng = DecodeEngine(max_seq_len=128, **model.engine_kwargs())

    ``device=None`` means ``cuda:0`` and raises ``MXNetError`` when CUDA
    is missing. ``flash`` picks the prefill attention tier (the step is
    always plain): None reads ``MXNET_SERVING_DECODE_FLASH`` (auto | 1/on
    | 0/off, see ``kernels.flash_attention.resolve_kernel_tier``). Params
    default to ``init_transformer`` from a CPU ``torch.Generator`` seeded
    with ``seed``, so every process derives the same model."""

    def __init__(self, cfg, params=None, seed=0, flash=None, device=None):
        from ..base import get_env
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(int(seed))
            params = init_transformer(cfg, gen, self.device)
        self.params = params
        mode = flash if flash is not None else get_env(
            "MXNET_SERVING_DECODE_FLASH", "auto")
        self.use_kernel = resolve_kernel_tier(mode, self.device)
        self.flash_engaged = self.use_kernel

    @property
    def kv_shape(self):
        """Trailing page dims: (num_layers, d_model)."""
        return (self.cfg.num_layers, self.cfg.d_model)

    def prefill_fn(self, params, k_pages, v_pages, tokens, start, length,
                   table):
        return transformer_decode_prefill(
            params, self.cfg, k_pages, v_pages, tokens, start, length,
            table, use_kernel=self.use_kernel)

    def step_fn(self, params, k_pages, v_pages, token_ids, positions,
                tables, active):
        return transformer_decode_step(params, self.cfg, k_pages, v_pages,
                                       token_ids, positions, tables, active)

    def engine_kwargs(self):
        """kwargs bundle for DecodeEngine(**model.engine_kwargs(), ...)."""
        return {"params": self.params, "kv_shape": self.kv_shape,
                "prefill_fn": self.prefill_fn, "step_fn": self.step_fn,
                "device": self.device}
