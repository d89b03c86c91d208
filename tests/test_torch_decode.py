"""The port's decode serving (mxnet_tpu_torch/models/transformer.py and
serving/decode.py) held against the JAX package on identical inputs, on
the CPU, at the small config of tests/python/unittest/test_decode.py
(vocab 64, 2 layers, 4 heads, d_model 32, max_len 64, block_k 16).

Tolerance: float32, 1e-5 absolute and relative for pages (same
arithmetic, different summation order); sampled tokens must be equal.
Across frameworks a token may differ only where the top-2 logit margin is
below MARGIN_TOL, so a near-tie cannot pass as agreement silently: the
test reports the smallest margin it compared.
"""
import importlib
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.serving import DecodeEngine as JaxDecodeEngine
from mxnet_tpu.serving import tiny_lm_params as jax_tiny_lm_params

from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.serving import DecodeEngine, tiny_lm_params
from mxnet_tpu_torch.serving import decode as tdecode

jt = importlib.import_module("mxnet_tpu.models.transformer")
jdecode = importlib.import_module("mxnet_tpu.serving.decode")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = ATOL = 1e-5
MARGIN_TOL = 1e-4
CPU = torch.device("cpu")

PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3], [8, 9, 7, 9, 3, 2],
           [2, 7, 1, 8, 2, 8], [1], [4, 4, 4, 4]]
BUDGETS = [6, 9, 4, 12, 7, 10, 5]


def _configs():
    kw = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32,
              max_len=64, block_k=16)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _np_params(cfg, seed=0):
    """Params in the JAX package's layout, from a numpy RandomState, with
    non-trivial norm scales and biases so every parameter is exercised."""
    rng = np.random.RandomState(seed)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers

    def rand(*shape, loc=0.0, scale=0.02):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": rand(cfg.vocab_size, d), "pos_embed": rand(cfg.max_len, d),
        "ln_f_scale": rand(d, loc=1.0, scale=0.1), "ln_f_bias": rand(d),
        "layers": {
            "wq": rand(L, d, d), "wk": rand(L, d, d), "wv": rand(L, d, d),
            "wo": rand(L, d, d), "w1": rand(L, d, f), "b1": rand(L, f),
            "w2": rand(L, f, d), "b2": rand(L, d),
            "ln1_scale": rand(L, d, loc=1.0, scale=0.1),
            "ln1_bias": rand(L, d),
            "ln2_scale": rand(L, d, loc=1.0, scale=0.1),
            "ln2_bias": rand(L, d)}}


@pytest.fixture(scope="module")
def models():
    """One numpy parameter set handed to both packages, and the JAX
    bodies jitted once for the module."""
    jcfg, tcfg = _configs()
    np_params = _np_params(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = tt.params_from_jax(np_params, CPU)
    jbodies = (jax.jit(lambda p, *a: jt.transformer_decode_prefill(
        p, jcfg, *a)), jax.jit(lambda p, *a: jt.transformer_decode_step(
            p, jcfg, *a)))
    return jcfg, tcfg, jparams, np_params, tparams, jbodies


def _engine(model, name, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("batch_size", 3)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return DecodeEngine(name=name, **kw, **model.engine_kwargs())


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_params_from_jax_round_trips(models):
    _, _, _, np_params, tparams, _ = models

    def walk(a, b):
        assert set(a) == set(b)
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key])
            else:
                assert b[key].dtype == torch.float32
                assert b[key].device == CPU
                np.testing.assert_array_equal(b[key].numpy(), a[key])
    walk(np_params, tparams)


@pytest.mark.parametrize("use_kernel,variant", [
    pytest.param(False, "stream", id="False"),
    pytest.param(True, "stream", id="True"),
    pytest.param(True, "grid", id="True-grid")])
def test_prefill_and_step_match_jax(models, use_kernel, variant):
    """Two chunked prefills and one batched step with an inactive row,
    through both packages' bodies: pages within 1e-5, tokens equal.
    ``use_kernel=True`` routes prefill attention through the kernel
    wrapper, whose CPU path is the kernel's plain version; ``grid`` builds
    the port's model with ``attn_variant="grid"``, so prefill runs the
    split-KV plain version (two key splits of the 64-key table) against
    the JAX lax tier's prefill."""
    jcfg, tcfg, jparams, _, tparams, (jprefill, jstep) = models
    if variant != tcfg.attn_variant:
        tcfg = tt.TransformerConfig(**{**vars(tcfg), "attn_variant": variant})
    nb, bs, mb = 16, 16, 4
    rng = np.random.RandomState(0)
    kp0 = rng.standard_normal((nb, bs, 2, 32)).astype(np.float32) * 0.1
    vp0 = rng.standard_normal((nb, bs, 2, 32)).astype(np.float32) * 0.1
    jk, jv = jnp.asarray(kp0), jnp.asarray(vp0)
    tk, tv = torch.from_numpy(kp0.copy()), torch.from_numpy(vp0.copy())
    tables = {"a": [3, 7, 0, 0], "b": [5, 0, 0, 0]}
    # (sequence, chunk tokens, start): "a" is a 12-token prompt in two
    # 8-token bucket chunks, "b" a 5-token prompt
    chunks = [("a", [3, 1, 4, 1, 5, 9, 2, 6], 0), ("a", [5, 3, 5, 8], 8),
              ("b", [2, 7, 1, 8, 2], 0)]
    for seq, toks, start in chunks:
        padded = np.zeros(8, np.int32)
        padded[:len(toks)] = toks
        table = np.asarray(tables[seq], np.int32)
        jtok, jk, jv = jprefill(jparams, jk, jv, padded, np.int32(start),
                                np.int32(len(toks)), table)
        ttok, tk, tv = tt.transformer_decode_prefill(
            tparams, tcfg, tk, tv, torch.from_numpy(padded.astype(np.int64)),
            torch.tensor(start), torch.tensor(len(toks)),
            torch.from_numpy(table.astype(np.int64)), use_kernel=use_kernel)
        assert int(ttok) == int(jtok)
        # the null block takes duplicate padding writes: compare the rest
        _close(tk[1:], jk[1:])
        _close(tv[1:], jv[1:])
    ids = np.array([6, 0, 4], np.int32)
    pos = np.array([12, 0, 5], np.int32)
    tabs = np.array([tables["a"], [0] * mb, tables["b"]], np.int32)
    active = np.array([True, False, True])
    jids, jk, jv = jstep(jparams, jk, jv, ids, pos, tabs, active)
    tids, tk, tv = tt.transformer_decode_step(
        tparams, tcfg, tk, tv, *(torch.from_numpy(x.astype(np.int64))
                                 for x in (ids, pos, tabs)),
        torch.from_numpy(active))
    assert tids[active].tolist() == np.asarray(jids)[active].tolist()
    _close(tk[1:], jk[1:])
    _close(tv[1:], jv[1:])


def test_builtin_lm_bodies_match_jax():
    """The engine's built-in single-layer LM, both bodies, both packages."""
    params = tiny_lm_params(vocab=32, dim=16, seed=0)
    jparams = jax_tiny_lm_params(vocab=32, dim=16, seed=0)
    for key in params:
        np.testing.assert_array_equal(params[key], jparams[key])
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    kp = np.zeros((8, 4, 16), np.float32)
    jk, jv = jnp.asarray(kp), jnp.asarray(kp)
    tk, tv = torch.zeros(8, 4, 16), torch.zeros(8, 4, 16)
    table = np.array([2, 5, 0, 0])
    toks = np.array([3, 1, 4, 1, 5, 9, 0, 0])
    jtok, jk, jv = jax.jit(jdecode._lm_prefill)(
        jparams, jk, jv, toks.astype(np.int32), np.int32(0), np.int32(6),
        table.astype(np.int32))
    ttok, tk, tv = tdecode._lm_prefill(
        tparams, tk, tv, torch.from_numpy(toks), torch.tensor(0),
        torch.tensor(6), torch.from_numpy(table))
    assert int(ttok) == int(jtok)
    _close(tk[1:], jk[1:])
    tabs = np.array([[2, 5, 0, 0], [0, 0, 0, 0]])
    ids, pos, act = np.array([int(jtok), 0]), np.array([6, 0]), \
        np.array([True, False])
    jids, jk, _ = jax.jit(jdecode._lm_step)(
        jparams, jk, jv, ids.astype(np.int32), pos.astype(np.int32),
        tabs.astype(np.int32), act)
    tids, tk, _ = tdecode._lm_step(
        tparams, tk, tv, torch.from_numpy(ids), torch.from_numpy(pos),
        torch.from_numpy(tabs), torch.from_numpy(act))
    assert int(tids[0]) == int(jids[0])
    _close(tk[1:], jk[1:])


def test_port_engine_continuous_matches_solo(models):
    """Batch 3 < 7 prompts forces join/leave churn; every stream must be
    bit-identical to the same prompt decoded solo."""
    _, tcfg, _, _, tparams, _ = models
    model = tt.TransformerDecodeModel(tcfg, params=tparams, device="cpu")
    solo_eng = _engine(model, "tsolo")
    solo = [solo_eng.generate(p, max_new_tokens=m)
            for p, m in zip(PROMPTS, BUDGETS)]
    solo_eng.stop()
    cont = _engine(model, "tcont")
    streams = []
    for i, (p, m) in enumerate(zip(PROMPTS, BUDGETS)):
        streams.append(cont.submit(p, max_new_tokens=m))
        if i % 3 == 2:
            time.sleep(0.02)
    outs = [s.result_wait(60.0) for s in streams]
    assert outs == solo, "continuous decode != solo"
    assert cont.program_counts() == (2, 1)
    st = cont.stats()
    assert st["kv"]["blocks_live"] == 0
    assert st["submitted"] == st["served"] == len(PROMPTS)
    cont.stop()


def test_port_engine_chunked_prefill_matches_whole(models):
    _, tcfg, _, _, tparams, _ = models
    model = tt.TransformerDecodeModel(tcfg, params=tparams, device="cpu")
    whole = _engine(model, "tw")
    ref = [whole.generate(p, max_new_tokens=m)
           for p, m in zip(PROMPTS, BUDGETS)]
    whole.stop()
    chunked = _engine(model, "tc", prefill_chunk=8)
    out = [chunked.generate(p, max_new_tokens=m)
           for p, m in zip(PROMPTS, BUDGETS)]
    assert out == ref, "chunked prefill changed the output"
    long_out = chunked.generate([7] * 30, max_new_tokens=4)
    assert len(long_out) == 4
    assert chunked.stats()["prefill_chunks"] > 0
    assert chunked.program_counts() == (2, 1)
    assert chunked.stats()["kv"]["blocks_live"] == 0
    chunked.stop()


def _dense_logits(params, cfg, tokens):
    """Plain full causal forward of the port's params (no paging):
    logits[i] predicts tokens[i + 1]."""
    S = len(tokens)
    H, Dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    ids = torch.tensor(tokens)
    x = params["embed"][ids] + params["pos_embed"][:S]
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in params["layers"].items()}
        h = tt._layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
        q, k, v = ((h @ lp[w]).reshape(S, H, Dh).transpose(0, 1)
                   for w in ("wq", "wk", "wv"))
        s = torch.where(mask, q @ k.transpose(1, 2) / Dh ** 0.5, -1e30)
        ctx = (torch.softmax(s, -1) @ v).transpose(0, 1).reshape(S, -1)
        x = tt._mlp(x + ctx @ lp["wo"], lp)
    x = tt._layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    return x @ params["embed"].T


def test_engines_agree_across_frameworks(models):
    """The JAX DecodeEngine and the port's, same params and prompts: the
    same token streams, except where a near-tie (top-2 logit margin below
    MARGIN_TOL) lets float32 summation order pick the other token."""
    jcfg, tcfg, jparams, _, tparams, _ = models
    jmodel = jt.TransformerDecodeModel(jcfg, params=jparams, flash="off")
    # one prefill bucket: the JAX engine compiles two programs, not three
    jeng = JaxDecodeEngine(jmodel.params, name="jxf", num_blocks=64,
                           batch_size=3, max_seq_len=64,
                           prefill_buckets=(16,), kv_shape=jmodel.kv_shape,
                           prefill_fn=jmodel.prefill_fn,
                           step_fn=jmodel.step_fn)
    jstreams = [jeng.submit(p, max_new_tokens=m)
                for p, m in zip(PROMPTS, BUDGETS)]
    jout = [s.result_wait(120.0) for s in jstreams]
    jeng.stop()
    model = tt.TransformerDecodeModel(tcfg, params=tparams, device="cpu")
    teng = _engine(model, "txf", prefill_buckets=(16,))
    tstreams = [teng.submit(p, max_new_tokens=m)
                for p, m in zip(PROMPTS, BUDGETS)]
    tout = [s.result_wait(60.0) for s in tstreams]
    teng.stop()
    smallest = float("inf")
    for prompt, a, b in zip(PROMPTS, jout, tout):
        logits = _dense_logits(tparams, tcfg, prompt + b[:-1])
        top2 = logits[len(prompt) - 1:].topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        # the dense forward must pick the port engine's tokens
        assert logits[len(prompt) - 1:].argmax(-1).tolist() == b
        diverge = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       None)
        upto = len(b) if diverge is None else diverge + 1
        smallest = min(smallest, min(margins[:upto]))
        if diverge is not None:
            assert margins[diverge] < MARGIN_TOL, (
                "prompt %s: JAX %s vs port %s diverge at %d with top-2 "
                "margin %g >= %g" % (prompt, a, b, diverge, margins[diverge],
                                     MARGIN_TOL))
    print("smallest top-2 logit margin compared: %g" % smallest)


def test_decode_step_fault_site_fails_the_active_set():
    """The engine's ``decode.step`` fault site fires before a device
    dispatch; an injected step failure fails the sequences in flight
    (counted), and the engine keeps serving afterwards."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.resilience import faults
    eng = DecodeEngine(tiny_lm_params(), name="tfault", device="cpu",
                       num_blocks=16, batch_size=2, max_seq_len=32,
                       prefill_buckets=(8,))
    before = profiler.fault_counters().get("decode.step", 0)
    faults.configure("decode.step:kind=step:count=1:raise=OSError,boom")
    try:
        stream = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="decode step failed"):
            stream.result_wait(30.0)
        assert len(stream.tokens) == 1      # the prefill token survives
    finally:
        faults.configure(None)
    assert profiler.fault_counters()["decode.step"] == before + 1
    assert len(eng.generate([1, 2, 3], max_new_tokens=4)) == 4
    st = eng.stats()
    assert (st["failed"], st["served"]) == (1, 1)
    assert st["kv"]["blocks_live"] == 0
    eng.stop()
