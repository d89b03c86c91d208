"""The fused optimizer update (kernel #7) of the port held against the JAX
package's on the CPU.

- ``fused_update_step_plain`` (and ``fused_update_step``, which runs it on
  CPU tensors) against the JAX ``fused_update_step`` lax tier
  (``use_pallas=False``) for SGD, SGD with momentum and Adam, over
  clip {None, 0.01} x wd {0, 1e-4} x rescale {1, 1/32}, three successive
  steps (Adam's ``t`` moves), leaves of 1024 and 128 * 513 elements (kernel
  leaves on the card) and two the kernel rejects (1000 elements, shape
  (3, 5)), with NaN and +-inf in every grad. SGD and SGD-momentum are also
  held against the Pallas body in interpret mode (``interpret=True``,
  with the whole prologue: clip 0.01, wd 1e-4, rescale 1/32);
  Adam's interpret tier fails in the JAX package's own tests, so Adam is
  held against the lax tier only.
- Tolerance against the lax tier: bitwise. NaN lands in the same places
  and every other value has the same bits; the observed maximum
  difference is 0 ulp in every case. (The plain version takes Adam's
  square root as the correctly rounded float32 one, which XLA's and
  CUDA's ``sqrtf`` are; torch's vectorized CPU sqrt is off by one ulp on
  some inputs.)
- Against the interpret tier: XLA:CPU contracts the Pallas body's
  ``p - lr * g'`` (and ``mu * mom - lr * g'``) into fused multiply-adds,
  so that tier differs from the JAX package's own lax tier here. Allowed:
  NaN and +-inf in the same places, and elsewhere at most 1 ulp of the
  leaf's largest magnitude (``np.spacing(max |x|)``) per step, 3 over the
  run; observed at most 2 such ulps (a momentum slot, where the
  contraction compounds over the steps) and 0.5 on the params.
- The byte-count functions against hand counts, and the eligibility
  split against the JAX package's ``_kernel_eligible``.
- On CPU tensors the wrapper launches nothing and builds nothing.
- Routed as CUDA into a recording stub of the C entry: one call per
  ``_MAX_LEAVES`` float32 leaves, records in tree order with their
  pointers, n and alignment flag, and the counters.
"""
import ctypes
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import opt_update as jou

from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels import opt_update as tou
from torch_one_thread import one_torch_thread  # noqa: F401

SHAPES = {"a": (1024,), "b": (128 * 513,), "c": (1000,), "d": (3, 5)}
STEPS = 3
CASES = list(itertools.product(["sgd", "sgd_mom", "adam"], [None, 0.01],
                               [0.0, 1e-4], [1.0, 1 / 32]))


def _hp(opt):
    return {"lr": 0.1, "momentum": 0.9 if opt == "sgd_mom" else 0.0,
            "beta1": 0.9, "beta2": 0.999, "eps": 1e-8}


def _inputs(seed):
    """Params and STEPS grads from numpy; every grad holds NaN, +inf,
    -inf, and values inside and outside the clip."""
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for step in range(STEPS):
        g = {k: (rng.randn(*s) * 2).astype(np.float32)
             for k, s in SHAPES.items()}
        for v in g.values():
            flat = v.reshape(-1)
            flat[step:step + 3] = (np.nan, np.inf, -np.inf)
            flat[5] = 1e-3
        grads.append(g)
    return params, grads


def _state(opt, params, zeros):
    if opt == "adam":
        return {"m": {k: zeros(v) for k, v in params.items()},
                "v": {k: zeros(v) for k, v in params.items()}}
    if opt == "sgd_mom":
        return {"mom": {k: zeros(v) for k, v in params.items()}}
    return {"mom": None}


def _run_jax(opt, clip, wd, rescale, interpret=False):
    params, grads = _inputs(0)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = _state(opt, p, jnp.zeros_like)
    if opt == "adam":
        st["t"] = jnp.zeros((), jnp.int32)
    hp = dict(_hp(opt), lr=jnp.float32(0.1))
    for g in grads:
        p, st = jou.fused_update_step(
            "adam" if opt == "adam" else "sgd", hp, p, st,
            {k: jnp.asarray(v) for k, v in g.items()}, rescale=rescale,
            clip=clip, wd=wd, use_pallas=False, interpret=interpret)
    return p, st


def _run_port(opt, clip, wd, rescale, fn):
    params, grads = _inputs(0)
    p = {k: torch.tensor(v) for k, v in params.items()}
    st = _state(opt, p, torch.zeros_like)
    if opt == "adam":
        st["t"] = torch.zeros((), dtype=torch.int32)
    for g in grads:
        out = fn("adam" if opt == "adam" else "sgd", _hp(opt), p, st,
                 {k: torch.tensor(v) for k, v in g.items()},
                 rescale=rescale, clip=clip, wd=wd)
        assert out[0] is p and out[1] is st   # in place
    return p, st


def _assert_bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), what + ": NaN positions"
    assert np.array_equal(got[~nan].view(np.int32),
                          want[~nan].view(np.int32)), \
        "%s: max abs diff %g" % (what, np.abs(got[~nan] - want[~nan]).max())


def _assert_within_ulp(got, want, what):
    """NaN and +-inf in the same places; elsewhere at most one ulp of the
    leaf's largest finite magnitude per step."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what + ": NaN"
    assert np.array_equal(got[~fin & ~np.isnan(want)],
                          want[~fin & ~np.isnan(want)]), what + ": inf"
    ulp = np.spacing(np.abs(want[fin]).max())
    err = np.abs(got[fin] - want[fin]).max()
    assert err <= STEPS * ulp, "%s: max abs diff %g = %g ulp > %d" % (
        what, err, err / ulp, STEPS)


def _compare(port, ref, opt, check=_assert_bitwise):
    (tp, ts), (jp, js) = port, ref
    for k in SHAPES:
        check(tp[k].numpy(), jp[k], "param " + k)
    for slot in ("m", "v", "mom"):
        if js.get(slot) is not None:
            for k in SHAPES:
                check(ts[slot][k].numpy(), js[slot][k], "%s %s" % (slot, k))
    if opt == "adam":
        assert int(ts["t"]) == int(js["t"]) == STEPS


def _counters():
    return [getattr(tou, c + "_" + k) for c in ("launches", "leaves")
            for k in ("sgd", "sgd_mom", "adam")]


@pytest.mark.parametrize("opt,clip,wd,rescale", CASES)
def test_plain_equals_jax_lax_tier(opt, clip, wd, rescale):
    ref = _run_jax(opt, clip, wd, rescale)
    _compare(_run_port(opt, clip, wd, rescale, tou.fused_update_step_plain),
             ref, opt)
    before = _counters()
    _compare(_run_port(opt, clip, wd, rescale, tou.fused_update_step),
             ref, opt)
    assert _counters() == before, "a CPU tensor launched a kernel"


@pytest.mark.parametrize("opt,clip,wd", [("sgd", 0.01, 1e-4),
                                         ("sgd_mom", 0.01, 1e-4)])
def test_plain_equals_jax_interpret_tier(opt, clip, wd):
    """The Pallas kernel bodies themselves, in interpret mode (within the
    1 ulp that XLA:CPU's contraction moves them)."""
    ref = _run_jax(opt, clip, wd, 1 / 32, interpret=True)
    _compare(_run_port(opt, clip, wd, 1 / 32, tou.fused_update_step_plain),
             ref, opt, check=_assert_within_ulp)


def test_byte_counts_match_hand_counts():
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    n = sum(int(np.prod(s)) for s in SHAPES.values())    # 67703 elements
    mom = {"mom": params}
    assert tou.optupdate_ideal_bytes("sgd", params) == 3 * 4 * n
    assert tou.optupdate_ideal_bytes("sgd", params, mom) == 5 * 4 * n
    assert tou.optupdate_ideal_bytes("adam", params) == 7 * 4 * n
    # the four float32 leaves in one launch, one 4-byte lr read; no block
    # re-reads on the GPU
    assert tou.optupdate_kernel_bytes("sgd", params, mom) == 5 * 4 * n + 4
    assert tou.optupdate_kernel_bytes("adam", params) == 7 * 4 * n + 4
    # the JAX package counts the same ideal bytes
    jparams = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    assert tou.optupdate_ideal_bytes("adam", params) == \
        jou.optupdate_ideal_bytes("adam", jparams)


@pytest.mark.parametrize("shape,dtype", [
    ((1024,), np.float32), ((128 * 513,), np.float32), ((1000,), np.float32),
    ((3, 5), np.float32), ((896,), np.float32), ((8, 128), np.float32),
    ((64, 3, 3, 3), np.float32), ((2048,), np.float16),
    ((2048,), np.int32)])
def test_eligibility_matches_reference(shape, dtype):
    want = bool(jou._kernel_eligible(jnp.zeros(shape, dtype)))
    got = tou._kernel_eligible(torch.from_numpy(np.zeros(shape, dtype)))
    assert got is want


def test_nested_tree_updates_like_flat():
    """The port walks tree leaves: a nested dict (the transformer's
    params) updates exactly as the flat one."""
    flat = _run_port("adam", 0.01, 1e-4, 1.0, tou.fused_update_step)[0]
    params0, grads0 = _inputs(0)
    p = {"x": {k: torch.tensor(params0[k]) for k in "ab"},
         "y": {k: torch.tensor(params0[k]) for k in "cd"}}
    st = {"m": {g: {k: torch.zeros_like(v) for k, v in d.items()}
                for g, d in p.items()},
          "v": {g: {k: torch.zeros_like(v) for k, v in d.items()}
                for g, d in p.items()},
          "t": torch.zeros((), dtype=torch.int32)}
    for g in grads0:
        tou.fused_update_step(
            "adam", _hp("adam"), p, st,
            {"x": {k: torch.tensor(g[k]) for k in "ab"},
             "y": {k: torch.tensor(g[k]) for k in "cd"}},
            clip=0.01, wd=1e-4)
    for grp, keys in (("x", "ab"), ("y", "cd")):
        for k in keys:
            _assert_bitwise(p[grp][k].numpy(), flat[k].numpy(), k)
    assert not _build._libs, "nothing may be built on a CPU call"


def test_wrapper_launches_one_table_per_chunk(monkeypatch):
    """Every float32 leaf, small or not, goes into the table in tree
    order; a float64 leaf takes the plain expression."""
    calls = []

    def stub(name):
        def fn(addr, count, lr_ptr, ok_ptr, *scalars):
            assert ok_ptr is None, "no verdict: a null pointer"
            words = (ctypes.c_int64 * (6 * count)).from_address(addr)
            calls.append((name, [tuple(words[6 * i:6 * i + 6])
                                 for i in range(count)], scalars))
            return 0
        return fn

    monkeypatch.setattr(tou, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tou, "_entry", stub)
    monkeypatch.setattr(tou, "_call", lambda fn, device, *a: fn(*a, None))
    monkeypatch.setattr(tou, "_MAX_LEAVES", 2)
    view = torch.ones(1025)[1:]           # 4 bytes past an aligned buffer
    params = {"z": {"b": torch.ones(3), "a": torch.ones(1024)},
              "m": view, "k": torch.ones(8, dtype=torch.float64),
              "c": torch.ones(2, 6)}
    mom = {"z": {"b": torch.zeros(3), "a": torch.zeros(1024)},
           "m": torch.zeros(1024), "k": torch.zeros(8, dtype=torch.float64),
           "c": torch.zeros(12)}
    grads = {"z": {"b": torch.ones(3), "a": torch.ones(1024)},
             "m": torch.ones(1024), "k": torch.ones(8, dtype=torch.float64),
             "c": torch.ones(12)}
    before = _counters()
    tou.fused_update_step("sgd", {"lr": 0.5, "momentum": 0.9}, params,
                          {"mom": mom}, grads, clip=0.01)
    # tree order: c, k (float64, plain), m, z.a, z.b
    table = [(params["c"], grads["c"], mom["c"], 1),
             (view, grads["m"], mom["m"], 0),
             (params["z"]["a"], grads["z"]["a"], mom["z"]["a"], 1),
             (params["z"]["b"], grads["z"]["b"], mom["z"]["b"], 0)]
    want = [(p.data_ptr(), g.data_ptr(), s.data_ptr(), 0, p.numel(), flag)
            for p, g, s, flag in table]
    assert [c[0] for c in calls] == ["mx_optupdate_multi_sgd_mom_f32"] * 2
    assert [c[1] for c in calls] == [want[:2], want[2:]]
    # momentum, rescale, clip on, lo, hi, wd, and the stream
    assert calls[0][2] == (0.9, 1.0, 1, -0.01, 0.01, 0.0, None)
    after = _counters()
    assert after[1] - before[1] == 2 and after[4] - before[4] == 4
    assert after[:1] + after[2:4] + after[5:] == \
        before[:1] + before[2:4] + before[5:]
    # the stub wrote nothing; the float64 leaf took the plain expression
    assert torch.equal(view, torch.ones(1024))
    assert not torch.equal(params["k"], torch.ones(8, dtype=torch.float64))
    assert not _build._libs
