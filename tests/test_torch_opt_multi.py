"""The fused optimizer update kernel #7 itself (``csrc/opt_update.cu``,
one multi-tensor launch per update) on the CPU: its CUDA source built for
the host against the emulator of ``mxnet_tpu_torch/kernels/_emulate.py``
(with ``-ffp-contract=off``, the card's ``--fmad=false``) and driven
through ``fused_update_step`` with the CUDA routing pointed at it.

- A table of mixed leaves: 3, 15, 64, 1000, 1024, 9408 and 128 * 513
  elements, and a 1024-element param that is a view at a 4-byte offset
  (its record's alignment flag is off, so it takes the scalar path), for
  SGD, SGD-momentum and Adam x clip {None, 0.01} x wd {0, 1e-4}, two
  steps, NaN and +-inf in every grad. Tolerance: bitwise against
  ``fused_update_step_plain`` on the same inputs (NaN in the same places,
  every other value the same bits): the kernel keeps the plain version's
  operations and their order, and the host's float32 arithmetic, sqrtf
  and division are IEEE as the card's are.
- The same table with a launch capacity of 3 leaves (three launches a
  step), still bitwise.
- The C entries refuse a table they cannot take, before writing anything.
Skipped where the host has no ``g++``.
"""
import ctypes
import itertools

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import _emulate
from mxnet_tpu_torch.kernels import opt_update as tou

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIZES = {"a": 3, "b": 15, "c": 64, "d": 1000, "e": 1024, "f": 9408,
         "g": 128 * 513, "h": 1024}
MISALIGNED = "h"
STEPS = 2
KINDS = ("sgd", "sgd_mom", "adam")


@pytest.fixture(scope="module")
def emu():
    if _emulate.compiler() is None:
        pytest.skip("no g++ on this host to build the emulated kernels")
    _emulate.load("opt_update")
    return _emulate


@pytest.fixture
def routed(emu, monkeypatch):
    """CPU tensors take the CUDA route, into the emulated library."""
    monkeypatch.setattr(tou, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tou, "_entry", emu.entry)
    monkeypatch.setattr(tou, "_call", lambda fn, device, *a: fn(*a, None))
    return emu


def _hp(kind):
    return {"lr": 0.1, "momentum": 0.9 if kind == "sgd_mom" else 0.0,
            "beta1": 0.9, "beta2": 0.999, "eps": 1e-8}


def _inputs(seed=0):
    """Params and STEPS grads from numpy; every grad holds NaN, +inf,
    -inf, and values inside and outside the clip."""
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(n).astype(np.float32) for k, n in SIZES.items()}
    grads = []
    for step in range(STEPS):
        g = {k: (rng.randn(n) * 2).astype(np.float32)
             for k, n in SIZES.items()}
        for v in g.values():
            for j, x in enumerate((np.nan, np.inf, -np.inf)):
                v[(step + j) % len(v)] = x
        grads.append(g)
    return params, grads


def _param(key, values):
    if key != MISALIGNED:
        return torch.tensor(values)
    buf = torch.zeros(len(values) + 1)
    view = buf[1:]
    view.copy_(torch.from_numpy(values))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _run(kind, clip, wd, fn):
    params, grads = _inputs()
    p = {k: _param(k, v) for k, v in params.items()}
    if kind == "adam":
        st = {"m": {k: torch.zeros_like(v) for k, v in p.items()},
              "v": {k: torch.zeros_like(v) for k, v in p.items()},
              "t": torch.zeros((), dtype=torch.int32)}
    else:
        st = {"mom": ({k: torch.zeros_like(v) for k, v in p.items()}
                      if kind == "sgd_mom" else None)}
    for g in grads:
        fn("adam" if kind == "adam" else "sgd", _hp(kind), p, st,
           {k: torch.tensor(v) for k, v in g.items()}, rescale=1 / 32,
           clip=clip, wd=wd)
    slots = [st[s][k] for s in ("m", "v", "mom") if st.get(s)
             for k in SIZES]
    return [p[k] for k in SIZES] + slots


def _assert_bitwise(got, want, what):
    got, want = got.numpy(), want.numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), what + ": NaN positions"
    assert np.array_equal(got[~nan].view(np.int32),
                          want[~nan].view(np.int32)), \
        "%s: max abs diff %g" % (what, np.abs(got[~nan] - want[~nan]).max())


def _counts(kind):
    return (getattr(tou, "launches_" + kind), getattr(tou, "leaves_" + kind))


@pytest.mark.parametrize("kind,clip,wd", list(itertools.product(
    KINDS, (None, 0.01), (0.0, 1e-4))))
def test_multi_kernel_equals_plain_bitwise(routed, kind, clip, wd):
    want = _run(kind, clip, wd, tou.fused_update_step_plain)
    launches, leaves = _counts(kind)
    got = _run(kind, clip, wd, tou.fused_update_step)
    assert _counts(kind) == (launches + STEPS, leaves + STEPS * len(SIZES))
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_bitwise(a, b, "%s tensor %d" % (kind, i))


@pytest.mark.parametrize("kind", KINDS)
def test_table_longer_than_a_launch(routed, monkeypatch, kind):
    monkeypatch.setattr(tou, "_MAX_LEAVES", 3)
    want = _run(kind, 0.01, 1e-4, tou.fused_update_step_plain)
    launches, leaves = _counts(kind)
    got = _run(kind, 0.01, 1e-4, tou.fused_update_step)
    # 8 leaves at 3 a launch: 3 launches a step
    assert _counts(kind) == (launches + 3 * STEPS,
                             leaves + STEPS * len(SIZES))
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_bitwise(a, b, "%s tensor %d" % (kind, i))


def _records(rows):
    words = [w for row in rows for w in row]
    return (ctypes.c_int64 * len(words))(*words)


def test_entries_refuse_what_they_cannot_take(emu):
    lr = torch.full((), 0.1)
    p, g, m = torch.ones(1024), torch.ones(1024), torch.zeros(1024)
    view = torch.ones(1025)[1:]
    row = [p.data_ptr(), g.data_ptr(), m.data_ptr(), 0, 1024, 1]
    sgd_mom = emu.entry("mx_optupdate_multi_sgd_mom_f32")

    def call(rows, count=None):
        rec = _records(rows)
        return sgd_mom(ctypes.addressof(rec), len(rows) if count is None
                       else count, lr.data_ptr(), 0.9, 1.0, 0, 0.0, 0.0,
                       0.0, None)

    bad = {
        "too many leaves": [row] * (tou._MAX_LEAVES + 1),
        "no leaves": [],
        "empty leaf": [row[:4] + [0, 1]],
        "no momentum slot": [row[:2] + [0, 0, 1024, 1]],
        "aligned flag on a misaligned param":
            [[view.data_ptr()] + row[1:]],
        "aligned flag on a length not a multiple of 4":
            [row[:4] + [1022, 1]]}
    for what, rows in bad.items():
        assert call(rows) != 0, what
        assert torch.equal(p, torch.ones(1024)), what
        assert torch.equal(view, torch.ones(1024)), what
    # the C table holds exactly the wrapper's _MAX_LEAVES
    small = [torch.ones(4 * 3) for _ in range(tou._MAX_LEAVES)]
    assert call([[t.data_ptr(), t.data_ptr() + 16, t.data_ptr() + 32, 0,
                  4, 1] for t in small]) == 0
    for t in small:
        assert not torch.equal(t[:4], torch.ones(4))
    assert call([row]) == 0
    assert not torch.equal(p, torch.ones(1024))
