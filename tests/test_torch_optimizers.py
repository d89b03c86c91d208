"""The port's optimizers held against the JAX package's on the CPU.

The same numpy weights and gradients (a weight, a bias, a convolution
kernel; ``rescale_grad``, ``wd`` with the reference's zero ``wd_mult`` for
biases, ``clip_gradient``) go through ``Updater`` in both packages for 3
updates:

- each of the twelve optimizers (``Signum``, ``NAG``, ``LBSGD``,
  ``DCASGD``, ``AdaGrad``, ``RMSProp`` plain and centered, ``AdaDelta``,
  ``Ftrl``, ``Adamax``, ``Nadam``, ``FTML``), and ``SGD``/``Adam`` beside
  them: every weight and slot within 1e-6 relative L2 after every update;
- the same with float16 weights and ``multi_precision=True``: the float32
  master copies and slots within 1e-6, the float16 weights within 1e-3
  (one float16 ulp: a master 1e-7 apart may round either way);
- ``SGLD``: its noise comes from each package's own RNG, so it is held by
  moments (the update minus its deterministic part has mean 0 and
  variance lr within 5 sigma, in both packages) and by reproducibility
  (a reseeded ``mx.random`` gives the same bits);
- ``LBSGD``: a linear warmup over an accumulation window of 2, and LARS,
  against the reference; the reference's quirk that seeds the
  accumulation counter with the resume offset (``begin_epoch=1`` steps on
  the first update) is pinned in both;
- ``Updater.get_states``/``set_states``: a port round trip continues bit
  for bit, and the reference's ``get_states(dump_optimizer=True)`` bytes
  restore in the port (num_update and the scheduler position included)
  and continue within 1e-6; a legacy pickle of JAX arrays raises.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.context import host_scope
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-6
F16_TOL = 1e-3
SHAPES = {"fc_weight": (8, 5), "fc_bias": (8,), "conv_weight": (4, 3, 3, 3)}
NAMES = dict(enumerate(SHAPES))
COMMON = dict(rescale_grad=0.25, wd=0.01, clip_gradient=5.0,
              param_idx2name=NAMES)

#: id -> (registry name, hyperparameters)
OPTIMIZERS = {
    "sgd_mom": ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    "adam": ("adam", dict(learning_rate=0.01)),
    "signum": ("signum", dict(learning_rate=0.01, momentum=0.9,
                              wd_lh=0.01)),
    "signsgd": ("signum", dict(learning_rate=0.01, momentum=0.0)),
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9)),
    "lbsgd": ("lbsgd", dict(learning_rate=0.1, momentum=0.9,
                            warmup_epochs=1, updates_per_epoch=4,
                            batch_scale=1)),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.1)),
    "adagrad": ("adagrad", dict(learning_rate=0.1)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01, clip_weights=2.0)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01,
                                         centered=True)),
    "adadelta": ("adadelta", dict(rho=0.9)),
    "ftrl": ("ftrl", dict(learning_rate=0.1, lamda1=0.01)),
    "adamax": ("adamax", dict(learning_rate=0.01)),
    "nadam": ("nadam", dict(learning_rate=0.01)),
    "ftml": ("ftml", dict(learning_rate=0.01)),
}


def _inputs(seed, dtype=np.float32, steps=3):
    rng = np.random.RandomState(seed)
    weights = {i: rng.normal(0, 1, s).astype(dtype)
               for i, s in enumerate(SHAPES.values())}
    grads = [{i: rng.normal(0, 4, s).astype(dtype)
              for i, s in enumerate(SHAPES.values())} for _ in range(steps)]
    return weights, grads


def _leaves(state):
    """The slot arrays of one index's state, flattened in order."""
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _leaves(s)]
    return [state]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


class _Pair:
    """One optimizer in both packages, updating the same weights."""

    def __init__(self, name, kw, weights):
        self.jopt = jmx.optimizer.create(name, **kw)
        self.topt = tmx.optimizer.create(name, **kw)
        for opt in (self.jopt, self.topt):
            opt.set_wd_mult({})   # biases: wd_mult 0, as Module sets it
        self.jupd = jmx.optimizer.get_updater(self.jopt)
        self.tupd = tmx.optimizer.get_updater(self.topt)
        self.jw = {i: jmx.nd.array(w, dtype=w.dtype)
                   for i, w in weights.items()}
        self.tw = {i: tmx.nd.array(w, ctx=tmx.cpu(), dtype=w.dtype)
                   for i, w in weights.items()}

    def step(self, grads):
        for i, g in grads.items():
            self.jupd(i, jmx.nd.array(g, dtype=g.dtype), self.jw[i])
            self.tupd(i, tmx.nd.array(g, ctx=tmx.cpu(), dtype=g.dtype),
                      self.tw[i])

    def worst(self):
        """(worst weight error, worst float32 slot error)."""
        w_err = max(_rel(self.tw[i].asnumpy(), self.jw[i].asnumpy())
                    for i in self.jw)
        s_err = 0.0
        for i in self.jw:
            js = _leaves(self.jupd.states.get(i))
            ts = _leaves(self.tupd.states.get(i))
            assert len(js) == len(ts), (i, len(js), len(ts))
            for j, t in zip(js, ts):
                assert t.dtype == j.dtype
                s_err = max(s_err, _rel(t.asnumpy(), j.asnumpy()))
        return w_err, s_err


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "f16_mp"])
@pytest.mark.parametrize("opt_id", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(opt_id, mp):
    name, hp = OPTIMIZERS[opt_id]
    weights, grads = _inputs(7, np.float16 if mp else np.float32)
    pair = _Pair(name, dict(COMMON, multi_precision=mp, **hp), weights)
    for t, g in enumerate(grads):
        pair.step(g)
        w_err, s_err = pair.worst()
        assert s_err <= TOL, (opt_id, t, s_err)
        assert w_err <= (F16_TOL if mp else TOL), (opt_id, t, w_err)
    assert pair.topt.num_update == pair.jopt.num_update == len(grads)


def test_every_reference_optimizer_is_registered():
    assert set(jmx.optimizer.opt_registry.keys()) <= \
        set(tmx.optimizer.opt_registry.keys())


def _sgld_noise(pkg, seed_fn, w0, g, lr, wd):
    opt = pkg.optimizer.create("sgld", learning_rate=lr, wd=wd,
                               rescale_grad=1.0)
    upd = pkg.optimizer.get_updater(opt)
    kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
    w = pkg.nd.array(w0, **kw)
    seed_fn()
    upd(0, pkg.nd.array(g, **kw), w)
    det = w0 - lr / 2 * (g + wd * w0)
    return w.asnumpy().astype(np.float64) - det


def test_sgld_by_moments_and_reproducibility():
    rng = np.random.RandomState(3)
    n, lr, wd = 40000, 0.01, 0.001
    w0 = rng.normal(size=(n,)).astype(np.float32)
    g = rng.normal(size=(n,)).astype(np.float32)
    noises = {}
    for pkg in (jmx, tmx):
        noises[pkg.__name__] = _sgld_noise(
            pkg, lambda p=pkg: p.random.seed(11), w0, g, lr, wd)
    for key, noise in noises.items():
        # mean 0 (sd of the mean sqrt(lr / n)) and variance lr (sd of the
        # sample variance lr * sqrt(2 / n)), each within 5 sigma
        assert abs(noise.mean()) < 5 * np.sqrt(lr / n), key
        assert abs(noise.var() - lr) < 5 * lr * np.sqrt(2.0 / n), key
    again = _sgld_noise(tmx, lambda: tmx.random.seed(11), w0, g, lr, wd)
    np.testing.assert_array_equal(again, noises["mxnet_tpu_torch"])
    other = _sgld_noise(tmx, lambda: tmx.random.seed(12), w0, g, lr, wd)
    assert not np.array_equal(other, noises["mxnet_tpu_torch"])


@pytest.mark.parametrize("strategy,begin_epoch,steps", [
    ("linear", 0, 6), ("power2", 0, 4), ("sqrt", 0, 4), ("lars", 0, 4),
    ("linear", 1, 4)])
def test_lbsgd_warmup_and_accumulation(strategy, begin_epoch, steps):
    weights, grads = _inputs(5, steps=steps)
    hp = dict(learning_rate=0.1, momentum=0.9, warmup_strategy=strategy,
              warmup_epochs=2, updates_per_epoch=3, batch_scale=2,
              begin_epoch=begin_epoch)
    pair = _Pair("lbsgd", dict(COMMON, **hp), weights)
    moved = []
    for t, g in enumerate(grads):
        before = pair.tw[0].asnumpy().copy()
        pair.step(g)
        moved.append(not np.array_equal(before, pair.tw[0].asnumpy()))
        w_err, s_err = pair.worst()
        assert max(w_err, s_err) <= TOL, (strategy, t, w_err, s_err)
    if begin_epoch == 0:
        # the accumulation window: a step every batch_scale updates
        assert moved == [t % 2 == 1 for t in range(steps)]
    else:
        # the resume offset seeds the counter (init_updates + 1 = 4): the
        # first update already closes a window
        assert moved == [t % 2 == 0 for t in range(steps)]
        assert pair.topt.cumgrads[0]["num_cums"] == \
            pair.jopt.cumgrads[0]["num_cums"] == 3 + steps


def test_updater_states_round_trip_continues_bit_for_bit():
    weights, grads = _inputs(9, steps=4)
    kw = dict(COMMON, learning_rate=0.1, momentum=0.9,
              lr_scheduler=tmx.lr_scheduler.FactorScheduler(step=2,
                                                            factor=0.5))
    opt = tmx.optimizer.create("nag", **kw)
    upd = tmx.optimizer.get_updater(opt)
    w = {i: tmx.nd.array(v, ctx=tmx.cpu()) for i, v in weights.items()}

    def step(u, arrays, g):
        for i, gi in g.items():
            u(i, tmx.nd.array(gi, ctx=tmx.cpu()), arrays[i])

    for g in grads[:2]:
        step(upd, w, g)
    blob = upd.get_states(dump_optimizer=True)
    mid = {i: a.asnumpy().copy() for i, a in w.items()}
    for g in grads[2:]:
        step(upd, w, g)
    opt2 = tmx.optimizer.create("nag", **dict(
        kw, lr_scheduler=tmx.lr_scheduler.FactorScheduler(step=2,
                                                          factor=0.5)))
    upd2 = tmx.optimizer.get_updater(opt2)
    with host_scope():   # an empty updater's slots go to the default device
        upd2.set_states(blob)
    assert opt2.num_update == 2
    w2 = {i: tmx.nd.array(v, ctx=tmx.cpu()) for i, v in mid.items()}
    for g in grads[2:]:
        step(upd2, w2, g)
    for i in w:
        np.testing.assert_array_equal(w2[i].asnumpy(), w[i].asnumpy())
    assert opt2.num_update == opt.num_update == 4


def test_reference_updater_states_restore_in_the_port():
    weights, grads = _inputs(13, steps=4)

    def kw(pkg):
        return dict(COMMON, learning_rate=0.01,
                    lr_scheduler=pkg.lr_scheduler.FactorScheduler(
                        step=3, factor=0.5))

    pair = _Pair("adam", kw(jmx), weights)
    pair.topt = None
    for g in grads[:2]:
        for i, gi in g.items():
            pair.jupd(i, jmx.nd.array(gi), pair.jw[i])
    blob = pair.jupd.get_states(dump_optimizer=True)
    assert b"mxnet_tpu" in blob and b"jax" not in blob
    mid = {i: a.asnumpy() for i, a in pair.jw.items()}
    topt = tmx.optimizer.create("adam", **kw(tmx))
    tupd = tmx.optimizer.get_updater(topt)
    with host_scope():
        tupd.set_states(blob)
    assert topt.num_update == 2
    assert type(topt.lr_scheduler) is tmx.lr_scheduler.FactorScheduler
    tw = {i: tmx.nd.array(v, ctx=tmx.cpu()) for i, v in mid.items()}
    for g in grads[2:]:
        for i, gi in g.items():
            pair.jupd(i, jmx.nd.array(gi), pair.jw[i])
            tupd(i, tmx.nd.array(gi, ctx=tmx.cpu()), tw[i])
    for i in tw:
        assert _rel(tw[i].asnumpy(), pair.jw[i].asnumpy()) <= TOL


def test_legacy_pickle_of_jax_arrays_raises():
    blob = pickle.dumps({0: jmx.nd.ones((2,))._data})
    upd = tmx.optimizer.get_updater(tmx.optimizer.create("sgd"))
    with pytest.raises(tmx.MXNetError, match="JAX"):
        upd.set_states(blob)
