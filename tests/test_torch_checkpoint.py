"""The port's checkpoints (``mxnet_tpu_torch/checkpoint/``) on the CPU,
mirroring the JAX package's ``tests/python/unittest/test_checkpoint.py``
and held against it where the formats cross.

- Layout: discovery and ordering, uncommitted directories invisible, a
  writer error surfacing at ``wait`` with nothing committed, retention
  (``keep_last_n``, ``keep_every_k_steps``, the newest epoch-boundary
  checkpoint never evicted), async saves and their flush.
- Point in time: a parameter changed after ``save`` does not reach the
  checkpoint; on the fused path, with the writer held until a training
  step has run after ``save``, the checkpoint holds the params and slots
  of the moment of ``save``.
- Resume, bit for bit: a fit stopped after 2 epochs and resumed through
  ``checkpoint_manager`` (another seed in between) ends with the params,
  slots, num_update and scheduler position of the uninterrupted 4-epoch
  fit: the ``local`` updater with NAG and with Nadam (whose running
  product rides the optimizer object), ``tpu_sync`` with NAG (the store's
  updater), the fused step with SGD-momentum and with Adam (kernel #7's
  plain version); also after a simulated kill mid-write, and after a
  SIGTERM mid-epoch (the preemption hook's mid-epoch snapshot is skipped
  and the epoch re-run).
- Preemption: the hook flushes a final mid-epoch checkpoint and never
  replaces a committed epoch-boundary one; a notice tightens the cadence,
  its deadline from ``MXNET_TPU_PREEMPT_NOTICE_S``.
- Formats: a two-file checkpoint imports; legacy optimizer pickles (bare
  states, ``(states, optimizer)``) restore; multi-precision slot tuples
  round-trip; ``Module``'s optimizer state files and ``Module.load(...,
  load_optimizer_states=True)``; a checkpoint directory written by either
  package restores params in the other, bit for bit.
- Cross-package resume: a fit checkpointed by ``mxnet_tpu`` (``local``
  and ``tpu_sync``) resumes in the port; its next 2 epochs end within
  1e-6 relative L2 of the JAX package's own resumed run.
- ``do_checkpoint`` with a manager; ``InferenceEngine.reload_from`` and
  ``ModelServer.reload_from`` (once and polling; ``stop`` joins the
  poller); a ``TrainingSupervisor(manager=)`` restart after an injected
  ``train.step`` fault ends bit for bit the clean run.
"""
import os
import pickle
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.checkpoint import layout, state as ckpt_state
from mxnet_tpu_torch.resilience import faults
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CROSS_TOL = 1e-6


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _fc_symbol(mx=tmx):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data, num_hidden=2, name="fc")
        return mx.sym.SoftmaxOutput(fc, name="softmax")


def _train_iter(mx=tmx, shuffle=True):
    rng = np.random.RandomState(0)
    X = rng.rand(64, 4).astype(np.float32)
    y = (X.sum(axis=1) > 2).astype(np.float32)
    return mx.io.NDArrayIter(X, y, batch_size=8, shuffle=shuffle)


def _opt_params(mx, optimizer):
    # a decaying schedule: resume carries num_update as well as the slots
    kw = dict(learning_rate=0.1, lr_scheduler=mx.lr_scheduler.FactorScheduler(
        step=5, factor=0.5))
    if optimizer in ("sgd", "nag"):
        kw["momentum"] = 0.9
    else:
        kw["learning_rate"] = 0.01
    return kw


def _fit(mod, num_epoch, manager=None, mx=tmx, kvstore="local",
         optimizer="sgd", **kw):
    mod.fit(_train_iter(mx), num_epoch=num_epoch, kvstore=kvstore,
            optimizer=optimizer, optimizer_params=_opt_params(mx, optimizer),
            initializer=mx.init.Uniform(0.1), checkpoint_manager=manager,
            **kw)


def _module(mx=tmx):
    return mx.mod.Module(_fc_symbol(mx), context=mx.cpu())


def _params_np(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _slots_np(mod):
    """Every optimizer slot of a port module, by name."""
    if mod._fused_step is not None:
        return {"%s/%s" % (k, n): t.detach().numpy().copy()
                for k, tree in mod._fused_step.opt_state.items()
                if tree is not None
                for n, t in (tree.items() if isinstance(tree, dict)
                             else [("", tree)])}
    upd = ckpt_state._module_updater(mod)
    return {str(i): s.asnumpy() for i, st in upd.states.items()
            for s in ([st] if not isinstance(st, tuple) else st)
            if s is not None}


def _save_w(mgr, step, value, **kw):
    return mgr.save(step, arg_params={"w": tmx.nd.full((2,), value,
                                                      ctx=tmx.cpu())}, **kw)


# ---------------------------------------------------------------------------
# layout: discovery, atomic commit, retention
# ---------------------------------------------------------------------------

def test_discovery_empty_and_ordering(tmp_path):
    d = str(tmp_path)
    assert tmx.checkpoint.latest_checkpoint(d) is None
    assert tmx.checkpoint.latest_step(d) is None
    mgr = tmx.checkpoint.CheckpointManager(d)
    for step in (3, 11, 7):
        _save_w(mgr, step, 1.0, blocking=True)
    assert mgr.all_steps() == [3, 7, 11]
    assert tmx.checkpoint.latest_step(d) == 11
    assert tmx.checkpoint.latest_checkpoint(d).endswith("step-00000011")


def test_uncommitted_dirs_are_invisible(tmp_path):
    d = str(tmp_path)
    mgr = tmx.checkpoint.CheckpointManager(d)
    _save_w(mgr, 1, 1.0, blocking=True)
    stale = layout.begin_write(d, 2)
    with open(os.path.join(stale, layout.PARAMS_FILE), "wb") as f:
        f.write(b"truncated garbage")
    os.makedirs(os.path.join(d, "step-00000005"))
    assert tmx.checkpoint.latest_step(d) == 1
    _save_w(mgr, 3, 1.0, blocking=True)
    assert not os.path.exists(stale)
    assert tmx.checkpoint.latest_step(d) == 3


def test_writer_error_surfaces_at_wait(tmp_path, monkeypatch):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))

    def _boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_state, "save_params_files", _boom)
    handle = _save_w(mgr, 0, 1.0)
    with pytest.raises(OSError, match="disk full"):
        handle.wait(timeout=60)
    assert tmx.checkpoint.latest_checkpoint(str(tmp_path)) is None
    assert not [n for n in os.listdir(str(tmp_path)) if n.startswith(".tmp")]


def test_retention_policy(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path), keep_last_n=2,
                                           keep_every_k_steps=4)
    for step in range(10):
        _save_w(mgr, step, 1.0, blocking=True)
    assert mgr.all_steps() == [0, 4, 8, 9]


def test_retention_never_evicts_last_boundary_checkpoint(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path), keep_last_n=1)
    _save_w(mgr, 4, 1.0, epoch=4, blocking=True)
    _save_w(mgr, 5, 0.0, epoch=5, blocking=True, mid_epoch=True)
    assert mgr.all_steps() == [4, 5]
    metas = {s: tmx.checkpoint.read_meta(layout.step_path(str(tmp_path), s))
             for s in (4, 5)}
    assert not metas[4].get("mid_epoch") and metas[5]["mid_epoch"]


def test_async_save_and_flush(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    handles = [mgr.save(s, arg_params={"w": tmx.nd.full((4, 4), s,
                                                         ctx=tmx.cpu())})
               for s in range(3)]
    mgr.wait(timeout=60)
    assert all(h.done() for h in handles)
    assert mgr.all_steps() == [0, 1, 2]
    np.testing.assert_array_equal(
        mgr.restore(step=1).arg_params["w"].asnumpy(),
        np.full((4, 4), 1.0, np.float32))


def test_snapshot_is_point_in_time(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    w = tmx.nd.ones((8, 8), ctx=tmx.cpu())
    handle = mgr.save(0, arg_params={"w": w})
    w[:] = 999.0  # training goes on while the writer works
    handle.wait(timeout=60)
    np.testing.assert_array_equal(mgr.restore().arg_params["w"].asnumpy(),
                                  np.ones((8, 8), np.float32))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fused_snapshot_is_point_in_time(tmp_path, monkeypatch, optimizer):
    """The writer is held until a fused step (which writes params and
    slots in place) has run after ``save``: the checkpoint still holds
    the moment of ``save``."""
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    it = _train_iter(shuffle=False)
    mod = _module()
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Uniform(0.1))
    mod.init_optimizer(kvstore="tpu_sync", optimizer=optimizer,
                       optimizer_params=_opt_params(tmx, optimizer))
    assert mod._fused_step is not None
    batches = list(it)
    mod.forward_backward(batches[0])
    mod.update()
    want_params, want_slots = _params_np(mod), _slots_np(mod)
    stepped = threading.Event()
    original = ckpt_state.TrainingState.wait_ready

    def held(self):
        assert stepped.wait(30)
        original(self)

    monkeypatch.setattr(ckpt_state.TrainingState, "wait_ready", held)
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    handle = mgr.save(0, module=mod, epoch=0)
    mod.forward_backward(batches[1])
    mod.update()
    assert _params_np(mod)["fc_weight"].tolist() != \
        want_params["fc_weight"].tolist()
    stepped.set()
    handle.wait(timeout=60)
    data = mgr.restore()
    for k, v in want_params.items():
        np.testing.assert_array_equal(data.arg_params[k].asnumpy(), v)
    state = data.optimizer["state"]
    for key, v in want_slots.items():
        tree, name = key.split("/")
        got = state[tree][name] if name else state[tree]
        np.testing.assert_array_equal(np.asarray(got), v)


# ---------------------------------------------------------------------------
# resume, bit for bit
# ---------------------------------------------------------------------------

# Nadam keeps a running product (m_schedule) outside its slots
RESUME_CASES = [("local", "nag"), ("local", "nadam"), ("tpu_sync", "nag"),
                ("tpu_sync", "sgd"), ("tpu_sync", "adam")]


def _uninterrupted(kvstore, optimizer):
    np.random.seed(3)
    tmx.random.seed(7)
    mod = _module()
    _fit(mod, 4, kvstore=kvstore, optimizer=optimizer)
    return mod


def _assert_same_run(got, want):
    for k, v in _params_np(want).items():
        np.testing.assert_array_equal(_params_np(got)[k], v)
    ws, gs = _slots_np(want), _slots_np(got)
    assert set(ws) == set(gs) and ws
    for k in ws:
        np.testing.assert_array_equal(gs[k], ws[k])
    assert got._optimizer.num_update == want._optimizer.num_update
    assert got._optimizer.lr_scheduler.base_lr == \
        want._optimizer.lr_scheduler.base_lr


@pytest.mark.parametrize("kvstore,optimizer", RESUME_CASES)
def test_fit_resume_bit_exact(tmp_path, monkeypatch, kvstore, optimizer):
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    want = _uninterrupted(kvstore, optimizer)
    assert (want._fused_step is not None) == (kvstore == "tpu_sync" and
                                              optimizer in ("sgd", "adam"))
    np.random.seed(3)
    tmx.random.seed(7)
    _fit(_module(), 2, tmx.checkpoint.CheckpointManager(str(tmp_path)),
         kvstore=kvstore, optimizer=optimizer)
    assert tmx.checkpoint.CheckpointManager(str(tmp_path)).all_steps() == \
        [0, 1]
    np.random.seed(99)
    tmx.random.seed(999)
    got = _module()
    _fit(got, 4, tmx.checkpoint.CheckpointManager(str(tmp_path)),
         kvstore=kvstore, optimizer=optimizer)
    _assert_same_run(got, want)


def test_fit_resume_after_simulated_midwrite_kill(tmp_path):
    want = _uninterrupted("local", "nag")
    np.random.seed(3)
    tmx.random.seed(7)
    _fit(_module(), 2, tmx.checkpoint.CheckpointManager(str(tmp_path)),
         optimizer="nag")
    shutil.rmtree(layout.step_path(str(tmp_path), 1))
    stale = layout.begin_write(str(tmp_path), 1)
    with open(os.path.join(stale, layout.PARAMS_FILE), "wb") as f:
        f.write(b"half a checkpoint")
    assert tmx.checkpoint.latest_step(str(tmp_path)) == 0
    np.random.seed(99)
    got = _module()
    _fit(got, 4, tmx.checkpoint.CheckpointManager(str(tmp_path)),
         optimizer="nag")
    _assert_same_run(got, want)


def test_sigterm_mid_epoch_resumes_bit_for_bit(tmp_path, monkeypatch):
    """SIGTERM during epoch 1: the hook drains the queue, commits a
    mid-epoch snapshot and exits; the resume skips it, re-runs epoch 1
    from its boundary and ends as the uninterrupted fit."""
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    want = _uninterrupted("tpu_sync", "sgd")

    def kill_in_epoch_1(p):
        if p.epoch == 1 and p.nbatch == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    np.random.seed(3)
    tmx.random.seed(7)
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path),
                                           preemption_signal=True)
    with pytest.raises(SystemExit):
        _fit(_module(), 4, mgr, kvstore="tpu_sync",
             batch_end_callback=kill_in_epoch_1)
    assert signal.getsignal(signal.SIGTERM) is not None
    assert not mgr._prev_handlers
    meta = tmx.checkpoint.read_meta(mgr.latest_path())
    assert meta["step"] == 1 and meta["mid_epoch"] and meta["preempted"]
    np.random.seed(99)
    tmx.random.seed(999)
    got = _module()
    _fit(got, 4, tmx.checkpoint.CheckpointManager(str(tmp_path)),
         kvstore="tpu_sync")
    _assert_same_run(got, want)


def test_prefetched_fit_records_the_consumed_position(tmp_path, monkeypatch):
    """The fused fit trains through a DevicePrefetchIter that reads ahead:
    the boundary save records the position the steps consumed (the plain
    iterator's after one epoch), and a mid-epoch position raises rather
    than report the staged batch."""
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    np.random.seed(3)
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    mod = _module()
    _fit(mod, 1, mgr, kvstore="tpu_sync")
    pos = tmx.checkpoint.read_meta(mgr.latest_path())["data_position"]
    np.random.seed(3)
    plain = _train_iter()
    for _ in plain:
        pass
    assert pos["pending_reset"] and pos["iter"] == plain.iter_checkpoint()
    wrapped = mod._wrap_train_iter(_train_iter())
    assert isinstance(wrapped, tmx.io.DevicePrefetchIter)
    wrapped.next()
    with pytest.raises(MXNetError, match="epoch boundary"):
        wrapped.iter_checkpoint()
    wrapped._shutdown()


def test_resume_skips_mid_epoch_snapshots(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    sym = _fc_symbol()
    ones = {"fc_weight": tmx.nd.ones((2, 4), ctx=tmx.cpu()),
            "fc_bias": tmx.nd.zeros((2,), ctx=tmx.cpu())}
    zeros = {"fc_weight": tmx.nd.zeros((2, 4), ctx=tmx.cpu()),
             "fc_bias": tmx.nd.zeros((2,), ctx=tmx.cpu())}
    mgr.save(0, symbol=sym, arg_params=ones, epoch=0, blocking=True)
    mgr.save(1, symbol=sym, arg_params=zeros, epoch=1, blocking=True,
             mid_epoch=True)
    mod = _module()
    it = _train_iter()
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(tmx.init.Uniform(0.1))
    assert mgr.resume(mod, 0) == 1
    np.testing.assert_array_equal(mod.get_params()[0]["fc_weight"].asnumpy(),
                                  np.ones((2, 4), np.float32))


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def _fc_params(value):
    return {"fc_weight": tmx.nd.full((2, 4), value, ctx=tmx.cpu()),
            "fc_bias": tmx.nd.zeros((2,), ctx=tmx.cpu())}


def _sigterm(mgr):
    mgr.install_preemption_hook()
    try:
        with pytest.raises(SystemExit):
            os.kill(os.getpid(), signal.SIGTERM)
    finally:
        mgr.uninstall_preemption_hook()


def test_preemption_never_clobbers_boundary_checkpoint(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    sym = _fc_symbol()
    mgr.save(2, symbol=sym, arg_params=_fc_params(1.0), epoch=2,
             blocking=True)
    mgr.set_live_capture(lambda: dict(step=2, symbol=sym,
                                      arg_params=_fc_params(0.0), epoch=2))
    _sigterm(mgr)
    meta = tmx.checkpoint.read_meta(layout.step_path(str(tmp_path), 2))
    assert not meta.get("mid_epoch")
    np.testing.assert_array_equal(
        mgr.restore(step=2).arg_params["fc_weight"].asnumpy(),
        np.ones((2, 4), np.float32))


def test_preemption_hook_flushes_final_checkpoint(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    sym = _fc_symbol()
    mgr.set_live_capture(lambda: dict(step=6, symbol=sym,
                                      arg_params=_fc_params(1.0), epoch=6))
    _sigterm(mgr)
    meta = tmx.checkpoint.read_meta(tmx.checkpoint.latest_checkpoint(
        str(tmp_path)))
    assert meta["step"] == 6 and meta["mid_epoch"] and meta["preempted"]


def test_preemption_notice_tightens_cadence(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path), save_period=5)
    assert mgr.effective_save_period() == 5
    assert mgr.preemption_notice() is None
    sym = _fc_symbol()
    mgr.set_live_capture(lambda: dict(step=7, symbol=sym,
                                      arg_params=_fc_params(1.0), epoch=7))
    handle = mgr.notify_preemption(deadline_s=120.0)
    assert mgr.effective_save_period() == 1
    assert 0.0 < mgr.preemption_notice() <= 120.0
    handle.wait(30.0)
    meta = tmx.checkpoint.read_meta(tmx.checkpoint.latest_checkpoint(
        str(tmp_path)))
    assert meta["step"] == 7 and meta["mid_epoch"] and meta["preempted"]
    assert mgr.notify_preemption(deadline_s=60.0) is None


def test_preemption_notice_deadline_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PREEMPT_NOTICE_S", "42.5")
    monkeypatch.setenv("MXNET_CHECKPOINT_KEEP_LAST", "3")
    monkeypatch.setenv("MXNET_CHECKPOINT_PERIOD", "4")
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    assert (mgr.keep_last_n, mgr.save_period) == (3, 4)
    assert mgr.notify_preemption() is None
    assert 0.0 < mgr.preemption_notice() <= 42.5
    assert mgr.effective_save_period() == 1


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

def test_legacy_checkpoint_import(tmp_path):
    sym = _fc_symbol()
    args = {"fc_weight": tmx.nd.array(np.arange(8, dtype=np.float32)
                                      .reshape(2, 4), ctx=tmx.cpu()),
            "fc_bias": tmx.nd.zeros((2,), ctx=tmx.cpu())}
    prefix = str(tmp_path / "legacy")
    tmx.model.save_checkpoint(prefix, 3, sym, args, {})
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path / "managed"))
    mgr.import_legacy(prefix, 3)
    r = mgr.restore()
    assert r.step == 3 and r.meta["legacy_source"].endswith("legacy")
    np.testing.assert_array_equal(r.arg_params["fc_weight"].asnumpy(),
                                  args["fc_weight"].asnumpy())
    assert r.symbol.tojson() == sym.tojson()


def test_legacy_optimizer_state_payloads():
    opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    updater = tmx.optimizer.get_updater(opt)
    blob = pickle.dumps({0: np.full((2, 2), 3.0, np.float32)})
    assert ckpt_state.apply_updater_payload(updater, blob,
                                            ctx=tmx.cpu()) is None
    np.testing.assert_array_equal(updater.states[0].asnumpy(),
                                  np.full((2, 2), 3.0, np.float32))
    opt2 = jmx.optimizer.SGD(learning_rate=0.5)
    opt2.num_update = 17
    blob2 = pickle.dumps(({1: np.ones((2,), np.float32)}, opt2))
    restored = ckpt_state.apply_updater_payload(updater, blob2)
    assert type(restored) is tmx.optimizer.SGD and restored.num_update == 17
    assert opt.num_update == 17
    np.testing.assert_array_equal(updater.states[1].asnumpy(),
                                  np.ones((2,), np.float32))
    with pytest.raises(MXNetError, match="may not hold"):
        ckpt_state.loads(pickle.dumps(threading.Event))


def test_multi_precision_slots_roundtrip():
    def make():
        return tmx.optimizer.get_updater(tmx.optimizer.SGD(
            learning_rate=0.1, momentum=0.9, multi_precision=True))
    updater = make()
    w16 = tmx.nd.array(np.ones((4, 2)), ctx=tmx.cpu(), dtype=np.float16)
    g16 = tmx.nd.array(np.full((4, 2), 0.5), ctx=tmx.cpu(),
                       dtype=np.float16)
    updater(0, g16, w16)
    blob = ckpt_state.updater_payload_bytes(updater, dump_optimizer=True)
    updater2 = make()
    ckpt_state.apply_updater_payload(updater2, blob, ctx=tmx.cpu())
    master, mom = updater2.states[0]
    assert master.dtype == np.float32
    np.testing.assert_array_equal(master.asnumpy(),
                                  updater.states[0][0].asnumpy())
    np.testing.assert_array_equal(mom.asnumpy(),
                                  updater.states[0][1].asnumpy())


@pytest.mark.parametrize("kvstore", ["local", "tpu_sync"])
def test_module_optimizer_state_files(tmp_path, monkeypatch, kvstore):
    """``save_optimizer_states`` then ``Module.load(...,
    load_optimizer_states=True)``: the loaded module continues as the
    saving one does."""
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    it = _train_iter(shuffle=False)
    batches = list(it)
    mod = _module()
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Uniform(0.1))
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=_opt_params(tmx, "sgd"))
    for b in batches[:3]:
        mod.forward_backward(b)
        mod.update()
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    loaded = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=tmx.cpu())
    loaded.bind(it.provide_data, it.provide_label)
    loaded.init_optimizer(kvstore=kvstore, optimizer="sgd",
                          optimizer_params=_opt_params(tmx, "sgd"))
    assert loaded._optimizer.num_update == mod._optimizer.num_update == 3
    for b in batches[3:]:
        for m in (mod, loaded):
            m.forward_backward(b)
            m.update()
    _assert_same_run(loaded, mod)


def _reference_dir(tmp_path):
    d = str(tmp_path / "jax")
    mgr = jmx.checkpoint.CheckpointManager(d)
    rng = np.random.RandomState(2)
    args = {"fc_weight": rng.rand(2, 4).astype(np.float32),
            "fc_bias": rng.rand(2).astype(np.float32)}
    mgr.save(4, symbol=_fc_symbol(jmx),
             arg_params={k: jmx.nd.array(v) for k, v in args.items()},
             epoch=4, blocking=True)
    return d, args


def test_checkpoint_params_cross_both_ways(tmp_path):
    d, args = _reference_dir(tmp_path)
    r = tmx.checkpoint.CheckpointManager(d).restore()
    assert r.step == 4 and r.symbol.tojson() == _fc_symbol().tojson()
    for k, v in args.items():
        np.testing.assert_array_equal(r.arg_params[k].asnumpy(), v)
    d2 = str(tmp_path / "port")
    tmx.checkpoint.CheckpointManager(d2).save(
        6, symbol=_fc_symbol(), epoch=6, blocking=True,
        arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                    for k, v in args.items()})
    r2 = jmx.checkpoint.CheckpointManager(d2).restore()
    assert r2.step == 6
    for k, v in args.items():
        np.testing.assert_array_equal(r2.arg_params[k].asnumpy(), v)


@pytest.mark.parametrize("kvstore", ["local", "tpu_sync"])
def test_reference_fit_resumes_in_the_port(tmp_path, kvstore):
    d = str(tmp_path / "ckpt")
    np.random.seed(3)
    _fit(_module(jmx), 2, jmx.checkpoint.CheckpointManager(d), mx=jmx,
         kvstore=kvstore)
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    np.random.seed(5)
    want = _module(jmx)
    _fit(want, 4, jmx.checkpoint.CheckpointManager(d), mx=jmx,
         kvstore=kvstore)
    np.random.seed(5)
    got = _module()
    _fit(got, 4, tmx.checkpoint.CheckpointManager(copy), kvstore=kvstore)
    assert got._optimizer.num_update == want._optimizer.num_update
    w = {k: v.asnumpy() for k, v in want.get_params()[0].items()}
    for k, v in _params_np(got).items():
        err = np.linalg.norm(v - w[k]) / np.linalg.norm(w[k])
        assert err <= CROSS_TOL, (k, err)


# ---------------------------------------------------------------------------
# callbacks, supervisor, serving
# ---------------------------------------------------------------------------

def test_do_checkpoint_routes_through_manager(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    cb = tmx.callback.do_checkpoint(mgr, period=2, background=True)
    sym = _fc_symbol()
    for epoch in range(4):
        cb(epoch, sym, _fc_params(float(epoch)), {})
    cb.wait(timeout=60)
    assert mgr.all_steps() == [1, 3]
    assert mgr.restore().epoch == 3


def test_supervisor_restart_resumes_bit_for_bit(tmp_path, monkeypatch):
    """An injected ``train.step`` fault in epoch 1 restarts the supervised
    fit from epoch 0's checkpoint: it ends as the clean supervised run."""
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    monkeypatch.setenv("MXNET_TPU_RETRY_BASE_MS", "1")
    sup_cls = tmx.resilience.TrainingSupervisor
    np.random.seed(3)
    tmx.random.seed(7)
    want = _module()
    _fit(want, 3, tmx.checkpoint.CheckpointManager(str(tmp_path / "clean")),
         kvstore="tpu_sync", supervisor=sup_cls())
    faults.configure("train.step:step=11:times=1:raise=OSError,injected")
    try:
        np.random.seed(3)
        tmx.random.seed(7)
        sup = sup_cls(manager=tmx.checkpoint.CheckpointManager(
            str(tmp_path / "faulty")))
        got = _module()
        _fit(got, 3, kvstore="tpu_sync", supervisor=sup)
    finally:
        faults.reset()
    assert sup.restarts == 1
    _assert_same_run(got, want)


def _fc_engine(mx, w, **kw):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=w.shape[0], name="fc",
                               no_bias=True)
    return fc, mx.serving.InferenceEngine(
        fc, {"fc_weight": mx.nd.array(w, ctx=mx.cpu())}, ctx=mx.cpu(),
        async_worker=False, **kw)


def test_serving_reload_from_hot_swap(tmp_path):
    w1, w2 = np.ones((2, 3), np.float32), 2 * np.ones((2, 3), np.float32)
    fc, eng = _fc_engine(tmx, w1)
    x = np.ones((1, 3), np.float32)
    np.testing.assert_allclose(np.asarray(eng.predict({"data": x})), 3.0)
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(5, symbol=fc, arg_params={"fc_weight": tmx.nd.array(
        w2, ctx=tmx.cpu())}, blocking=True)
    assert eng.reload_from(str(tmp_path)) == 5
    np.testing.assert_allclose(np.asarray(eng.predict({"data": x})), 6.0)
    assert eng.reload_from(str(tmp_path)) is None
    mgr.save(9, symbol=fc, arg_params={"fc_weight": tmx.nd.array(
        w1, ctx=tmx.cpu())}, blocking=True)
    assert eng.reload_from(str(tmp_path)) == 9
    np.testing.assert_allclose(np.asarray(eng.predict({"data": x})), 3.0)
    eng.stop()


def _await(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_serving_reload_polls_in_background(tmp_path):
    _, eng = _fc_engine(tmx, np.ones((1, 2), np.float32))
    eng.reload_from(str(tmp_path), poll_interval=0.05)
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, arg_params={"fc_weight": tmx.nd.full((1, 2), 5.0,
                                                     ctx=tmx.cpu())},
             blocking=True)
    assert _await(lambda: eng._reload_step == 1)
    thread = eng._reload_thread
    eng.stop()   # joins the poller
    assert not thread.is_alive() and eng._reload_thread is None
    eng.reload_from(str(tmp_path), poll_interval=0.05)
    mgr.save(2, arg_params={"fc_weight": tmx.nd.full((1, 2), 7.0,
                                                     ctx=tmx.cpu())},
             blocking=True)
    assert _await(lambda: eng._reload_step == 2)
    np.testing.assert_allclose(
        np.asarray(eng.predict({"data": np.ones((1, 2), np.float32)})), 14.0)
    eng.stop()


def test_model_server_reload_from(tmp_path):
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=2, name="fc", no_bias=True)
    server = tmx.serving.ModelServer()
    server.register("m", fc, {"fc_weight": np.ones((2, 3), np.float32)},
                    ctx=tmx.cpu(), replicas=2, async_worker=False)
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(3, arg_params={"fc_weight": tmx.nd.full((2, 3), 2.0,
                                                     ctx=tmx.cpu())},
             blocking=True)
    try:
        assert server.reload_from("m", str(tmp_path), poll_interval=0.05) \
            == 3
        x = {"data": np.ones((1, 3), np.float32)}
        for _ in range(2):   # both replicas
            np.testing.assert_allclose(np.asarray(server.predict("m", x)),
                                       6.0)
        assert 3 in server.stats()["m"]["versions"] or \
            "3" in server.stats()["m"]["versions"]
        mgr.save(4, arg_params={"fc_weight": tmx.nd.full((2, 3), 3.0,
                                                         ctx=tmx.cpu())},
                 blocking=True)
        assert _await(lambda: server._models["m"].reload_step == 4)
        np.testing.assert_allclose(np.asarray(server.predict("m", x)), 9.0)
    finally:
        thread = server._pollers["m"][0]
        server.stop()
    assert not thread.is_alive()
