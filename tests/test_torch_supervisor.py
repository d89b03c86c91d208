"""The supervised training slice held against the JAX package on the CPU.

- ``TrainingSupervisor``'s state machine: the same verdict sequence
  through both packages' supervisors gives the same loss scale, streaks,
  counters and ``NumericDivergence`` after every step (exactly: the same
  float and int values), the scale cap included, and ``state_dict``
  round trips the same.
- ``DataParallelTrainStep(supervise=True)``, fused (kernel #7's plain
  version with the verdict) and unfused, against the JAX step on the
  reference test's toy MLP with a BatchNorm layer and on LeNet, both
  started from one numpy dict: 4 steps at scales 1, 8, NaN and 2. After
  each step the outputs, the verdict, params, slots and BatchNorm
  statistics agree within 1e-4 of each leaf's max abs (the tolerance of
  ``test_torch_symbolic.py``); the NaN step's verdict is false in both
  and the port's params, slots and statistics keep every bit.
- At scale 1.0 the supervised step is bit for bit the unsupervised one,
  fused and unfused; in bf16 and float16 compute a power-of-two scale is
  bit for bit the unscaled step where nothing overflows (the reference's
  ``test_bf16_scaled_run_is_bit_identical_to_unsupervised``).
- A gradient whose float32 sum of squares overflows (every value finite)
  gives a false verdict in both packages; so does a float16 step at a
  scale of 2^16, whose float16 seed is inf in both (the reference's
  behaviour, kept).
- A loss head's gradient under a seed of ``s`` is exactly ``s`` times its
  gradient under ones (the port's ``_LossOp``), and within the symbolic
  tolerance of the reference's ``_loss_op``.
- ``Module.fit(supervisor=...)`` with ``train.nan`` at step 2 gives the
  same supervisor counters in both packages and final params within the
  step tolerance; float32 and bf16 (its loss scale backs off and regrows
  as the reference's).
- ``warmup`` changes no state and the first step then adds no on-demand
  program; the Module under ``MXNET_TPU_TRAIN_AOT`` warms its step up.
- ``ShardedTrainStep(skip_nonfinite=True)``: a NaN batch leaves params
  and slots bit for bit, unfused and fused (kernel #7's CUDA source under
  the host emulator, the verdict read through its pointer).
"""
import math

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401 (jmx.models)
import mxnet_tpu.models.resnet as jres
from mxnet_tpu import profiler as jprof
from mxnet_tpu.parallel.tpu_step import DataParallelTrainStep as JaxStep
from mxnet_tpu.resilience import NumericDivergence as JaxDivergence
from mxnet_tpu.resilience import TrainingSupervisor as JaxSupervisor
from mxnet_tpu.resilience import faults as jfaults

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.models.resnet as tres
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.kernels import _emulate
from mxnet_tpu_torch.kernels import opt_update as tou
from mxnet_tpu_torch.parallel import ShardedTrainStep
from mxnet_tpu_torch.resilience import (NumericDivergence, TrainingStalled,
                                        TrainingSupervisor, faults)
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEP_TOL = 1e-4
SCALES = (1.0, 8.0, float("nan"), 2.0)
CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _clean_fault_state():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _both(build):
    """The same graph built in both packages (``build(mx)``; fresh name
    scopes, so auto names match)."""
    with jmx.name.NameManager():
        js = build(jmx)
    with tmx.name.NameManager():
        ts = build(tmx)
    return js, ts


def _mlp(S, bn=False):
    """The reference test's toy MLP (test_supervisor.py:39-45), with a
    BatchNorm layer after its first layer when ``bn`` (and that layer
    then without a bias, whose gradient BatchNorm makes zero: its slot
    would hold rounding noise alone)."""
    h = S.FullyConnected(S.Variable("data"), num_hidden=8, no_bias=bn,
                         name="sv_fc1")
    if bn:
        h = S.BatchNorm(h, fix_gamma=False, name="sv_bn")
    h = S.Activation(h, act_type="relu")
    h = S.FullyConnected(h, num_hidden=3, name="sv_fc2")
    return S.SoftmaxOutput(h, name="softmax")


def _toy(n=64, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    return X, y


NETS = {
    "mlp_bn": (lambda mx: _mlp(mx.sym, bn=True), (8, 6), 3),
    "lenet": (lambda mx: mx.models.get_symbol("lenet", num_classes=10),
              (4, 1, 28, 28), 10),
}
OPTS = {"sgd": dict(lr=0.05, momentum=0.9, wd=1e-4),
        "adam": dict(lr=0.01, optimizer="adam", wd=1e-4,
                     opt_hp={"beta1": 0.9, "beta2": 0.999, "eps": 1e-8})}
CASES = [("mlp_bn", "sgd"), ("lenet", "sgd"), ("mlp_bn", "adam")]


def _values(sym, data_shape, classes, seed):
    rng = np.random.RandomState(seed)
    shapes = {"data": data_shape, "softmax_label": (data_shape[0],)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: (rng.normal(size=s) * (np.prod(s[1:]) ** -0.5 if len(s) > 1
                                      else 0.1)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batches = [{"data": rng.normal(size=data_shape).astype(np.float32),
                "softmax_label": rng.randint(0, classes, data_shape[0])
                .astype(np.float32)} for _ in SCALES]
    return shapes, args, aux, batches


def _slot_values(opt_state, to_np):
    out = {}
    for slot in ("m", "v", "mom"):
        for n, v in (opt_state.get(slot) or {}).items():
            out[slot + ":" + n] = to_np(v)
    return out


@pytest.fixture(scope="module")
def reference_steps():
    """The supervised JAX step per case: per step (outputs, verdict,
    params, slots, aux)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    runs = {}
    for net, opt in CASES:
        build, dshape, classes = NETS[net]
        js, _ = _both(build)
        shapes, args, aux, batches = _values(js, dshape, classes, 3)
        step = JaxStep(js, mesh, supervise=True, **OPTS[opt]).init_from(
            args, aux, shapes)
        trace = []
        for b, s in zip(batches, SCALES):
            outs = step(b, scale=s)
            params, aux_now = step.export_params()
            trace.append((np.asarray(outs[0]), bool(step.last_flag), params,
                          _slot_values(step.opt_state, np.asarray), aux_now))
        runs[net, opt] = (shapes, args, aux, batches, trace)
    return runs


def _port_step(net, opt, shapes, args, aux, **kw):
    _, ts = _both(NETS[net][0])
    return tmx.DataParallelTrainStep(ts, device="cpu", **OPTS[opt],
                                     **kw).init_from(args, aux, shapes)


def _state(step):
    params, aux = step.export_params()
    return params, _slot_values(step.opt_state, lambda t: t.detach().numpy()
                                .copy()), aux


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _same_bits(a, b):
    a, b = (np.ascontiguousarray(x).reshape(-1) for x in (a, b))
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("net,opt", CASES)
def test_supervised_step_matches_reference(reference_steps, net, opt,
                                           fused):
    shapes, args, aux, batches, trace = reference_steps[net, opt]
    step = _port_step(net, opt, shapes, args, aux, supervise=True,
                      fused_optupdate=fused)
    worst = 0.0
    for b, s, (out, good, params, slots, aux_now) in zip(batches, SCALES,
                                                         trace):
        before = _state(step)
        got = step(b, scale=s)
        assert bool(step.last_flag) is good is (not math.isnan(s))
        after = _state(step)
        if not good:
            # the skipped step: every param, slot and statistic keeps its
            # bits
            for was, now in zip(before, after):
                assert sorted(was) == sorted(now)
                for k in was:
                    assert _same_bits(was[k], now[k]), k
            continue
        worst = max(worst, _rel_err(got[0].numpy(), out))
        for got_d, want_d in zip(after, (params, slots, aux_now)):
            assert sorted(got_d) == sorted(want_d)
            for k in want_d:
                worst = max(worst, _rel_err(got_d[k], want_d[k]))
    assert worst <= STEP_TOL, worst


@pytest.mark.parametrize("fused", [True, False])
def test_scale_one_is_bitwise_unsupervised(reference_steps, fused):
    shapes, args, aux, batches, _ = reference_steps["lenet", "sgd"]
    plain = _port_step("lenet", "sgd", shapes, args, aux,
                       fused_optupdate=fused)
    sup = _port_step("lenet", "sgd", shapes, args, aux, supervise=True,
                     fused_optupdate=fused)
    for b in batches:
        a, c = plain(b), sup(b)
        assert bool(sup.last_flag)
        assert _same_bits(a[0].numpy(), c[0].numpy())
    for x, y in zip(_state(plain), _state(sup)):
        assert sorted(x) == sorted(y)
        for k in x:
            assert _same_bits(x[k], y[k]), k


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_power_of_two_scale_is_bitwise_unscaled(reference_steps, dtype):
    """Scaling the seed by 2^k and the gradients by 2^-k is exact in the
    16-bit compute dtypes while nothing overflows: every bit of the
    scaled step is the unscaled one's."""
    shapes, args, aux, batches, _ = reference_steps["mlp_bn", "sgd"]
    plain = _port_step("mlp_bn", "sgd", shapes, args, aux,
                       compute_dtype=dtype, fused_optupdate=True)
    sup = _port_step("mlp_bn", "sgd", shapes, args, aux, supervise=True,
                     compute_dtype=dtype, fused_optupdate=True)
    for b, s in zip(batches, (2.0 ** 4, 2.0 ** 10, 2.0 ** 7, 2.0 ** 3)):
        a, c = plain(b), sup(b, scale=s)
        assert bool(sup.last_flag)
        assert a[0].dtype == getattr(torch, dtype)
        assert torch.equal(a[0], c[0])
    for x, y in zip(_state(plain), _state(sup)):
        for k in x:
            assert _same_bits(x[k], y[k]), k


def test_overflowing_sum_of_squares_is_bad_in_both():
    """Inputs near 1e20 give finite gradients near 1e20 whose squares
    overflow float32: both packages call the step bad."""
    js, ts = _both(lambda mx: _mlp(mx.sym))
    X, y = _toy(8)
    shapes = {"data": X.shape, "softmax_label": y.shape}
    _, args, aux, _ = _values(js, X.shape, 3, 4)
    batch = {"data": X * np.float32(1e20), "softmax_label": y}
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jstep = JaxStep(js, mesh, supervise=True, lr=0.05).init_from(
        args, aux, shapes)
    jout = jstep(batch)
    tstep = tmx.DataParallelTrainStep(ts, lr=0.05, supervise=True,
                                      device="cpu").init_from(args, aux,
                                                              shapes)
    before = _state(tstep)
    tout = tstep(batch)
    assert np.isfinite(np.asarray(jout[0])).all()
    assert torch.isfinite(tout[0]).all()
    assert not bool(jstep.last_flag) and not bool(tstep.last_flag)
    for was, now in zip(before, _state(tstep)):
        for k in was:
            assert _same_bits(was[k], now[k]), k


def test_float16_seed_overflows_at_2_16_in_both():
    """The reference seeds ``full(o.shape, s32.astype(o.dtype))``: at a
    scale of 2^16 or more a float16 output's seed is inf (float16 tops out
    at 65504) although the supervisor's cap is 2^24, so such a step is
    bad in both packages and the scale backs off; at 2^8 the same step
    is good (at 2^15 this model's float16 weight gradients overflow
    too)."""
    js, ts = _both(lambda mx: _mlp(mx.sym))
    X, y = _toy(8)
    shapes = {"data": X.shape, "softmax_label": y.shape}
    _, args, aux, _ = _values(js, X.shape, 3, 4)
    batch = {"data": X, "softmax_label": y}
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    verdicts = []
    for make in (lambda: JaxStep(js, mesh, supervise=True, lr=0.05,
                                 compute_dtype="float16"),
                 lambda: tmx.DataParallelTrainStep(
                     ts, lr=0.05, supervise=True, compute_dtype="float16",
                     device="cpu")):
        step = make().init_from(args, aux, shapes)
        for s in (2.0 ** 16, 2.0 ** 8):
            step(batch, scale=s)
            verdicts.append(bool(step.last_flag))
    assert verdicts == [False, True, False, True]
    sup = TrainingSupervisor(loss_scale=2.0 ** 16)
    sup.observe_step(False)
    assert sup.loss_scale == 2.0 ** 15


def _narrow_resnet(mx):
    """The models' ResNet v2 (BatchNorm before each convolution, a global
    average pool, SoftmaxOutput) narrowed to 4-16 channels, one unit a
    stage, 10 classes, on 16 x 16 images."""
    res = jres if mx is jmx else tres
    return res.resnet(units=[1, 1, 1], num_stages=3,
                      filter_list=[4, 4, 8, 16], num_classes=10,
                      image_shape=(3, 16, 16), bottle_neck=False)


def test_float16_resnet_diverges_at_the_default_limit_in_both():
    """MXNet's gradients are sums over the batch (rescale_grad divides
    only in the update), so a float16 ResNet's weight gradients pass
    65504 at large loss scales. On this batch of 64 both packages call
    every step from 2^15 down to 2^13 bad and 2^12 good, so the fit's
    loop from the default scale (2^15 for a float16 step) with the
    default limit of 3 bad steps in a row raises NumericDivergence in
    both, at scale 2^12; a limit of 4 reaches 2^12 and trains on."""
    js, ts = _both(_narrow_resnet)
    rng = np.random.RandomState(0)
    shapes = {"data": (64, 3, 16, 16), "softmax_label": (64,)}
    arg_shapes, _, aux_shapes = js.infer_shape(**shapes)
    args = {}
    for n, shp in zip(js.list_arguments(), arg_shapes):
        if n.endswith("_gamma"):
            args[n] = np.ones(shp, np.float32)
        elif n.endswith("_beta") or n.endswith("_bias"):
            args[n] = np.zeros(shp, np.float32)
        elif n not in shapes:
            args[n] = (rng.normal(size=shp) * np.sqrt(2.0 / np.prod(
                shp[1:]))).astype(np.float32)
    aux = {n: (np.ones if "var" in n else np.zeros)(shp, np.float32)
           for n, shp in zip(js.list_auxiliary_states(), aux_shapes)}
    batch = {"data": rng.normal(size=shapes["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 64).astype(np.float32)}
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    runs = {}
    for name, make, sup_cls, div_cls in (
            ("jax", lambda: JaxStep(js, mesh, lr=0.05, momentum=0.9,
                                    supervise=True, compute_dtype="float16"),
             JaxSupervisor, JaxDivergence),
            ("port", lambda: tmx.DataParallelTrainStep(
                ts, lr=0.05, momentum=0.9, supervise=True,
                compute_dtype="float16", device="cpu"),
             TrainingSupervisor, NumericDivergence)):
        step = make().init_from(args, aux, shapes)
        verdicts = []
        for k in range(15, 9, -1):
            step(batch, scale=2.0 ** k)
            verdicts.append(bool(step.last_flag))
        trails = []
        for limit in (None, 4):
            sup = sup_cls(bad_steps_limit=limit)
            sup.attach_step(step)
            trail = []
            try:
                while len(trail) < 5:
                    trail.append(sup.loss_scale)
                    step(batch, scale=sup.loss_scale)
                    sup.observe_step(bool(step.last_flag))
            except div_cls:
                trail.append("diverged at %g" % sup.loss_scale)
            trails.append(trail)
        runs[name] = verdicts, trails
    assert runs["port"] == runs["jax"]
    assert runs["port"] == ([False] * 3 + [True] * 3, [
        [2.0 ** 15, 2.0 ** 14, 2.0 ** 13, "diverged at 4096"],
        [2.0 ** 15, 2.0 ** 14, 2.0 ** 13, 2.0 ** 12, 2.0 ** 12]])


def test_loss_head_takes_the_seed_multiplicatively():
    """SoftmaxOutput's gradient under a seed of s is s times its gradient
    under ones, bit for bit (s a power of two), and the reference's
    within the symbolic tolerance."""
    js, ts = _both(lambda mx: mx.sym.SoftmaxOutput(mx.sym.Variable("x"),
                                                   name="softmax"))
    rng = np.random.RandomState(2)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    label = np.array([0, 3, 1, 4], np.float32)
    grads = {}
    for name, mx, sym, ctx in (("jax", jmx, js, jmx.cpu()),
                               ("port", tmx, ts, CPU)):
        exe = sym.simple_bind(ctx, grad_req="write", x=x.shape,
                              softmax_label=label.shape)
        exe.arg_dict["x"][:] = x
        exe.arg_dict["softmax_label"][:] = label
        for s in (1.0, 2.0 ** 15):
            exe.forward(is_train=True)
            exe.backward(out_grads=mx.nd.array(np.full((4, 5), s,
                                                       np.float32),
                                               ctx=ctx))
            grads[name, s] = exe.grad_dict["x"].asnumpy()
    assert _same_bits(grads["port", 2.0 ** 15],
                      (grads["port", 1.0] * np.float32(2.0 ** 15)))
    for s in (1.0, 2.0 ** 15):
        np.testing.assert_allclose(grads["port", s], grads["jax", s],
                                   rtol=2e-4, atol=2e-4 * s)


# ------------------------------------------------------ the state machine --

PLANS = {
    # (loss_scale, scale_window, bad_steps_limit, compute dtype, verdicts)
    "fp32_exact_one": (None, 1, 10, None, [1, 1, 1, 0, 1, 1]),
    "backoff_regrow": (2.0 ** 15, 2, 10, None, [1, 1, 0, 1, 0, 1, 1, 1, 1]),
    "cap": (2.0 ** 23, 1, 10, None, [1, 1, 1, 0, 1]),
    "divergence": (None, 200, 3, None, [0, 0, 1, 0, 0, 0, 1]),
    "bf16_default": (None, 3, 4, "bfloat16", [1, 0, 0, 1, 1, 1, 1, 1, 1, 0]),
}


def _drive(sup_cls, div_cls, prof, plan):
    scale, window, limit, cdt, verdicts = plan
    prof.supervisor_counters(reset=True)
    sup = sup_cls(loss_scale=scale, scale_window=window,
                  bad_steps_limit=limit)

    class _Step:
        compute_dtype = cdt
    sup.attach_step(_Step())
    trail = []
    for good in verdicts:
        try:
            sup.observe_step(bool(good))
            raised = False
        except div_cls:
            raised = True
        trail.append((sup.loss_scale, sup.clean_streak, sup.bad_streak,
                      sup.bad_steps, sup.steps, raised))
        if raised:
            break
    return trail, prof.supervisor_counters(), sup.state_dict()


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_state_machine_matches_reference(plan):
    want = _drive(JaxSupervisor, JaxDivergence, jprof, PLANS[plan])
    got = _drive(TrainingSupervisor, NumericDivergence, tprof, PLANS[plan])
    assert got == want
    scales = [t[0] for t in got[0]]
    assert all(s == 2.0 ** int(math.log2(s)) for s in scales)
    assert max(scales) <= TrainingSupervisor._SCALE_MAX


def test_state_dict_round_trip_matches_reference():
    out = []
    for sup_cls, prof in ((JaxSupervisor, jprof),
                          (TrainingSupervisor, tprof)):
        prof.supervisor_counters(reset=True)
        a = sup_cls(loss_scale=2.0 ** 12)
        a.observe_step(True)
        a.observe_step(False)
        b = sup_cls()
        b.load_state(a.state_dict())

        class _Step:
            compute_dtype = "bfloat16"
        b.attach_step(_Step())   # a restored scale is not re-derived
        b.load_state({})         # an empty state changes nothing
        out.append((a.state_dict(), b.state_dict(),
                    prof.supervisor_counters()["resumes"]))
    assert out[0] == out[1]
    assert out[1][0] == out[1][1]


def test_stall_deadline_raises_typed():
    sup = TrainingSupervisor(step_deadline_s=0.05)
    tprof.supervisor_counters(reset=True)

    class _NeverReady:
        def query(self):
            return False
    with pytest.raises(TrainingStalled):
        sup.await_ready(_NeverReady(), None)
    assert tprof.supervisor_counters()["stalls"] == 1
    assert not TrainingSupervisor()._backoff.is_retryable(
        NumericDivergence("x"))
    assert TrainingSupervisor()._backoff.is_retryable(TrainingStalled("x"))


def test_restart_drops_failed_attempts_inflight_steps():
    from collections import deque

    class _StubModule:
        def __init__(self):
            self._inflight = deque([("stale-event", "stale-flag")])
            self.calls = 0

        def fit(self, **kwargs):
            assert kwargs["supervisor"] is False
            self.calls += 1
            if self.calls == 1:
                raise TrainingStalled("wedged")

    mod = _StubModule()
    sup = TrainingSupervisor(max_restarts=1)
    sup._backoff.base_delay_s = sup._backoff.cap_delay_s = 0.0
    sup.run_fit(mod, {})
    assert mod.calls == 2 and not mod._inflight and sup.restarts == 1


# ------------------------------------------------------------ Module.fit ---

def _mlp_args(seed):
    """Numpy params of the toy MLP, seeded: both packages start there."""
    with jmx.name.NameManager():
        return _values(_mlp(jmx.sym), (8, 6), 3, seed)[1]


def _fit(mx, sup, args, cdt=None, num_epoch=2):
    X, y = _toy()
    with mx.name.NameManager():
        sym = _mlp(mx.sym)
    np.random.seed(7)
    it = mx.io.NDArrayIter(X, y, batch_size=8, shuffle=True,
                           label_name="softmax_label")
    ctx = {} if mx is jmx else {"context": CPU}
    mod = mx.mod.Module(sym, **ctx)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    if cdt:
        opt["multi_precision"] = True
    arg = {k: mx.nd.array(v, **({} if mx is jmx else {"ctx": CPU}))
           for k, v in args.items()}
    mod.fit(it, num_epoch=num_epoch, kvstore="tpu_sync", optimizer="sgd",
            optimizer_params=opt, arg_params=arg, supervisor=sup)
    params, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in params.items()}


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_fit_with_nan_at_step_2_matches_reference(cdt, monkeypatch):
    args = _mlp_args(5)
    spec = "train.nan:step=2:raise=FaultInjected"
    out = []
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    for mx, sup_cls, prof, flt in ((jmx, JaxSupervisor, jprof, jfaults),
                                   (tmx, TrainingSupervisor, tprof,
                                    faults)):
        flt.configure(spec)
        prof.supervisor_counters(reset=True)
        sup = sup_cls(scale_window=4)
        _, params = _fit(mx, sup, args, cdt)
        out.append((prof.supervisor_counters(), sup.state_dict(), params))
        flt.reset()
    (jc, jstate, jparams), (tc, tstate, tparams) = out
    assert tc == jc and tstate == jstate
    assert tc["bad_steps"] == 1 and tc["steps"] == 16
    if cdt:
        # 2^15, halved by the bad step, regrown at clean streaks 4, 8, 12
        assert tc["scale_backoffs"] == 1 and tc["scale_regrows"] == 3
        assert tstate["loss_scale"] == 2.0 ** 17
    worst = max(_rel_err(tparams[k], jparams[k]) for k in jparams)
    assert worst <= (STEP_TOL if cdt is None else 2e-2), worst


def test_clean_supervised_fit_is_bitwise_unsupervised():
    args = _mlp_args(6)
    _, plain = _fit(tmx, False, args)
    _, sup = _fit(tmx, TrainingSupervisor(), args)
    for k in plain:
        assert _same_bits(plain[k], sup[k]), k


def test_consecutive_nan_steps_raise_numeric_divergence():
    args = _mlp_args(6)
    faults.configure("train.nan:after=1:raise=FaultInjected")
    tprof.supervisor_counters(reset=True)
    with pytest.raises(NumericDivergence):
        _fit(tmx, TrainingSupervisor(bad_steps_limit=3), args)
    assert tprof.supervisor_counters()["divergences"] == 1


def test_supervising_a_prebound_module_rebuilds_the_fused_step(caplog):
    args = _mlp_args(6)
    mod, _ = _fit(tmx, False, args, num_epoch=1)
    assert not mod._fused_step.supervise
    X, y = _toy()
    it = tmx.io.NDArrayIter(X, y, batch_size=8)
    tprof.supervisor_counters(reset=True)
    mod.fit(it, num_epoch=1, kvstore="tpu_sync",
            optimizer_params={"learning_rate": 0.05},
            supervisor=TrainingSupervisor())
    assert mod._fused_step.supervise
    assert tprof.supervisor_counters()["steps"] == 8
    assert "rebuilding the fused step" in caplog.text
    # a checkpoint manager is ported since: the fit's is adopted
    # (tests/test_torch_checkpoint.py resumes through it)
    manager = object()
    assert TrainingSupervisor(manager=manager).manager is manager


def test_warmup_changes_no_state_and_first_step_is_known(reference_steps,
                                                         monkeypatch):
    shapes, args, aux, batches, _ = reference_steps["mlp_bn", "sgd"]
    step = _port_step("mlp_bn", "sgd", shapes, args, aux, supervise=True)
    before = _state(step)
    tprof.compile_counters(reset=True)
    spec = step.abstract_step_args({"softmax_label": np.float32})
    assert all(t.device.type == "meta" for t in spec[-2:])
    assert spec[-1].shape == () and spec[-1].dtype == torch.float32
    assert step.warmup() is step
    for was, now in zip(before, _state(step)):
        for k in was:
            assert _same_bits(was[k], now[k]), k
    step(batches[0])
    site = tprof.compile_counters()["sites"]["train.fused_step"]
    assert site.pop("compile_ms") >= 0.0   # the build's wall
    assert site == {"compiles": 1, "aot": 1, "ondemand": 0, "cache_hits": 0}
    assert step.program_count() == 1
    # the Module warms its step up at build (MXNET_TPU_TRAIN_AOT=1)
    args = _mlp_args(6)
    tprof.compile_counters(reset=True)
    _fit(tmx, False, args, num_epoch=1)
    assert tprof.compile_counters()["sites"]["train.fused_step"][
        "ondemand"] == 0
    monkeypatch.setenv("MXNET_TPU_TRAIN_AOT", "0")
    tprof.compile_counters(reset=True)
    _fit(tmx, False, args, num_epoch=1)
    assert tprof.compile_counters()["sites"]["train.fused_step"][
        "aot"] == 0


# --------------------------------------------- ShardedTrainStep's carry ----

@pytest.fixture
def routed(monkeypatch):
    """CPU tensors take kernel #7's CUDA route, into its emulated build."""
    if _emulate.compiler() is None:
        pytest.skip("no g++ on this host to build the emulated kernel")
    monkeypatch.setattr(tou, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tou, "_entry", _emulate.entry)
    monkeypatch.setattr(tou, "_call", lambda fn, device, *a: fn(*a, None))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_sharded_step_skips_a_nan_batch_bitwise(routed, fused, opt):
    rng = np.random.RandomState(8)
    params = {"w": rng.normal(size=(64,)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}

    def loss_fn(p, b):
        return ((p["w"] * b["x"]).sum() + p["b"]["c"].sum()) ** 2

    step = ShardedTrainStep(loss_fn, optimizer=opt, lr=0.01, wd=1e-4,
                            grad_clip=1.0, skip_nonfinite=True,
                            fused_optupdate=fused, device="cpu")
    step.init(params)
    x = rng.normal(size=(64,)).astype(np.float32)
    launches = tou.launches_adam + tou.launches_sgd_mom
    step({"x": x})
    assert bool(step.last_good)
    before = [t.clone() for t in _leaves(step)]
    bad = x.copy()
    bad[3] = np.nan
    step({"x": bad})
    assert not bool(step.last_good)
    for a, b in zip(before, _leaves(step)):
        assert _same_bits(a.numpy(), b.numpy())
    # the fused update went through the kernel both times
    assert tou.launches_adam + tou.launches_sgd_mom - launches == \
        (2 if fused else 0)


def _leaves(step):
    from mxnet_tpu_torch.parallel.optim_update import tree_leaves
    return [t.detach() for t in tree_leaves(step.params)
            + tree_leaves(step.opt_state)]
