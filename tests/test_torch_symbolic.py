"""The port's symbolic stack held against the JAX package's on the CPU.

- Each op of the slice, forward and backward, through ``simple_bind``
  executors in both packages (the ``_run_mx`` flow of
  ``tests/python/unittest/test_torch_oracle.py``: forward in train mode,
  then ``backward(out_grads)`` with a numpy head gradient): convolution
  (stride, pad, dilate, groups, no_bias), pooling (max, avg, sum, global,
  ``full``), relu and tanh, BatchNorm (train and eval, ``fix_gamma`` True
  and False, ``use_global_stats``, with the aux updates), FullyConnected,
  Flatten and elemwise_add, SoftmaxOutput (each ``normalization``,
  ``use_ignore``, ``grad_scale``). Tolerance: the oracle's float32
  2e-4 relative / 2e-4 absolute (another order of summation, and torch's
  convolution algorithms against XLA's).
- Symbol: ResNet-50's argument, aux-state and output names and
  ``infer_shape`` equal the reference's; a ResNet-8 graph in the JSON the
  JAX package writes loads in the port and computes the same outputs.
- ``.params`` files cross between the packages byte for byte, both ways.
- The slice as a whole: ``DataParallelTrainStep`` on ResNet-8 (3x28x28,
  10 classes, batch 4; 7 of its 28 params are kernel-#7 leaves), both
  packages initialised from one numpy dict through ``init_from``: 3 steps
  of SGD with momentum 0.9, wd 1e-4 and ``clip_gradient`` 0.05, and 3 of
  Adam, with ``fused_optupdate`` True and False on the port's side,
  against the JAX step (its default lax tier, which its own contract
  makes bitwise equal to its fused tiers). After each step the outputs,
  params, slots and BN aux states agree within 1e-4 of each leaf's max
  abs; observed at most 1.2e-6 for SGD and 3.3e-5 for Adam (whose update
  divides by the root of a tiny second moment, so it magnifies the
  float32 differences of the backward).
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jres
from mxnet_tpu.parallel.tpu_step import DataParallelTrainStep as JaxStep

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import resnet as tres
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = ATOL = 2e-4
STEP_TOL = 1e-4
CPU = tmx.cpu()


def _both(build):
    """The same graph built in both packages (fresh name scopes, so auto
    names match)."""
    with jmx.name.NameManager():
        js = build(jmx.sym)
    with tmx.name.NameManager():
        ts = build(tmx.sym)
    return js, ts


def _run_jax(sym, arrays, out_grad, is_train=True):
    exe = sym.simple_bind(jmx.cpu(), grad_req="write",
                          **{k: v.shape for k, v in arrays.items()})
    for k, v in arrays.items():
        (exe.aux_dict if k in exe.aux_dict else exe.arg_dict)[k][:] = v
    out = exe.forward(is_train=is_train)[0].asnumpy()
    exe.backward(out_grads=jmx.nd.array(out_grad))
    return out, {k: g.asnumpy() for k, g in exe.grad_dict.items()}, \
        {k: a.asnumpy() for k, a in exe.aux_dict.items()}


def _run_port(sym, arrays, out_grad, is_train=True):
    exe = sym.simple_bind(CPU, grad_req="write",
                          **{k: v.shape for k, v in arrays.items()})
    for k, v in arrays.items():
        (exe.aux_dict if k in exe.aux_dict else exe.arg_dict)[k][:] = v
    out = exe.forward(is_train=is_train)[0].asnumpy()
    exe.backward(out_grads=tmx.nd.array(out_grad, ctx=CPU))
    return out, {k: g.asnumpy() for k, g in exe.grad_dict.items()}, \
        {k: a.asnumpy() for k, a in exe.aux_dict.items()}


def _check_op(build, arrays, seed, is_train=True):
    js, ts = _both(build)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    shapes = {k: v.shape for k, v in arrays.items()
              if k in js.list_arguments()}
    out_shape = tuple(js.infer_shape(**shapes)[1][0])
    assert tuple(ts.infer_shape(**shapes)[1][0]) == out_shape
    og = np.random.RandomState(seed).normal(size=out_shape).astype(
        np.float32)
    want = _run_jax(js, arrays, og, is_train)
    got = _run_port(ts, arrays, og, is_train)
    np.testing.assert_allclose(got[0], want[0], RTOL, ATOL, err_msg="fwd")
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], RTOL, ATOL,
                                   err_msg="d" + k)
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], RTOL, ATOL,
                                   err_msg="aux " + k)


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("stride,pad,dilate,groups,no_bias", [
    ((2, 2), (1, 1), (1, 1), 1, False),
    ((1, 2), (2, 1), (2, 2), 1, True),
    ((2, 1), (0, 2), (2, 1), 2, False),
])
def test_convolution(stride, pad, dilate, groups, no_bias):
    rng = np.random.RandomState(1)
    arrays = {"x": _randn(rng, 2, 4, 9, 9), "c_weight":
              _randn(rng, 6, 4 // groups, 3, 3)}
    if not no_bias:
        arrays["c_bias"] = _randn(rng, 6)
    _check_op(lambda S: S.Convolution(
        S.Variable("x"), kernel=(3, 3), num_filter=6, stride=stride, pad=pad,
        dilate=dilate, num_group=groups, no_bias=no_bias, name="c"),
        arrays, 2)


@pytest.mark.parametrize("pool_type,kernel,stride,pad,convention,glob", [
    ("max", (3, 3), (2, 2), (1, 1), "valid", False),
    ("avg", (3, 3), (2, 2), (1, 1), "full", False),
    ("sum", (2, 3), (1, 2), (0, 1), "valid", False),
    ("avg", (1, 1), (), (), "valid", True),
])
def test_pooling(pool_type, kernel, stride, pad, convention, glob):
    rng = np.random.RandomState(3)
    _check_op(lambda S: S.Pooling(
        S.Variable("x"), pool_type=pool_type, kernel=kernel, stride=stride,
        pad=pad, pooling_convention=convention, global_pool=glob),
        {"x": _randn(rng, 2, 3, 8, 7)}, 4)


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_activation(act):
    rng = np.random.RandomState(5)
    _check_op(lambda S: S.Activation(S.Variable("x"), act_type=act),
              {"x": _randn(rng, 3, 4, 5)}, 6)


@pytest.mark.parametrize("mode,fix_gamma", [
    ("train", True), ("train", False), ("eval", False),
    ("global_stats", True)])
def test_batch_norm(mode, fix_gamma):
    rng = np.random.RandomState(7)
    c = 4
    arrays = {"x": _randn(rng, 3, c, 5, 6) * 2 + 1,
              "bn_gamma": 1 + 0.2 * _randn(rng, c),
              "bn_beta": 0.3 * _randn(rng, c),
              "bn_moving_mean": 0.5 * _randn(rng, c),
              "bn_moving_var": 0.5 + rng.rand(c).astype(np.float32)}
    _check_op(lambda S: S.BatchNorm(
        S.Variable("x"), fix_gamma=fix_gamma, eps=2e-5, momentum=0.9,
        use_global_stats=(mode == "global_stats"), name="bn"),
        arrays, 8, is_train=(mode != "eval"))


def test_fully_connected_flatten_add():
    rng = np.random.RandomState(9)

    def build(S):
        x = S.Variable("x")
        flat = S.Flatten(x)
        fc = S.FullyConnected(flat, num_hidden=5, name="fc")
        return S.FullyConnected(x, num_hidden=5, name="fc2") + fc + 0.5

    _check_op(build, {"x": _randn(rng, 3, 2, 4), "fc_weight":
                      _randn(rng, 5, 8), "fc_bias": _randn(rng, 5),
                      "fc2_weight": _randn(rng, 5, 8),
                      "fc2_bias": _randn(rng, 5)}, 10)


@pytest.mark.parametrize("norm,use_ignore,grad_scale", [
    ("null", False, 1.0), ("batch", True, 0.5), ("valid", True, 2.0)])
def test_softmax_output(norm, use_ignore, grad_scale):
    rng = np.random.RandomState(11)
    label = rng.randint(0, 6, 5).astype(np.float32)
    label[[1, 3]] = -1.0       # ignored where use_ignore
    _check_op(lambda S: S.SoftmaxOutput(
        S.Variable("x"), S.Variable("label"), normalization=norm,
        use_ignore=use_ignore, grad_scale=grad_scale, name="sm"),
        {"x": _randn(rng, 5, 6), "label": label}, 12)


# --------------------------------------------------------------- Symbol ----


def test_resnet50_names_and_shapes_match_reference():
    js, ts = _both(lambda S: (jres if S is jmx.sym else tres).get_symbol(
        num_classes=1000, num_layers=50, image_shape="3,224,224"))
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    want = js.infer_shape(data=(32, 3, 224, 224))
    got = ts.infer_shape(data=(32, 3, 224, 224))
    for g, w in zip(got, want):
        assert [tuple(s) for s in g] == [tuple(s) for s in w]
    assert ts.tojson() == js.tojson()


# ----------------------------------------------------------- .params ----


def test_params_files_cross_byte_for_byte(tmp_path):
    rng = np.random.RandomState(13)
    arrays = {"conv0_weight": _randn(rng, 4, 3, 3, 3),
              "fc1_bias": _randn(rng, 10),
              "counts": rng.randint(0, 9, (2, 3)).astype(np.int32),
              "bytes": np.arange(3, dtype=np.uint8),
              "half": _randn(rng, 5).astype(np.float16),
              "signed": rng.randint(-9, 9, (2, 2)).astype(np.int8)}
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, {k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in arrays.items()})
    loaded = tmx.nd.load(jpath)
    assert list(loaded) == list(arrays)
    for k, v in arrays.items():
        assert loaded[k].dtype == v.dtype and loaded[k].context == CPU
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)
    tmx.nd.save(tpath, loaded)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    # and back: the JAX package reads the port's file (a list this time)
    tmx.nd.save(tpath, [loaded[k] for k in arrays])
    back = jmx.nd.load(tpath)
    for got, v in zip(back, arrays.values()):
        np.testing.assert_array_equal(got.asnumpy(), v)


# ------------------------------------------------------- whole slice ----

SHAPES = {"data": (4, 3, 28, 28), "softmax_label": (4,)}
STEPS = 3
OPTIMIZERS = {
    "sgd": dict(optimizer="sgd", lr=0.05, momentum=0.9, wd=1e-4,
                clip_gradient=0.05),
    "adam": dict(optimizer="adam", lr=1e-3,
                 opt_hp=dict(beta1=0.9, beta2=0.999, eps=1e-8)),
}


def _resnet8(S):
    mod = jres if S is jmx.sym else tres
    return mod.get_symbol(num_classes=10, num_layers=8, image_shape="3,28,28")


def _init_values(sym):
    """One numpy dict of params and aux states for both packages: BN
    scales near 1, moving variances near 1, everything else small."""
    rng = np.random.RandomState(17)
    arg_shapes, _, aux_shapes = sym.infer_shape(**SHAPES)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in SHAPES:
            continue
        v = rng.normal(size=s) * (0.1 if n.endswith(("_beta", "_bias"))
                                  else np.sqrt(2.0 / np.prod(s[1:] or s)))
        args[n] = (v + (1.0 if n.endswith("_gamma") else 0.0)).astype(
            np.float32)
    aux = {n: (0.5 + rng.rand(*s) if "var" in n
               else 0.1 * rng.normal(size=s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batches = [{"data": rng.uniform(-1, 1, SHAPES["data"]).astype(
        np.float32), "softmax_label": rng.randint(0, 10, 4).astype(
        np.float32)} for _ in range(STEPS)]
    return args, aux, batches


def _slots(opt_state, name, to_np):
    return {slot: to_np(opt_state[slot][name])
            for slot in ("m", "v", "mom") if opt_state.get(slot)}


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX step, once per optimizer: per step (outputs, params, slots,
    aux), plus the graph's JSON and the initial values."""
    js, _ = _both(_resnet8)
    args, aux, batches = _init_values(js)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    runs = {}
    for opt, kw in OPTIMIZERS.items():
        step = JaxStep(js, mesh, **kw).init_from(args, aux, SHAPES)
        trace = []
        for b in batches:
            outs = step(b)
            params, aux_now = step.export_params()
            slots = {n: _slots(step.opt_state, n, np.asarray)
                     for n in params}
            trace.append((np.asarray(outs[0]), params, slots, aux_now))
        runs[opt] = trace
    return js.tojson(), args, aux, batches, runs


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("fused", [True, False])
def test_resnet8_train_step_matches_reference(reference_runs, opt, fused):
    _, args, aux, batches, runs = reference_runs
    sym = tres.get_symbol(num_classes=10, num_layers=8,
                          image_shape="3,28,28")
    step = tmx.DataParallelTrainStep(sym, fused_optupdate=fused,
                                     device="cpu", **OPTIMIZERS[opt])
    step.init_from(args, aux, SHAPES)
    assert len([n for n in step.param_names
                if tmx.kernels.opt_update._kernel_eligible(step.params[n])]
               ) == 7 and len(step.param_names) == 28
    worst = 0.0
    for b, (out, params, slots, aux_now) in zip(batches, runs[opt]):
        got = step(b)
        worst = max(worst, _rel_err(got[0].numpy(), out))
        tparams, taux = step.export_params()
        for n in params:
            worst = max(worst, _rel_err(tparams[n], params[n]))
            tslots = _slots(step.opt_state, n,
                            lambda t: t.detach().numpy())
            assert sorted(tslots) == sorted(slots[n])
            for k in slots[n]:
                worst = max(worst, _rel_err(tslots[k], slots[n][k]))
        for n in aux_now:
            worst = max(worst, _rel_err(taux[n], aux_now[n]))
    assert worst <= STEP_TOL, "max error %g of a leaf's max abs" % worst
    assert step.program_count() == 1


def test_resnet8_json_from_reference_computes_same_outputs(reference_runs):
    """The JAX package's JSON loads in the port; its train-mode forward
    from the initial values is the reference step's first output."""
    json_text, args, aux, batches, runs = reference_runs
    sym = tmx.sym.load_json(json_text)
    assert sym.tojson() == json_text
    exe = sym.simple_bind(CPU, grad_req="null", **SHAPES)
    for src, dst in (({**args, **batches[0]}, exe.arg_dict),
                     (aux, exe.aux_dict)):
        for k, v in src.items():
            dst[k][:] = v
    out = exe.forward(is_train=True)[0].asnumpy()
    assert _rel_err(out, runs["sgd"][0][0]) <= STEP_TOL
