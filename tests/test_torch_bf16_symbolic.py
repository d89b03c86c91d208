"""bf16 compute with float32 masters in the port's symbolic stack, held
against the JAX package on the CPU.

- ``DataParallelTrainStep(compute_dtype="bfloat16")`` on ResNet-8 (two
  residual stages, 3x28x28, 10 classes, batch 4), both packages starting
  from one ``.params`` file the JAX package wrote: 3 steps of SGD with
  momentum, wd and ``clip_gradient``, and 3 of Adam, the port with
  ``fused_optupdate`` True and False. After each step: the outputs bf16
  in both; the masters, their slots and BatchNorm's running statistics
  float32 in both, where the JAX step keeps them; the outputs within
  ``OUT_TOL`` of their max abs (about 2 bf16 ulps). bf16 gradients at
  batch 4 are far from the float32 ones in both packages (BatchNorm's
  backward subtracts near-equal sums of bf16-rounded terms: the JAX bf16
  step's momentum is 30-40% of a leaf's max abs off its own float32
  step's), and each framework rounds at other places, so the masters,
  slots and aux are held to the float32 JAX step instead: after each
  step, for each kind (masters, slots, aux), the port's distance to it as
  a relative L2 norm over every leaf of the kind at most ``NOISE_FACTOR``
  times the JAX bf16 step's own, plus ``NOISE_FLOOR`` (one leaf of a few
  elements scatters too much to be held alone). Labels are never
  cast: a label of value 257 stays 257 in the step's graph.
- ``Module.fit(kvstore='tpu_sync')`` with ``multi_precision=True`` routes
  bf16 to the step in both packages (an MLP, 2 epochs): the fused step's
  compute dtype, the epoch's accuracy within ``ACC_TOL`` and the final
  params within ``FIT_TOL`` of each leaf's max abs. A
  ``MXNET_FUSED_COMPUTE_DTYPE`` that is no dtype logs the reference's
  warning and trains in float32.
"""
import logging
import math

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

OUT_TOL = 2e-2
NOISE_FACTOR = 1.5
NOISE_FLOOR = 1e-4
ACC_TOL = 0.05
FIT_TOL = 2e-2
SHAPES = {"data": (4, 3, 28, 28), "softmax_label": (4,)}
STEPS = 3
OPTIMIZERS = {
    "sgd": dict(optimizer="sgd", lr=0.05, momentum=0.9, wd=1e-4,
                clip_gradient=0.05),
    "adam": dict(optimizer="adam", lr=1e-3,
                 opt_hp=dict(beta1=0.9, beta2=0.999, eps=1e-8)),
}


def _init_values(sym):
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


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX step per optimizer from one ``.params`` file, in bf16 and
    in float32: per step (outputs, params, slots, aux) as numpy with
    their dtypes."""
    with jmx.name.NameManager():
        js = jres.get_symbol(num_classes=10, num_layers=8,
                             image_shape="3,28,28")
    args, aux, batches = _init_values(js)
    path = str(tmp_path_factory.mktemp("bf16") / "resnet8.params")
    jmx.model.save_params(path, {k: jmx.nd.array(v) for k, v in args.items()},
                          {k: jmx.nd.array(v) for k, v in aux.items()})
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    runs = {}
    for (opt, kw), cdt in ((o, c) for o in OPTIMIZERS.items()
                           for c in ("bfloat16", None)):
        jargs, jaux = jmx.model.load_params(path)
        step = JaxStep(js, mesh, compute_dtype=cdt, **kw).init_from(
            jargs, jaux, SHAPES)
        trace = []
        for b in batches:
            outs = step(b)
            params, aux_now = step.export_params()
            slots = {n: _slots(step.opt_state, n, np.asarray)
                     for n in params}
            trace.append((np.asarray(outs[0]), params, slots, aux_now))
        runs[opt, cdt] = trace
    return path, batches, runs


def _leaves(params, slots, aux):
    """kind -> name -> array: every master, slot and aux state of one
    step."""
    return {"param": dict(params), "aux": dict(aux),
            "slot": {(n, k): v for n in params for k, v in slots[n].items()}}


def _rel_l2(got, want):
    """||got - want|| / ||want|| over every leaf of a kind."""
    num = sum(float(np.sum((np.asarray(got[k], np.float64) - w) ** 2))
              for k, w in want.items())
    return math.sqrt(num / sum(float(np.sum(np.asarray(w, np.float64) ** 2))
                               for w in want.values()))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("fused", [True, False])
def test_bf16_train_step_matches_reference(reference, opt, fused):
    path, batches, runs = reference
    with tmx.name.NameManager():
        sym = tres.get_symbol(num_classes=10, num_layers=8,
                              image_shape="3,28,28")
    args, aux = tmx.model.load_params(path)
    step = tmx.DataParallelTrainStep(sym, fused_optupdate=fused,
                                     compute_dtype="bfloat16", device="cpu",
                                     **OPTIMIZERS[opt])
    step.init_from(args, aux, SHAPES)
    assert step.compute_dtype == torch.bfloat16
    worst = {"out": 0.0, "ratio": 0.0}
    for b, (out, params, slots, aux_now), f32 in zip(
            batches, runs[opt, "bfloat16"], runs[opt, None]):
        got = step(b)[0]
        assert got.dtype == torch.bfloat16 and out.dtype.name == "bfloat16"
        worst["out"] = max(worst["out"], _err(got.float().numpy(),
                                              out.astype(np.float32)))
        tparams, taux = step.export_params()
        tslots = {n: _slots(step.opt_state, n, lambda t: t.detach().numpy())
                  for n in tparams}
        assert all(p.dtype == torch.float32 for p in step.params.values())
        assert all(a.dtype == torch.float32 for a in step.aux.values())
        mine = _leaves(tparams, tslots, taux)
        ref = _leaves(params, slots, aux_now)
        full = _leaves(*f32[1:])
        for kind, want in full.items():
            assert sorted(mine[kind]) == sorted(ref[kind]) == sorted(want)
            assert all(mine[kind][k].dtype == ref[kind][k].dtype
                       == np.float32 for k in want), kind
            ratio = _rel_l2(mine[kind], want) / (
                NOISE_FACTOR * _rel_l2(ref[kind], want) + NOISE_FLOOR)
            assert ratio <= 1.0, (kind, ratio)
            worst["ratio"] = max(worst["ratio"], ratio)
    print("%s fused=%s: %s" % (opt, fused, worst))
    assert worst["out"] <= OUT_TOL, worst


def test_bf16_step_never_casts_labels(monkeypatch):
    """The graph sees the data in bf16 and the labels as given: 257 has no
    bf16 (it would round to 256)."""
    from mxnet_tpu_torch.parallel import tpu_step
    seen = {}
    real = tpu_step.run_graph

    def spy(plan, args, aux, is_train):
        seen.update({n: (v.dtype, v.clone()) for n, v in args.items()
                     if n in ("data", "softmax_label")})
        return real(plan, args, aux, is_train)

    monkeypatch.setattr(tpu_step, "run_graph", spy)
    x = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(x, num_hidden=300, name="fc")
    sym = tmx.sym.SoftmaxOutput(fc, name="softmax")
    step = tmx.DataParallelTrainStep(sym, compute_dtype="bfloat16",
                                     device="cpu")
    step.init({"data": (2, 4), "softmax_label": (2,)})
    step({"data": np.ones((2, 4), np.float32),
          "softmax_label": np.array([257.0, 3.0], np.float32)})
    assert seen["data"][0] == torch.bfloat16
    assert seen["softmax_label"][0] == torch.float32
    assert seen["softmax_label"][1].tolist() == [257.0, 3.0]


def _fit(mx, param_file, mp=True):
    rng = np.random.RandomState(6)
    label = rng.randint(0, 10, 96).astype(np.float32)
    img = (rng.uniform(0, 0.2, (96, 1, 28, 28))
           + 0.05 * label[:, None, None, None]).astype(np.float32)
    with mx.name.NameManager():
        sym = mx.models.get_symbol("mlp", num_classes=10)
    train = mx.io.NDArrayIter(img, label, 32)
    arg_params, aux_params = mx.model.load_params(param_file)
    ctx = {} if mx is jmx else {"context": tmx.cpu()}
    mod = mx.mod.Module(sym, **ctx)
    acc = []
    mod.fit(train, eval_metric="acc", kvstore="tpu_sync", optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "multi_precision": mp},
            arg_params=arg_params, aux_params=aux_params,
            epoch_end_callback=lambda *a: None,
            batch_end_callback=lambda p: acc.append(
                p.eval_metric.get()[1]), num_epoch=2)
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}, acc


@pytest.fixture(scope="module")
def mlp_params(tmp_path_factory):
    with jmx.name.NameManager():
        sym = jmx.models.get_symbol("mlp", num_classes=10)
    arg_shapes, _, _ = sym.infer_shape(data=(32, 1, 28, 28))
    rng = np.random.RandomState(8)
    args = {n: jmx.nd.array((rng.normal(size=s) * 0.05).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    path = str(tmp_path_factory.mktemp("mp") / "mlp.params")
    jmx.model.save_params(path, args, {})
    return path


def test_module_fit_multi_precision_matches_reference(mlp_params):
    jmod, jparams, jacc = _fit(jmx, mlp_params)
    tmod, tparams, tacc = _fit(tmx, mlp_params)
    assert str(jmod._fused_step.compute_dtype) == "bfloat16"
    assert tmod._fused_step.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32
               for p in tmod._fused_step.params.values())
    assert len(tacc) == len(jacc) == 6
    assert abs(tacc[-1] - jacc[-1]) <= ACC_TOL, (tacc, jacc)
    for k, want in jparams.items():
        assert tparams[k].dtype == want.dtype == np.float32
        assert _err(tparams[k], want) <= FIT_TOL, k


@pytest.mark.parametrize("value,want", [("bfloat16", torch.bfloat16),
                                        ("float16", torch.float16),
                                        ("bf16x", None)])
def test_module_compute_dtype_env(mlp_params, monkeypatch, caplog, value,
                                  want):
    monkeypatch.setenv("MXNET_FUSED_COMPUTE_DTYPE", value)
    caplog.set_level(logging.WARNING)
    mod, params, _ = _fit(tmx, mlp_params, mp=False)
    assert mod._fused_step.compute_dtype == want
    warned = "is not a dtype; running the fused step in fp32" in caplog.text
    assert warned == (want is None)
    assert all(np.isfinite(v).all() for v in params.values())


def test_metric_folds_bf16_increments():
    """A bf16 step's outputs reach the metrics' device path (the card's):
    the increment is summed in bf16, as the reference sums it, and
    widened exactly for the host's sum."""
    probs = torch.softmax(torch.tensor([[2.0, 0.5, 0.1], [0.3, 0.2, 1.5]]),
                          -1).to(torch.bfloat16)
    labels = [torch.tensor([0.0, 2.0])]
    for name in ("crossentropy", "acc"):
        m = tmx.metric.create(name)
        assert m.update_device(labels, [probs])
        want = tmx.metric.create(name)
        want.update(labels, [probs.float()])
        assert abs(m.get()[1] - want.get()[1]) <= 1e-2 * abs(want.get()[1])
