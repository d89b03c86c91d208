"""The rest of the port's executor (``warmup``, ``has_compiled_forward``,
``program_cost``, the monitor hooks) and ``mx.monitor.Monitor`` held
against the JAX package on the CPU.

- ``Monitor`` on bound executors, in inference and in training mode: the
  same ``(step, name)`` rows in the same order, each statistic within
  rtol 1e-5 of the reference's (float32 means of the same values summed
  in another order); ``run_graph(collect_interior=True)`` names every
  interior output as the reference does.
- ``Module.fit(monitor=...)``: the printed rows name the same outputs in
  the same order as the reference's fit, within rtol 1e-5 (the first
  batch's, from identical weights) and 1e-4 (the later ones, after
  updates that agree to float32 rounding); the monitor turns the fused
  ``tpu_sync`` step off in both packages.
- ``program_cost`` on the two-convolution network: its ``flops`` are
  exactly 2 per multiply-add of every convolution and matmul of the
  forward and the backward (the count ``FlopCounterMode`` makes). XLA's
  cost analysis in the reference counts only the multiply-adds that do
  not fall on a convolution's zero padding (0.92 and 0.84 of the taps on
  the 16x16 and 8x8 maps here), and adds the elementwise ops' flops: it
  lies between the port's count with the padding taps taken out and 5%
  above that (observed 1.9%). ``peak_bytes`` and ``temp_bytes`` grow with
  the batch.
- ``warmup`` on the CPU registers the inference forward (one ``aot``
  compile at ``executor.forward``), and the forwards after it equal the
  eager ones bit for bit; ``has_compiled_forward`` answers as the
  reference's does.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.executor import run_graph
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = tmx.cpu()
STAT_RTOL = 1e-5
FIT_RTOL = 1e-4
XLA_ELEMENTWISE = 0.05


def _convnet(mx, bn=True):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv0")
    if bn:
        net = mx.sym.BatchNorm(net, name="bn0")
    net = mx.sym.Activation(net, act_type="relu", name="relu0")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                         name="pool0")
    net = mx.sym.Convolution(net, num_filter=16, kernel=(3, 3), pad=(1, 1),
                             name="conv1", no_bias=True)
    net = mx.sym.Flatten(net, name="flat0")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc0")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _both(bn=True):
    with jmx.name.NameManager():
        js = _convnet(jmx, bn)
    with tmx.name.NameManager():
        ts = _convnet(tmx, bn)
    return js, ts


def _values(sym, batch, rng, hw=8):
    shapes = {"data": (batch, 3, hw, hw), "softmax_label": (batch,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rng.randint(0, 10, s).astype(np.float32)
        else:
            args[n] = rng.normal(0, 0.3, s).astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rng.normal(0, 0.1, s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return shapes, args, aux


def _bind(mx, sym, ctx, shapes, args, aux, grad_req="write"):
    exe = sym.simple_bind(ctx, grad_req=grad_req, **shapes)
    for n, v in args.items():
        exe.arg_dict[n][:] = v
    for n, v in aux.items():
        exe.aux_dict[n][:] = v
    return exe


def _pair(batch=4, seed=0, grad_req="write"):
    js, ts = _both()
    shapes, args, aux = _values(js, batch, np.random.RandomState(seed))
    return (_bind(jmx, js, jmx.cpu(), shapes, args, aux, grad_req),
            _bind(tmx, ts, CPU, shapes, args, aux, grad_req))


def _rows(res):
    return [(n, k, float(v)) for n, k, v in res]


def _same_rows(got, want, rtol):
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=rtol)


@pytest.mark.parametrize("is_train", [False, True], ids=["infer", "train"])
def test_monitor_stats_match_reference(is_train):
    jexe, texe = _pair()
    res = []
    for mx, exe in ((jmx, jexe), (tmx, texe)):
        mon = mx.monitor.Monitor(1, sort=False)
        mon.install(exe)
        for _ in range(2):
            mon.tic()
            exe.forward(is_train=is_train)
            if is_train:
                exe.backward()
            res.append(_rows(mon.toc()))
    (j0, j1, t0, t1) = res
    assert len(t0) == 8 and t0[0][:2] == (1, "conv0_output")
    _same_rows(t0, j0, STAT_RTOL)
    _same_rows(t1, j1, STAT_RTOL)
    # off the interval nothing is collected
    mon = tmx.monitor.Monitor(2, pattern="relu.*")
    mon.install(texe)
    got = []
    for _ in range(3):
        mon.tic()
        texe.forward(is_train=False)
        got.append([r[1] for r in mon.toc()])
    assert got == [["relu0_output"], [], ["relu0_output"]]


def test_run_graph_interior_names_match_reference():
    jexe, texe = _pair(grad_req="null")
    vals = {n: a._data for n, a in texe.arg_dict.items()}
    aux = {n: a._data for n, a in texe.aux_dict.items()}
    outs, _, interior = run_graph(texe._plan, vals, aux, False,
                                  collect_interior=True)
    jouts, _, jinterior = jexe._run_graph(
        {n: a._data for n, a in jexe.arg_dict.items()},
        {n: a._data for n, a in jexe.aux_dict.items()},
        jmx.random.fixed_key(), False, collect_interior=True)
    assert [n for n, _ in interior] == [n for n, _ in jinterior]
    for (_, got), (_, want) in zip(interior, jinterior):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def _fit_rows(mx, sym, ctx, args, aux, x, y, kvstore, capsys):
    mod = mx.mod.Module(sym, context=ctx)
    it = mx.io.NDArrayIter(x, y, batch_size=4, label_name="softmax_label")
    nd = {k: mx.nd.array(v, ctx=ctx) for k, v in args.items()
          if k not in ("data", "softmax_label")}
    ndx = {k: mx.nd.array(v, ctx=ctx) for k, v in aux.items()}
    capsys.readouterr()
    mod.fit(it, num_epoch=1, kvstore=kvstore, arg_params=nd,
            aux_params=ndx, optimizer_params={"learning_rate": 0.1},
            monitor=mx.monitor.Monitor(1, pattern=".*(conv|fc).*"))
    rows = []
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("Batch:"):
            _, n, name, val = line.split()
            rows.append((int(n), name, float(val)))
    return mod, rows


@pytest.mark.parametrize("kvstore", ["local", "tpu_sync"])
def test_fit_with_monitor_matches_reference(kvstore, capsys):
    js, ts = _both()
    rng = np.random.RandomState(3)
    _, args, aux = _values(js, 4, rng)
    x = rng.normal(0, 1, (12, 3, 8, 8)).astype(np.float32)
    y = rng.randint(0, 10, (12,)).astype(np.float32)
    jmod, want = _fit_rows(jmx, js, jmx.cpu(), args, aux, x, y, kvstore,
                           capsys)
    tmod, got = _fit_rows(tmx, ts, CPU, args, aux, x, y, kvstore, capsys)
    assert tmod._fused_step is None and jmod._fused_step is None
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert {r[0] for r in got} == {1, 2, 3}
    first = [i for i, r in enumerate(got) if r[0] == 1]
    _same_rows([got[i] for i in first], [want[i] for i in first],
               STAT_RTOL)
    _same_rows(got, want, FIT_RTOL)


def _conv_macs(batch, hw=8):
    """Multiply-adds of the forward of the BatchNorm-free network."""
    conv0 = batch * 8 * hw * hw * 3 * 9
    conv1 = batch * 16 * (hw // 2) ** 2 * 8 * 9
    fc0 = batch * 10 * 16 * (hw // 2) ** 2
    return conv0, conv1, fc0


@pytest.mark.parametrize("batch", [4, 8])
def test_program_cost_against_xla(batch):
    js, ts = _both(bn=False)
    shapes, args, aux = _values(js, batch, np.random.RandomState(1), hw=16)
    jexe = _bind(jmx, js, jmx.cpu(), shapes, args, aux)
    texe = _bind(tmx, ts, CPU, shapes, args, aux)
    got, want = texe.program_cost(), jexe.program_cost()
    assert set(got) == set(want) == {"flops", "peak_bytes", "temp_bytes"}
    conv0, conv1, fc0 = _conv_macs(batch, hw=16)
    # every argument takes a gradient (grad_req "write"): each product's
    # forward, weight gradient and input gradient
    assert got["flops"] == 2 * 3 * (conv0 + conv1 + fc0)
    # XLA leaves out the taps on a 3x3 convolution's zero padding, a
    # share 1 - ((3H - 2) / 3H)^2 of an H x H map's, and adds the
    # elementwise ops' flops on top
    valid = 2 * 3 * (conv0 * (46 / 48) ** 2 + conv1 * (22 / 24) ** 2 + fc0)
    assert valid <= want["flops"] <= (1 + XLA_ELEMENTWISE) * valid
    small = _bind(tmx, ts, CPU, {"data": (2, 3, 16, 16),
                                 "softmax_label": (2,)},
                  *_values(js, 2, np.random.RandomState(1), hw=16)[1:])
    cost = small.program_cost()
    assert got["peak_bytes"] > cost["peak_bytes"] > cost["temp_bytes"] > 0
    assert got["temp_bytes"] > cost["temp_bytes"]
    # no state changes
    for n, a in texe.arg_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), args[n])


def test_executor_warmup_on_cpu():
    jexe, texe = _pair(grad_req="null")
    assert not texe.has_compiled_forward() and \
        not jexe.has_compiled_forward()
    eager = texe.forward(is_train=False)[0].asnumpy()
    assert texe.has_compiled_forward() and not \
        texe.has_compiled_forward(is_train=True)
    jexe.forward(is_train=False)
    assert jexe.has_compiled_forward()
    _, fresh = _pair(grad_req="null")
    tprof.compile_counters(reset=True)
    assert fresh.warmup() is fresh and fresh.warmup(is_train=True) is fresh
    assert fresh.has_compiled_forward()
    site = tprof.compile_counters()["sites"]["executor.forward"]
    assert site == {"compiles": 1, "aot": 1, "ondemand": 0, "cache_hits": 0}
    for _ in range(2):
        np.testing.assert_array_equal(
            fresh.forward(is_train=False)[0].asnumpy(), eager)
    np.testing.assert_allclose(eager, jexe.outputs[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)
