"""The port's process groups, ``dist_sync`` store and ``Module`` over
several contexts, held against the JAX package on the CPU.

- ``Module(context=[cpu(0), cpu(1)])`` against the reference's (8 host
  devices under ``tests/conftest.py``), both from one ``.params`` file,
  1 epoch of SGD with momentum, for the MLP and a small conv + BatchNorm
  net: ``local`` (one executor per slice, per-slice BatchNorm, the copies
  merged by the store), ``device`` (the fused step over the whole batch,
  kernel #7's wrapper on CPU tensors, so its plain version) and ``local``
  with 2-bit compression. The tolerances of ``test_torch_module.py``'s
  ``test_module_fit_matches_reference``: every batch's running accuracy
  identical, the cross-entropy within 1e-4 relative, the final params and
  aux states within 1e-6 of each leaf's own max abs (max and 99th
  percentile).
- ``dist_sync`` in one process (``num_workers`` 1: the store's updater,
  keyed by name) bit for bit the one-context ``local`` fit (the Module's
  updater, keyed by index).
- Two gloo ranks started by the reference's unchanged ``tools/launch.py``
  on a free port, each subprocess under a 120 s limit (the process group
  waits 60 s at most): pushes sum exactly (3 and 6), and a random value
  pushed by each rank sums to the bits of the reference's one-process
  push of the two values as two device copies (the reference's own
  two-process test skips here: jaxlib has no CPU collectives); a
  two-rank ``dist_sync`` MLP fit, plain and 2-bit compressed, ends with
  the same bits on both ranks and the bits of the port's two-context
  ``local`` fit over the same rows (rank r takes rows [16r, 16r + 16) of
  each batch of 32).
- ``group2ctxs`` on the context's own device is a no-op, on another
  device it raises (ROADMAP A7 part 3); a batch that does not split over
  the contexts leaves the fused step off with the reference's warning,
  and ``DataParallelTrainStep`` over such a mesh raises ValueError.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.parallel import DataParallelTrainStep
from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh, get_mesh
from torch_dist_fit import BATCH, N, TWO_BIT, _fit, _symbol
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# final params: (max, 99th percentile) of |port - reference| over the
# leaf's own max abs, test_module_fit_matches_reference's SGD tolerance
PARAM_TOL = (1e-6, 1e-6)
CE_RTOL = 1e-4
TINY = np.finfo(np.float32).tiny
RANK_TIMEOUT_S = 120     # each launched subprocess
GROUP_TIMEOUT_S = "60"   # the process group's join and collectives


def _write_params(path, network):
    sym = _symbol(jmx, network)
    rng = np.random.RandomState(8)
    shapes, _, aux_shapes = sym.infer_shape(data=(BATCH, 1, 28, 28),
                                            softmax_label=(BATCH,))
    args = {n: (rng.normal(size=s) * (np.prod(s[1:]) ** -0.5 if len(s) > 1
                                      else 0.1)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    jmx.model.save_params(path, {k: jmx.nd.array(v) for k, v in args.items()},
                          {k: jmx.nd.array(v) for k, v in aux.items()})
    return path


@pytest.fixture(scope="module")
def param_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    return {net: _write_params(str(d / (net + ".params")), net)
            for net in ("mlp", "conv_bn")}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("network", ["mlp", "conv_bn"])
@pytest.mark.parametrize("mode", ["local", "device", "local_2bit"])
def test_two_context_fit_matches_reference(network, mode, param_files,
                                           monkeypatch):
    kvstore = mode.split("_")[0]
    comp = TWO_BIT if mode.endswith("2bit") else None
    jrec, trec = [], []
    jmod, want = _fit(jmx, network, param_files[network],
                      [jmx.cpu(0), jmx.cpu(1)], kvstore, comp, record=jrec)
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    tmod, got = _fit(tmx, network, param_files[network],
                     [tmx.cpu(0), tmx.cpu(1)], kvstore, comp, record=trec)
    fused = mode == "device"
    assert (jmod._fused_step is not None) == (tmod._fused_step
                                              is not None) == fused
    assert len(tmod._exec_group.execs) == 2
    assert (tmod._kvstore._gc.active, jmod._kvstore._gc.active) == \
        (comp is not None,) * 2
    assert len(trec) == len(jrec) == N // BATCH
    for g, w in zip(trec, jrec):
        assert g[0] == w[0], (trec, jrec)
        np.testing.assert_allclose(g[1], w[1], rtol=CE_RTOL)
    worst, p99 = 0.0, 0.0
    for k, w in want.items():
        err = np.abs(got[k] - w) / max(np.abs(w).max(), TINY)
        worst, p99 = max(worst, err.max()), max(p99, np.quantile(err, 0.99))
    assert worst <= PARAM_TOL[0] and p99 <= PARAM_TOL[1], (worst, p99)


def test_dist_sync_in_one_process_matches_local(param_files):
    """num_workers 1: the store's updater (keys are names) and the
    Module's (keys are indices) give the same bits."""
    mod, dist = _fit(tmx, "conv_bn", param_files["conv_bn"], tmx.cpu(),
                     "dist_sync")
    assert mod._kvstore.type == "dist_sync" and mod._update_on_kvstore
    assert mod._kvstore.num_workers == 1
    local_mod, local = _fit(tmx, "conv_bn", param_files["conv_bn"],
                            tmx.cpu(), "local")
    assert local_mod._kvstore is None
    for k, v in local.items():
        np.testing.assert_array_equal(_bits(dist[k]), _bits(v), err_msg=k)


def test_group2ctxs_meshes_and_indivisible_batches(caplog):
    sym = _symbol(tmx, "mlp")
    shapes = [("data", (6, 1, 28, 28))], [("softmax_label", (6,))]
    mod = tmx.mod.Module(sym, context=[tmx.cpu(), tmx.cpu()],
                         group2ctxs={"dev1": tmx.cpu(1)})
    mod.bind(*shapes)
    assert len(mod._exec_group.execs) == 2
    with pytest.raises(MXNetError, match="ROADMAP A7 part 3"):
        tmx.mod.Module(sym, context=[tmx.cpu()],
                       group2ctxs={"dev1": torch.device("meta")}).bind(
            *shapes)
    # 7 rows over 2 contexts: 3 and 4 (round half to even, as the
    # reference), and no fused step (a warning)
    mod = tmx.mod.Module(sym, context=[tmx.cpu(), tmx.cpu()])
    mod.bind([("data", (7, 1, 28, 28))], [("softmax_label", (7,))])
    assert mod._exec_group.slices == \
        jmx.module.executor_group._split_input_slice(7, [1, 1])
    mod.init_params()
    caplog.set_level("WARNING")
    mod.init_optimizer(kvstore="device")
    assert mod._fused_step is None
    assert "not divisible by 2 devices" in caplog.text
    step = DataParallelTrainStep(sym, data_parallel_mesh(["cpu", "cpu"]))
    with pytest.raises(ValueError, match="divisible by the mesh's 2"):
        step.init({"data": (7, 1, 28, 28), "softmax_label": (7,)})
    assert get_mesh(dp=2, tp=2, devices=["cpu"] * 4).shape == {
        "dp": 2, "tp": 2, "pp": 1, "sp": 1}
    with pytest.raises(ValueError, match="mesh size 4 != device count 2"):
        get_mesh(dp=4, devices=["cpu"] * 2)


# ------------------------------------------------------ two gloo ranks ----

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, body):
    """``body`` as a worker script on two ranks through tools/launch.py;
    returns each rank's JSON result."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import json, os, sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import mxnet_tpu_torch as mx   # joins the launcher's process group
        from mxnet_tpu_torch.parallel import collectives
        rank = collectives.process_index()
        assert collectives.process_count() == 2
        OUT = %r
    """) % str(tmp_path) + textwrap.dedent(body))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "DMLC_"))}
    env.update(PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        MXNET_DIST_TIMEOUT_S=GROUP_TIMEOUT_S, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         "2", "--coordinator-port", str(_free_port()), "--",
         sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)   # the launcher and its ranks
        proc.communicate()
        pytest.fail("two ranks did not finish in %d s" % RANK_TIMEOUT_S)
    assert proc.returncode == 0, (out + err)[-4000:]
    results = []
    for rank in range(2):
        with open(tmp_path / ("rank%d.json" % rank)) as f:
            results.append(json.load(f))
    return results


AGGREGATION = """
    kv = mx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers, kv.type) == (rank, 2, "dist_sync")
    ctx, shape = mx.cpu(), (3, 4)
    kv.init("w", mx.nd.zeros(shape, ctx=ctx))
    kv.push("w", mx.nd.ones(shape, ctx=ctx) * (rank + 1))
    sum1 = mx.nd.zeros(shape, ctx=ctx)
    kv.pull("w", out=sum1)
    kv.init([9], [mx.nd.ones(shape, ctx=ctx)])
    kv.push([9], [mx.nd.ones(shape, ctx=ctx) * 2 * (rank + 1)])
    sum2 = mx.nd.zeros(shape, ctx=ctx)
    kv.pull([9], out=[sum2])
    vals = np.random.RandomState(5).normal(size=(2,) + shape)
    kv.init("r", mx.nd.zeros(shape, ctx=ctx))
    kv.push("r", mx.nd.array(vals[rank].astype(np.float32), ctx=ctx))
    rand = mx.nd.zeros(shape, ctx=ctx)
    kv.pull("r", out=rand)
    kv.barrier()
    with open(os.path.join(OUT, "rank%d.json" % rank), "w") as f:
        json.dump({"sum1": sum1.asnumpy().tolist(),
                   "sum2": sum2.asnumpy().tolist(),
                   "rand": rand.asnumpy().view(np.uint32).tolist()}, f)
"""


def test_two_process_dist_sync_aggregation(tmp_path):
    results = _launch(tmp_path, AGGREGATION)
    shape = (3, 4)
    vals = np.random.RandomState(5).normal(size=(2,) + shape).astype(
        np.float32)
    kv = jmx.kv.create("device")
    kv.init("r", jmx.nd.zeros(shape))
    kv.push("r", [jmx.nd.array(v) for v in vals])
    want = jmx.nd.zeros(shape)
    kv.pull("r", out=want)
    for res in results:
        np.testing.assert_array_equal(res["sum1"], np.full(shape, 3.0))
        np.testing.assert_array_equal(res["sum2"], np.full(shape, 6.0))
        np.testing.assert_array_equal(np.asarray(res["rand"], np.uint32),
                                      _bits(want.asnumpy()))


TRAIN = """
    from torch_dist_fit import BATCH, N, TWO_BIT, _fit
    rows = [b * BATCH + rank * (BATCH // 2) + i
            for b in range(N // BATCH) for i in range(BATCH // 2)]
    out = {}
    for name, comp in (("plain", None), ("2bit", TWO_BIT)):
        mod, params = _fit(mx, "mlp", %r, mx.cpu(), "dist_sync", comp,
                           batch=BATCH // 2, rows=rows)
        assert mod._fused_step is None and mod._kvstore.num_workers == 2
        assert mod._optimizer.rescale_grad == 1.0 / BATCH
        out[name] = {k: v.view(np.uint32).tolist()
                     for k, v in params.items()}
    with open(os.path.join(OUT, "rank%%d.json" %% rank), "w") as f:
        json.dump(out, f)
"""


def test_two_process_module_training_matches_two_contexts(tmp_path,
                                                          param_files):
    """SURVEY 3.2: Module.fit over dist_sync on two processes ends with
    the same bits on both, and the bits of the two-context local fit."""
    results = _launch(tmp_path, TRAIN % param_files["mlp"])
    for name, comp in (("plain", None), ("2bit", TWO_BIT)):
        mod, want = _fit(tmx, "mlp", param_files["mlp"],
                         [tmx.cpu(), tmx.cpu()], "local", comp)
        assert mod._optimizer.rescale_grad == 1.0 / BATCH
        for res in results:
            assert sorted(res[name]) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(
                    np.asarray(res[name][k], np.uint32).reshape(v.shape),
                    _bits(v), err_msg="%s %s" % (name, k))
