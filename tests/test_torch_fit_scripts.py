"""An MXNet example script run unchanged against the port, and against
the JAX package, on the CPU.

``example/image-classification/train_mnist.py --network lenet
--num-epochs 2 --kv-store local`` (``MNIST_SYNTH_N=640``: its synthetic
set, 640 training and 106 validation images) runs in a subprocess under
each package with numpy's global RNG seeded alike (``--np-seed`` of the
launcher ``python -m mxnet_tpu_torch.run_script``; a ``runpy`` wrapper for
the JAX package), both resuming from one checkpoint the JAX package wrote
(``--model-prefix``/``--load-epoch 0``), so ``fit.py``'s
``sym.tojson() == network.tojson()`` check holds the port's symbol JSON
to the reference's byte for byte. The port's run must not import jax.
Each epoch's ``Train-accuracy`` and ``Validation-accuracy`` agree within
2 samples' worth (2/640 and 2/128: validation counts the padded last
batch, as the reference does) and the final ``-0002.params`` within 1e-6
of each leaf's own max abs (observed 7.1e-7, at conv1_bias).

Both children run on one intra-op thread: the sums of a convolution's
backward take another order at another thread count, on either side
(1 against 8 threads moved the port's params by 5.3e-7 and the JAX
package's by 1.6e-7), so an unpinned run's gap depended on the host.
``OMP_NUM_THREADS=1`` pins torch; XLA's CPU client sizes its pool from
the process's CPU affinity, so the JAX wrapper keeps one CPU of it.
The two children run at the same time (each on its one thread). The
launcher's rules are in test_torch_port_rules.py.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu.models import lenet as jlenet
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "example", "image-classification",
                      "train_mnist.py")
ARGS = ["--network", "lenet", "--num-epochs", "2", "--kv-store", "local",
        "--batch-size", "64", "--lr", "0.05"]
SEED = 5
PARAM_TOL = 1e-6
TINY = np.finfo(np.float32).tiny    # a leaf that is all zeros

_JAX_WRAPPER = """
import os, runpy, sys
os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import numpy
numpy.random.seed(int(sys.argv[1]))
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _start(cmd, cwd):
    """The child ``python cmd`` in ``cwd``, started; ``_output`` waits."""
    env = dict(os.environ, MNIST_SYNTH_N="640", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               MNIST_DIR=os.path.join(cwd, "no-data"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.Popen([sys.executable] + cmd, cwd=cwd, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _output(proc):
    """The child's output once it has exited 0."""
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    return out


def _accuracies(out, kind):
    return {int(e): float(v) for e, v in re.findall(
        r"Epoch\[(\d+)\] %s-accuracy=([0-9.]+)" % kind, out)}


def _checkpoint(prefix):
    """LeNet's symbol and seeded params, written by the JAX package."""
    with jmx.name.NameManager():
        sym = jlenet.get_symbol(num_classes=10)
    rng = np.random.RandomState(SEED)
    arg_shapes, _, _ = sym.infer_shape(data=(64, 1, 28, 28))
    args = {n: jmx.nd.array((rng.normal(size=s) * (
        np.prod(s[1:]) ** -0.5 if len(s) > 1 else 0.1)).astype(np.float32))
        for n, s in zip(sym.list_arguments(), arg_shapes)
        if n not in ("data", "softmax_label")}
    jmx.model.save_checkpoint(prefix, 0, sym, args, {})


def test_train_mnist_runs_unchanged_against_the_port(tmp_path):
    procs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        prefix = str(d / "lenet")
        if name == "jax":
            _checkpoint(prefix)
            cmd = ["-c", _JAX_WRAPPER, str(SEED), SCRIPT]
        else:
            for suffix in ("-symbol.json", "-0000.params"):
                shutil.copy(str(tmp_path / "jax" / "lenet") + suffix,
                            prefix + suffix)
            cmd = ["-m", "mxnet_tpu_torch.run_script", "--np-seed",
                   str(SEED), SCRIPT]
        procs[name] = (_start(cmd + ARGS + ["--model-prefix", prefix,
                                            "--load-epoch", "0"], str(d)),
                       prefix)
    try:
        runs = {name: (_output(proc), jmx.model.load_params(
            prefix + "-0002.params")) for name, (proc, prefix) in
            procs.items()}
    finally:
        for proc, _ in procs.values():
            proc.kill()
    port_out = runs["port"][0]
    assert "run_script: jax not in sys.modules" in port_out, port_out[-3000:]
    assert "Loaded model" in port_out
    for kind, n in (("Train", 640), ("Validation", 128)):
        want = _accuracies(runs["jax"][0], kind)
        got = _accuracies(port_out, kind)
        assert sorted(got) == sorted(want) == [0, 1], (kind, got, want)
        for epoch in want:
            assert abs(got[epoch] - want[epoch]) <= 2.0 / n + 1e-9, \
                (kind, epoch, got, want)
    (want_arg, want_aux), (got_arg, got_aux) = runs["jax"][1], runs["port"][1]
    assert sorted(got_arg) == sorted(want_arg) and not got_aux
    for k, w in want_arg.items():
        w, g = w.asnumpy(), got_arg[k].asnumpy()
        err = np.abs(g - w).max() / max(np.abs(w).max(), TINY)
        assert err <= PARAM_TOL, (k, err)
