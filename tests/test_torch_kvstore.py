"""The port's KVStore and 2-bit gradient compression held against the JAX
package on the CPU (the cases of the reference's
``tests/python/unittest/test_kvstore.py``).

Every input is made from a numpy seed and goes through both stores.

- Pairs, lists, the updater on push and the sum of several device copies
  (summed in list order on the first copy's device): the pulled values
  bit for bit the reference's (float32 adds in the same order).
- Compression: the packed words equal the reference's ``uint32`` values
  and the residuals its float32 bits, at sizes that are not multiples of
  16 and with residuals that sit on the threshold and at -0.0; the bit
  layout of the reference's kernels; ten error-feedback rounds bit for
  bit; compressed pushes over three copies (``device``) and two
  (``tpu_sync``) bit for bit; the parameter errors and ``encode_params``.
- ``Module(compression_params=...)`` with ``tpu_sync`` takes the store's
  push path, never the fused step, in both packages.
- ``create`` names: ``dist_sync``, ``dist_device_sync``, ``device`` and
  ``nccl`` work, with ``rank`` 0 and ``num_workers`` 1 in one process;
  ``dist_async`` raises (ROADMAP A7 part 2); ``row_sparse_pull`` raises
  (ROADMAP A9 part 2).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gradient_compression as jgc

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import gradient_compression as tgc
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SHAPE = (4, 4)
KEYS = [5, 7, 11]
CPU = tmx.cpu()


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _nd(mx, a):
    return mx.nd.array(a, ctx=mx.cpu())


def _pull(mx, kv, key, shape=SHAPE):
    out = mx.nd.zeros(shape, ctx=mx.cpu())
    kv.pull(key, out=out)
    return out.asnumpy()


def _init(mx, kv_type="local"):
    kv = mx.kv.create(kv_type)
    kv.init(3, mx.nd.ones(SHAPE, ctx=mx.cpu()))
    kv.init(KEYS, [mx.nd.ones(SHAPE, ctx=mx.cpu())] * len(KEYS))
    return kv


def _in_both(run):
    """``run(mx)`` in the reference, then in the port."""
    return run(jmx), run(tmx)


def test_single_and_list_pairs_match_reference():
    rng = np.random.RandomState(0)
    one = rng.normal(size=SHAPE).astype(np.float32)
    many = [rng.normal(size=SHAPE).astype(np.float32) for _ in KEYS]

    def run(mx):
        kv = _init(mx)
        kv.push(3, _nd(mx, one))
        kv.push(KEYS, [_nd(mx, v) for v in many])
        outs = [mx.nd.zeros(SHAPE, ctx=mx.cpu()) for _ in KEYS]
        kv.pull(KEYS, out=outs)
        return [_pull(mx, kv, 3)] + [o.asnumpy() for o in outs]

    want, got = _in_both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    np.testing.assert_array_equal(got[0], one)


@pytest.mark.parametrize("kv_type", ["device", "local"])
def test_aggregation_exactness_matches_reference(kv_type):
    """Pushing 4 device copies pulls their sum, added in list order: the
    reference's bits (the nightly dist_sync assertion, one process)."""
    rng = np.random.RandomState(1)
    vals = [rng.normal(size=SHAPE).astype(np.float32) * 10 ** i
            for i in range(4)]

    def run(mx):
        kv = _init(mx, kv_type)
        kv.push(3, [_nd(mx, v) for v in vals])
        ints = [_nd(mx, np.full(SHAPE, i + 1, np.float32)) for i in range(4)]
        kv.push(5, ints)
        return _pull(mx, kv, 3), _pull(mx, kv, 5)

    (want, want_ints), (got, got_ints) = _in_both(run)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got_ints, np.full(SHAPE, 10.0))
    expect = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    np.testing.assert_array_equal(_bits(got), _bits(expect))


def test_updater_runs_on_push_matches_reference():
    rng = np.random.RandomState(2)
    grads = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(2)]

    def run(mx):
        kv = _init(mx, "device")
        keys = []

        def updater(key, recv, local):
            keys.append(key)
            local += recv * 2

        kv._update_rule(updater)
        kv.push(3, [_nd(mx, g) for g in grads])
        kv.push("7", _nd(mx, grads[0]))
        return keys, _pull(mx, kv, 3), _pull(mx, kv, 7)

    (jkeys, j3, j7), (tkeys, t3, t7) = _in_both(run)
    assert tkeys == jkeys == [3, 7]
    np.testing.assert_array_equal(_bits(t3), _bits(j3))
    np.testing.assert_array_equal(_bits(t7), _bits(j7))


def test_uninitialized_key_and_row_sparse_pull_raise():
    for mx in (jmx, tmx):
        kv = mx.kv.create("local")
        with pytest.raises(Exception, match="has not been initialized"):
            kv.push(99, mx.nd.ones(SHAPE, ctx=mx.cpu()))
        with pytest.raises(Exception, match="has not been initialized"):
            kv.pull(99, out=mx.nd.ones(SHAPE, ctx=mx.cpu()))
    kv = tmx.kv.create("local")
    kv.init("w", tmx.nd.ones((5, 4), ctx=CPU))
    with pytest.raises(MXNetError, match="not yet ported \\(ROADMAP A9"):
        kv.row_sparse_pull("w", out=[tmx.nd.zeros((5, 4), ctx=CPU)],
                           row_ids=tmx.nd.array([1, 3], ctx=CPU))


def test_create_names_and_identity():
    for name in ("local", "device", "nccl", "tpu_sync", "dist_sync",
                 "dist_device_sync"):
        kv, jkv = tmx.kv.create(name), jmx.kv.create(name)
        assert (kv.type, type(kv).__name__) == (jkv.type,
                                                type(jkv).__name__)
        assert (kv.rank, kv.num_workers, kv.get_rank(),
                kv.get_group_size()) == (0, 1, 0, 1)
        assert kv.is_worker_node() and not kv.is_server_node()
        kv.barrier()
    with pytest.raises(MXNetError,
                       match="not yet ported \\(ROADMAP A7 part 2\\)"):
        tmx.kv.create("dist_async")
    with pytest.raises(MXNetError, match="unknown kvstore type"):
        tmx.kv.create("nope")
    kv = tmx.kv.create("local")
    with pytest.raises(MXNetError, match="Cannot save states for "
                       "distributed training"):
        kv.save_optimizer_states("unused")


# ---------------------------------------------------------- compression ----

@pytest.mark.parametrize("n", [37, 16, 2, 250])
def test_compression_quantize_exact(n):
    """Packed words, residuals and dequantized values bit for bit the
    reference's (n not a multiple of 16 included; residuals placed on
    +-threshold and at -0.0)."""
    rng = np.random.RandomState(n)
    grad = rng.normal(0, 1, n).astype(np.float32)
    residual = rng.normal(0, 0.4, n).astype(np.float32)
    m = min(n, 3)
    residual[:m] = [-0.0, 0.5, -0.5][:m]
    grad[:m] = 0.0
    jp, jr = jgc.quantize_2bit(grad, residual, 0.5)
    tp, tr = tgc.quantize_2bit(torch.from_numpy(grad),
                               torch.from_numpy(residual), 0.5)
    assert tp.dtype == torch.uint32 and tuple(tp.shape) == ((n + 15) // 16,)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(tr.numpy()), _bits(jr))
    np.testing.assert_array_equal(
        _bits(tgc.dequantize_2bit(tp, 0.5, n).numpy()),
        _bits(jgc.dequantize_2bit(jp, 0.5, n)))


def test_compression_bit_layout():
    """Element i lands in byte i >> 2, bits 7-6 downward (the reference's
    posbits {0xc0, 0x30, 0x0c, 0x03})."""
    grad = np.zeros(16, np.float32)
    grad[0], grad[5], grad[15] = 1.0, -1.0, 1.0
    packed, _ = tgc.quantize_2bit(torch.from_numpy(grad), torch.zeros(16),
                                  0.5)
    word = int(packed.to(torch.int64)[0])
    assert word & 0xFF == 0xC0
    assert (word >> 8) & 0xFF == 0x20
    assert (word >> 24) & 0xFF == 0x03
    jp, _ = jgc.quantize_2bit(grad, np.zeros(16, np.float32), 0.5)
    assert word == int(np.asarray(jp)[0])


def test_compression_error_feedback_matches_reference():
    """Ten rounds of the round trip: every received value and residual
    bit for bit the reference's; the emitted mass tracks the gradients'."""
    gc, jg = tgc.GradientCompression(), jgc.GradientCompression()
    for c in (gc, jg):
        c.set_params({"type": "2bit", "threshold": 0.5})
    rng = np.random.RandomState(3)
    r, jr = torch.zeros(24), np.zeros(24, np.float32)
    total = np.zeros(24, np.float32)
    for _ in range(10):
        g = rng.normal(0.2, 0.3, (4, 6)).astype(np.float32)
        recv, r = gc.compress_decompress(torch.from_numpy(g), r)
        jrecv, jr = jg.compress_decompress(g, jr)
        assert tuple(recv.shape) == (4, 6)
        np.testing.assert_array_equal(_bits(recv.numpy()), _bits(jrecv))
        np.testing.assert_array_equal(_bits(r.numpy()), _bits(jr))
        total += recv.numpy().ravel()
    assert abs(total.mean() - 2.0) < 0.5


@pytest.mark.parametrize("kv_type,copies", [("device", 3), ("tpu_sync", 2)])
def test_compression_on_kvstore_push_matches_reference(kv_type, copies):
    """Two compressed pushes of several copies: the pulled sums bit for bit
    the reference's, one residual per (key, slot)."""
    shape = (3, 5)
    rng = np.random.RandomState(4)
    rounds = [[rng.normal(0, 1, shape).astype(np.float32)
               for _ in range(copies)] for _ in range(2)]

    def run(mx):
        kv = mx.kv.create(kv_type)
        kv.init("w", mx.nd.zeros(shape, ctx=mx.cpu()))
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        pulled = []
        for grads in rounds:
            kv.push("w", [_nd(mx, g) for g in grads])
            pulled.append(_pull(mx, kv, "w", shape))
        return pulled, sorted(kv._residuals)

    (want, jkeys), (got, tkeys) = _in_both(run)
    assert tkeys == jkeys == [("w", s) for s in range(copies)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert set(np.unique(np.abs(got[0]))) <= {0.0, 0.5, 1.0, 1.5}


def test_compression_params_validation():
    for mx in (jmx, tmx):
        kv = mx.kv.create("device")
        with pytest.raises(Exception, match="Unknown type"):
            kv.set_gradient_compression({"type": "1bit"})
        with pytest.raises(Exception, match="greater than 0"):
            kv.set_gradient_compression({"type": "2bit", "threshold": 0})
        with pytest.raises(Exception, match="unknown gradient compression"):
            kv.set_gradient_compression({"type": "2bit", "step": 1})
    gc = tmx.kv.create("device")
    gc.set_gradient_compression({"type": "2bit", "threshold": 2.0})
    assert gc._gc.encode_params() == "2,2.0"
    assert gc._gc.get_compressed_size(33) == 3
    back = tgc.GradientCompression()
    back.decode_params("2,1.5")
    assert (back.type, back.threshold, back.active) == ("2bit", 1.5, True)
    back.decode_params("0")
    assert not back.active


def _small_fit(mx, compression):
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (64, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=16)
    with mx.name.NameManager():
        net = mx.sym.SoftmaxOutput(
            mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                                  name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu(),
                        **({"compression_params": {"type": "2bit",
                                                   "threshold": 0.5}}
                           if compression else {}))
    w = rng.normal(0, 0.1, (2, 8)).astype(np.float32)
    mod.fit(it, num_epoch=2, kvstore="tpu_sync",
            optimizer_params={"learning_rate": 0.1},
            arg_params={"fc_weight": _nd(mx, w),
                        "fc_bias": mx.nd.zeros((2,), ctx=mx.cpu())})
    return mod


def test_compression_routes_module_off_fused_step():
    """compression_params with tpu_sync: the store's compressed push path,
    not the fused step, in both packages, with the same weights (within
    1e-6 of the weight's scale: one float32 forward's rounding under a
    0.5 threshold); without compression the fused step builds."""
    jmod, tmod = _small_fit(jmx, True), _small_fit(tmx, True)
    for mod in (jmod, tmod):
        assert mod._fused_step is None
        assert mod._kvstore is not None and mod._kvstore._gc.active
    want = jmod.get_params()[0]["fc_weight"].asnumpy()
    got = tmod.get_params()[0]["fc_weight"].asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(
        want).max())
    assert _small_fit(tmx, False)._fused_step is not None
