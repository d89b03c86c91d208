"""``mx.rnn`` of the port held against ``mxnet_tpu``'s on the CPU.

- Every cell's ``unroll`` (``RNNCell`` tanh and relu, ``LSTMCell``,
  ``GRUCell``, ``FusedRNNCell`` in lstm and gru, ``SequentialRNNCell``,
  ``BidirectionalCell``, ``ResidualCell``, and the conv cells
  ``ConvRNNCell``, ``ConvLSTMCell`` and ``ConvGRUCell``), built the same
  way in both packages into one grouped graph on the same numpy weights:
  argument names, output shapes, the training forward and every argument
  gradient for random head gradients within rtol 1e-5 / atol 1e-5 (the
  unrolled sums run in another order than the reference's).
- ``DropoutCell`` and ``ZoneoutCell``: the reference's graph structure; at
  inference each is its base cell, and in training the same seed draws
  the same masks.
- ``FusedRNNCell`` against the network ``unfuse()`` builds on the unpacked
  weights; ``unpack_weights`` / ``pack_weights`` against the reference's
  and across the packages.
- ``encode_sentences`` and ``BucketSentenceIter`` batch for batch (the
  same ``shuffle_seed`` gives the same order), and RNN checkpoints that
  one package writes and the other reads.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-5
T, N, C, H = 2, 2, 4, 5
CONV_IN = (2, 4, 4)     # (C, H, W) of the conv cells' inputs


def _cells_graph(mx):
    """One graph holding every deterministic cell's unrolled output."""
    data = mx.sym.Variable("data")            # (N, T, C)
    cdata = mx.sym.Variable("cdata")          # (N, T) + CONV_IN
    rnn = mx.rnn
    outs = []
    for cell in (rnn.RNNCell(H, "tanh", prefix="tanh_"),
                 rnn.RNNCell(H, "relu", prefix="relu_"),
                 rnn.LSTMCell(H, prefix="lstm_"),
                 rnn.GRUCell(H, prefix="gru_"),
                 rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                  bidirectional=True, prefix="flstm_"),
                 rnn.FusedRNNCell(H, num_layers=2, mode="gru",
                                  prefix="fgru_",
                                  get_next_state=True),
                 rnn.SequentialRNNCell().add(
                     rnn.LSTMCell(H, prefix="seq0_")).add(
                     rnn.GRUCell(H, prefix="seq1_")),
                 rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="bl_"),
                                       rnn.GRUCell(H, prefix="br_")),
                 rnn.ResidualCell(rnn.GRUCell(C, prefix="res_"))):
        o, states = cell.unroll(T, data, merge_outputs=True)
        outs.append(o)
        outs.extend(states)
    for cell in (rnn.ConvRNNCell(CONV_IN, 3, prefix="crnn_"),
                 rnn.ConvLSTMCell(CONV_IN, 3, prefix="clstm_"),
                 rnn.ConvGRUCell(CONV_IN, 3, prefix="cgru_")):
        o, states = cell.unroll(T, cdata, merge_outputs=False)
        outs.extend(o + states)
    return mx.sym.Group(outs)


def _run_graph(mx, values, backward=True, head_seed=2):
    sym = _cells_graph(mx)
    exe = sym.simple_bind(mx.cpu(), data=(N, T, C), cdata=(N, T) + CONV_IN,
                          grad_req="write" if backward else "null")
    for name, arr in exe.arg_dict.items():
        arr[:] = values[name]
    outs = [o.asnumpy() for o in exe.forward(is_train=backward)]
    if not backward:
        return sym.list_arguments(), outs, None
    rng = np.random.RandomState(head_seed)
    heads = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    exe.backward([mx.nd.array(h, ctx=mx.cpu()) for h in heads])
    return (sym.list_arguments(), outs,
            {n: g.asnumpy() for n, g in exe.grad_dict.items()})


@pytest.fixture(scope="module")
def values():
    sym = _cells_graph(jmx)
    shapes, _, _ = sym.infer_shape(data=(N, T, C), cdata=(N, T) + CONV_IN)
    rng = np.random.RandomState(0)
    return {n: (0.4 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)}


def test_every_cell_unrolls_as_the_reference(values):
    want_args, want_outs, _ = _run_graph(jmx, values, backward=False)
    got_args, got_outs, _ = _run_graph(tmx, values, backward=False)
    assert got_args == want_args
    assert [o.shape for o in got_outs] == [o.shape for o in want_outs]
    for g, w in zip(got_outs, want_outs):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _stochastic(mx, p):
    with mx.name.NameManager():   # the auto names count from 0 in both
        base = mx.rnn.LSTMCell(H, prefix="z_")
        zone = mx.rnn.ZoneoutCell(base, zoneout_outputs=p,
                                  zoneout_states=p)
        drop = mx.rnn.DropoutCell(p, prefix="d_")
        stack = mx.rnn.SequentialRNNCell().add(zone).add(drop)
        out, states = stack.unroll(T, mx.sym.Variable("data"),
                                   merge_outputs=True)
        return mx.sym.Group([out] + states)


def _bind_stochastic(p, values):
    sym = _stochastic(tmx, p)
    exe = sym.simple_bind(tmx.cpu(), data=(N, T, C))
    for name, arr in exe.arg_dict.items():
        arr[:] = values[name]
    return exe


def test_dropout_and_zoneout_cells():
    shapes = [(_stochastic(mx, 0.5).list_arguments(),
               _stochastic(mx, 0.5).list_outputs(),
               _stochastic(mx, 0.5).infer_shape(data=(N, T, C)))
              for mx in (jmx, tmx)]
    assert shapes[0] == shapes[1]
    arg_shapes = dict(zip(shapes[1][0], shapes[1][2][0]))
    rng = np.random.RandomState(1)
    values = {n: rng.randn(*s).astype(np.float32)
              for n, s in arg_shapes.items()}
    # at inference each is its base cell (p=0 graphs have no Dropout)
    plain = [o.asnumpy() for o in _bind_stochastic(0.0, values).forward()]
    infer = [o.asnumpy() for o in _bind_stochastic(0.5, values).forward()]
    for a, b in zip(infer, plain):
        np.testing.assert_array_equal(a, b)
    # in training the same seed draws the same masks, another seed others
    runs = []
    for seed in (3, 3, 4):
        tmx.random.seed(seed)
        runs.append([o.asnumpy() for o in _bind_stochastic(
            0.5, values).forward(is_train=True)])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert not np.array_equal(runs[0][0], runs[2][0])
    assert not np.array_equal(runs[0][0], plain[0])


@pytest.mark.parametrize("mode,bi", [("lstm", True), ("gru", False),
                                     ("rnn_tanh", True)])
def test_fused_cell_equals_its_unfused_network(mode, bi):
    fused = tmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                 bidirectional=bi, prefix="f_")
    data = tmx.sym.Variable("data")
    f_out, _ = fused.unroll(T, data, merge_outputs=True)
    u_out, _ = fused.unfuse().unroll(T, data, merge_outputs=True)
    n = tmx.ops.nn.rnn_param_size(mode, C, H, 2, bi)
    blob = (0.4 * np.random.RandomState(5).randn(n)).astype(np.float32)
    x = np.random.RandomState(6).randn(N, T, C).astype(np.float32)
    unpacked = fused.unpack_weights({"f_parameters": tmx.nd.array(
        blob, ctx=tmx.cpu())})
    got = f_out.eval(tmx.cpu(), data=tmx.nd.array(x, ctx=tmx.cpu()),
                     f_parameters=tmx.nd.array(blob, ctx=tmx.cpu()))
    want = u_out.eval(tmx.cpu(), data=tmx.nd.array(x, ctx=tmx.cpu()),
                      **unpacked)
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(),
                               rtol=RTOL, atol=ATOL)
    # the names and arrays of the unpacked weights are the reference's,
    # and each package packs the other's pieces back into the blob
    jfused = jmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                  bidirectional=bi, prefix="f_")
    jpieces = jfused.unpack_weights({"f_parameters": jmx.nd.array(blob)})
    assert sorted(jpieces) == sorted(unpacked)
    for k in unpacked:
        np.testing.assert_array_equal(unpacked[k].asnumpy(),
                                      jpieces[k].asnumpy())
        assert unpacked[k].context == torch.device("cpu")
    back = fused.pack_weights({k: v.asnumpy() for k, v in jpieces.items()})
    np.testing.assert_array_equal(back["f_parameters"].asnumpy(), blob)
    jback = jfused.pack_weights({k: v.asnumpy() for k, v in
                                 unpacked.items()})
    np.testing.assert_array_equal(jback["f_parameters"].asnumpy(), blob)


def _sentences(n=60, seed=0):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(12)]
    return [[words[i] for i in rng.randint(0, 12, rng.randint(1, 9))]
            for _ in range(n)]


def test_encode_sentences_and_bucket_iterator_batch_for_batch():
    sents = _sentences()
    got = tmx.rnn.encode_sentences(sents, start_label=1, invalid_label=0)
    want = jmx.rnn.encode_sentences(sents, start_label=1, invalid_label=0)
    assert got == want
    with pytest.raises(ValueError, match="Unknown token"):
        tmx.rnn.encode_sentences([["zz"]], vocab=got[1])
    for kw in ({"buckets": [3, 5, 8], "invalid_label": 0, "shuffle_seed": 1},
               {"buckets": None, "layout": "TN", "shuffle_seed": 2}):
        its = [mx.rnn.BucketSentenceIter(got[0], 4, **kw)
               for mx in (jmx, tmx)]
        assert its[0].default_bucket_key == its[1].default_bucket_key
        assert its[0].provide_data == its[1].provide_data
        for _ in range(2):   # two epochs: reset reshuffles alike
            batches = [list(it) for it in its]
            assert len(batches[0]) == len(batches[1]) > 3
            for jb, tb in zip(*batches):
                assert jb.bucket_key == tb.bucket_key
                assert jb.provide_data == tb.provide_data
                assert jb.provide_label == tb.provide_label
                np.testing.assert_array_equal(jb.data[0].asnumpy(),
                                              tb.data[0].asnumpy())
                np.testing.assert_array_equal(jb.label[0].asnumpy(),
                                              tb.label[0].asnumpy())
                assert tb.data[0].context == torch.device("cpu")
            for it in its:
                it.reset()


@pytest.mark.parametrize("writer,reader", [(jmx, tmx), (tmx, jmx)],
                         ids=("reference_to_port", "port_to_reference"))
def test_rnn_checkpoints_cross_the_packages(tmp_path, writer, reader):
    n = tmx.ops.nn.rnn_param_size("lstm", C, H, 2, False)
    blob = np.random.RandomState(7).randn(n).astype(np.float32)

    def cell(mx):
        return mx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                   prefix="ck_")
    wcell = cell(writer)
    sym, _ = wcell.unroll(T, writer.sym.Variable("data"),
                          merge_outputs=True)
    prefix = str(tmp_path / "lm")
    writer.rnn.save_rnn_checkpoint(
        wcell, prefix, 3, sym,
        {"ck_parameters": writer.nd.array(blob, ctx=writer.cpu())}, {})
    # the file holds the unpacked per-cell weights
    on_disk = tmx.nd.load(prefix + "-0003.params")
    assert "arg:ck_l0_i2h_weight" in on_disk and \
        "arg:ck_parameters" not in on_disk
    rsym, args, aux = reader.rnn.load_rnn_checkpoint(cell(reader), prefix, 3)
    np.testing.assert_array_equal(args["ck_parameters"].asnumpy(), blob)
    assert rsym.list_arguments() == sym.list_arguments() and aux == {}
    cb = reader.rnn.do_rnn_checkpoint(cell(reader), prefix + "b", period=2)
    cb(1, rsym, args, aux)
    assert (tmp_path / "lmb-0002.params").exists()
