"""The port's neural-network ``mx.nd`` ops held against ``mxnet_tpu``'s on
the CPU (``ops/nn.py`` but RNN: its 23 registrations).

Each case runs in both packages on the same numpy inputs, recorded under
``autograd.record()`` (training mode) and seeded with one random
cotangent (``torch_nd_parity.check_op``): the output dtype is the
reference's, and outputs and input gradients agree within rtol 1e-4 /
atol 1e-5 (convolutions and normalizations sum in another order; the
symbolic tests' float32 tolerance is 2e-4). BatchNorm's moving
statistics, written back into the aux arrays in place, are held too.
The stochastic ops (Dropout in training, rrelu) draw from torch's
generator, which never equals jax's: they are held bit for bit where
they draw nothing (``p=0``, predict mode) and otherwise by their
distribution and their scaling.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from torch_nd_parity import check_op, rand
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-5

IMG = rand(1, (2, 4, 6, 6))
VEC = rand(2, (3, 5))
LAB = np.array([1, 0, 4], np.float32)

#: (id, op, inputs, attrs, differentiated inputs)
CASES = [
    ("fc", "FullyConnected", [IMG, rand(3, (7, 144)), rand(4, (7,))],
     {"num_hidden": 7}, (0, 1, 2)),
    ("fc_nobias_noflat", "FullyConnected", [IMG, rand(3, (5, 6))],
     {"num_hidden": 5, "no_bias": True, "flatten": False}, (0, 1)),
    ("conv2d", "Convolution", [IMG, rand(5, (6, 2, 3, 3)), rand(6, (6,))],
     {"kernel": (3, 3), "num_filter": 6, "stride": (2, 1), "pad": (1, 1),
      "num_group": 2}, (0, 1, 2)),
    ("conv1d_dilate", "Convolution", [rand(7, (2, 3, 9)),
                                      rand(8, (4, 3, 3)), rand(9, (4,))],
     {"kernel": (3,), "num_filter": 4, "pad": (1,), "dilate": (2,)},
     (0, 1, 2)),
    ("conv3d", "Convolution", [rand(7, (1, 2, 4, 4, 4)),
                               rand(8, (3, 2, 2, 2, 2)), rand(9, (3,))],
     {"kernel": (2, 2, 2), "num_filter": 3}, (0, 1, 2)),
    ("deconv", "Deconvolution", [IMG, rand(10, (4, 3, 3, 3)),
                                 rand(11, (3,))],
     {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2), "pad": (1, 1),
      "adj": (1, 1)}, (0, 1, 2)),
    ("pool_max", "Pooling", [IMG], {"kernel": (3, 3), "stride": (2, 2),
                                    "pad": (1, 1)}, (0,)),
    ("pool_avg_full", "Pooling", [IMG], {"kernel": (2, 2), "stride": (2, 2),
                                         "pool_type": "avg",
                                         "pooling_convention": "full",
                                         "pad": (1, 0)}, (0,)),
    ("pool_sum_global", "Pooling", [IMG], {"pool_type": "sum",
                                           "global_pool": True}, (0,)),
    ("act_softrelu", "Activation", [VEC], {"act_type": "softrelu"}, (0,)),
    ("act_softsign", "Activation", [VEC], {"act_type": "softsign"}, (0,)),
    ("leaky", "LeakyReLU", [VEC], {"slope": 0.1}, (0,)),
    ("prelu", "LeakyReLU", [IMG, rand(12, (4,), 0.0, 0.5)],
     {"act_type": "prelu"}, (0, 1)),
    ("elu", "LeakyReLU", [VEC], {"act_type": "elu", "slope": 0.7}, (0,)),
    ("selu", "LeakyReLU", [VEC], {"act_type": "selu"}, (0,)),
    ("gelu", "LeakyReLU", [VEC], {"act_type": "gelu"}, (0,)),
    ("softmax", "softmax", [VEC], {"axis": 0}, (0,)),
    ("log_softmax_temp", "log_softmax", [VEC], {"temperature": 2.0}, (0,)),
    ("softmax_act_inst", "SoftmaxActivation", [IMG], {}, (0,)),
    ("layernorm", "LayerNorm", [IMG, rand(13, (6,)), rand(14, (6,))], {},
     (0, 1, 2)),
    ("layernorm_axis1_mv", "LayerNorm", [IMG, rand(13, (4,)),
                                         rand(14, (4,))],
     {"axis": 1, "output_mean_var": True}, (0, 1, 2)),
    ("instancenorm", "InstanceNorm", [IMG, rand(13, (4,)), rand(14, (4,))],
     {"eps": 1e-3}, (0, 1, 2)),
    ("l2norm_chan", "L2Normalization", [IMG], {"mode": "channel"}, (0,)),
    ("lrn", "LRN", [IMG], {"nsize": 3, "alpha": 0.01}, (0,)),
    ("embedding", "Embedding", [np.array([[0, 3], [2, 2]], np.float32),
                                rand(15, (5, 3))],
     {"input_dim": 5, "output_dim": 3}, (1,)),
    ("upsample_nearest", "UpSampling", [IMG], {"scale": 2}, (0,)),
    ("upsample_bilinear", "UpSampling", [IMG], {"scale": 2,
                                               "sample_type": "bilinear"},
     (0,)),
    ("softmax_output", "SoftmaxOutput", [VEC, LAB],
     {"normalization": "batch", "grad_scale": 2.0}, (0,)),
    ("linreg", "LinearRegressionOutput", [VEC, rand(16, (3, 5))],
     {"grad_scale": 0.5}, (0, 1)),
    ("maereg", "MAERegressionOutput", [VEC, rand(16, (3, 5))], {}, (0,)),
    ("logreg", "LogisticRegressionOutput", [VEC, rand(16, (3, 5), 0, 1)],
     {}, (0,)),
    ("svm", "SVMOutput", [VEC, LAB], {"margin": 0.5}, (0,)),
    ("svm_linear", "SVMOutput", [VEC, LAB], {"use_linear": True,
                                             "regularization_coefficient":
                                             0.3}, (0,)),
    ("makeloss", "MakeLoss", [VEC], {"grad_scale": 3.0}, (0,)),
    ("makeloss_valid", "MakeLoss", [VEC], {"normalization": "valid",
                                           "valid_thresh": 0.1}, (0,)),
    ("dropout_p0", "Dropout", [VEC], {"p": 0.0}, (0,)),
]


@pytest.mark.parametrize("name,inputs,attrs,grad",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_nn_op_matches_the_reference(name, inputs, attrs, grad):
    check_op(name, inputs, attrs, grad=grad, rtol=RTOL, atol=ATOL)


def _bn(mx, x, attrs, train):
    ctx = mx.cpu()
    c = x.shape[attrs.get("axis", 1)]
    arrays = [mx.nd.array(a, ctx=ctx) for a in (
        x, np.full(c, 1.5, np.float32), np.full(c, 0.2, np.float32),
        np.full(c, 0.1, np.float32), np.full(c, 2.0, np.float32))]
    for a in arrays[:3]:
        a.attach_grad()
    with mx.autograd.record(train_mode=train):
        out = mx.nd.BatchNorm(*arrays, **attrs)
    outs = out if isinstance(out, list) else [out]
    cot = np.random.RandomState(0).standard_normal(outs[0].shape)
    mx.autograd.backward([outs[0]], [mx.nd.array(cot, ctx=ctx)])
    return ([o.asnumpy() for o in outs], [a.grad.asnumpy()
                                          for a in arrays[:3]],
            [a.asnumpy() for a in arrays[3:]])


@pytest.mark.parametrize("attrs,train", [
    ({"fix_gamma": False}, True), ({}, True), ({"fix_gamma": False}, False),
    ({"fix_gamma": False, "output_mean_var": True}, True),
    ({"fix_gamma": False, "axis": -1}, True)])
def test_batchnorm_and_its_moving_statistics_match_the_reference(attrs,
                                                                   train):
    x = rand(17, (4, 3, 5))       # a 3-D layout: (N, C, W)
    if attrs.get("axis") == -1:
        x = rand(17, (4, 5, 3))
    got, want = _bn(tmx, x, attrs, train), _bn(jmx, x, attrs, train)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_dropout_draws_nothing_in_predict_mode_and_keeps_p():
    x = rand(18, (64, 128), 0.5, 1.5)
    a = tmx.nd.array(x, ctx=tmx.cpu())
    for p in (0.0, 0.5):
        assert np.array_equal(tmx.nd.Dropout(a, p=p).asnumpy(), x)
    with tmx.autograd.train_mode():
        out = tmx.nd.Dropout(a, p=0.25).asnumpy()
        shared = tmx.nd.Dropout(a, p=0.5, axes=(1,)).asnumpy()
    kept = out != 0
    n = kept.size
    assert abs(kept.mean() - 0.75) < 5 * np.sqrt(0.75 * 0.25 / n)
    np.testing.assert_array_equal(out[kept], (x / 0.75).astype(
        np.float32)[kept])
    # axes=(1,): one draw a row
    assert all(len(set(r)) == 1 for r in (shared != 0))
    # mode="always" draws outside training too
    assert (tmx.nd.Dropout(a, p=0.5, mode="always").asnumpy() == 0).any()


def test_rrelu_draws_its_slopes_in_training_and_means_them_otherwise():
    x = -rand(19, (32, 32), 0.5, 1.5)
    lo, hi = 0.125, 0.334
    a, j = tmx.nd.array(x, ctx=tmx.cpu()), jmx.nd.array(x)
    check_op("LeakyReLU", [x], {"act_type": "rrelu"}, values=False)
    np.testing.assert_allclose(
        tmx.nd.LeakyReLU(a, act_type="rrelu").asnumpy(),
        jmx.nd.LeakyReLU(j, act_type="rrelu").asnumpy(), rtol=1e-6)
    with tmx.autograd.train_mode():
        slope = tmx.nd.LeakyReLU(a, act_type="rrelu").asnumpy() / x
    assert slope.min() >= lo and slope.max() <= hi
    assert abs(slope.mean() - (lo + hi) / 2) < 0.01
