"""The port's catalog-completing ops and legacy aliases held against
``mxnet_tpu``'s on the CPU (``mxnet_tpu_torch/ops/compat_extra.py``),
and the op list of the whole port against the reference's.

- The 24 ops of ``compat_extra``: the deterministic ones through the
  reference op (one jitted program for the file) and the port's ``mx.nd``
  op on the same seeded numpy inputs, outputs and gradients within rtol
  1e-5 / atol 1e-6, bipartite matching's ids equal.
  ``IdentityAttachKLSparseReg`` through both ops directly (its aux
  output), also under a supervised step's loss scale, which multiplies
  the penalty. ``_contrib_ProposalTarget`` and
  ``_random_generalized_negative_binomial`` draw from the op's
  generator: reproducible from a seed, the proposal target's structure
  (the foreground share, the classes, the targets of the sampled rois by
  the reference's encoding in numpy) and the sampler's mean and
  variance.
- The port registers 264 of the reference's 271 ops, every one but the
  seven quantization ops, which raise "(ROADMAP A9" in ``get_op``,
  ``load_json`` and both ``contrib`` namespaces; each of the reference's
  150 aliases resolves to the reference's op; a compat alias whose target
  is missing raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import OPS as JOPS
from mxnet_tpu.ops import find_op as jfind_op
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import registry as jregistry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OPS as TOPS
from mxnet_tpu_torch.ops import compat_extra, find_op, get_op
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.registry import QUANTIZED
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_op_parity import case, check, rand, reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

A = rand(0, (4, 5))
FEAT = rand(1, (2, 8, 7, 8))
PS_ROIS = np.array([[0, 1.5, 0.5, 6.0, 5.5], [1, 0.0, 1.0, 7.0, 6.0],
                    [1, 2.0, 2.0, 2.0, 3.0]], np.float32)
SCORES = rand(2, (2, 5, 4), 0.0, 1.0)
IMG_HWC = np.random.RandomState(3).randint(0, 256, (5, 6, 3)).astype(
    np.uint8)

CASES = [
    case("psroi_pooling", "_contrib_PSROIPooling", [FEAT, PS_ROIS],
         {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 2},
         grad=(0,)),
    case("psroi_pooling_group", "_contrib_PSROIPooling", [FEAT, PS_ROIS],
         {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3,
          "group_size": 2}, grad=(0,)),
    case("batch_take", "batch_take", [A, np.array([0, 4, 2, 1],
                                                  np.float32)], grad=(0,)),
    case("reshape_like", "reshape_like", [A, np.zeros((2, 10), np.float32)],
         grad=(0,)),
    case("softmax_cross_entropy", "softmax_cross_entropy",
         [A, np.array([1, 0, 4, 2], np.float32)], grad=(0,)),
    case("eye", "_eye", [], {"N": 4, "M": 6, "k": 1}),
    case("eye_int", "_eye", [], {"N": 3, "k": -1, "dtype": "int32"}),
    case("grad_add", "_grad_add", [A, rand(4, A.shape)], grad=(0, 1)),
    case("identity_like_rhs", "_identity_with_attr_like_rhs",
         [A, rand(5, A.shape)], grad=(0,)),
    case("sparse_retain", "sparse_retain", [A, np.array([3, 1], np.float32)],
         grad=(0,)),
    case("cast_storage", "cast_storage", [A], {"stype": "row_sparse"},
         grad=(0,)),
    case("image_normalize_chw", "_image_normalize", [rand(6, (3, 4, 5))],
         {"mean": (0.1, 0.2, 0.3), "std": (0.5, 0.6, 0.7)}, grad=(0,)),
    case("image_normalize_nchw", "_image_normalize", [rand(7, (2, 3, 4, 5))],
         {"mean": (0.1, 0.2, 0.3), "std": (0.5, 0.6, 0.7)}, grad=(0,)),
    case("image_to_tensor", "_image_to_tensor", [IMG_HWC]),
    case("image_to_tensor_nhwc", "_image_to_tensor",
         [np.stack([IMG_HWC, IMG_HWC[::-1]])]),
    case("ftml_update", "ftml_update",
         [A, rand(8, A.shape), rand(9, A.shape, 0.1, 1.0),
          rand(10, A.shape, 0.0, 0.1), rand(11, A.shape)],
         {"lr": 0.1, "t": 3, "wd": 0.01, "rescale_grad": 0.5,
          "clip_grad": 0.4}),
    case("slice_assign", "_slice_assign", [A, rand(12, (2, 2))],
         {"begin": (1, 1), "end": (3, 5), "step": (1, 2)}, grad=(0, 1)),
    case("slice_assign_negative_step", "_slice_assign",
         [A, rand(13, (2, 5))], {"begin": (3, 0), "end": (0, 5),
                                 "step": (-2, 1)}, grad=(0, 1)),
    case("slice_assign_scalar", "_slice_assign_scalar", [A],
         {"begin": (0, 2), "end": (2, 4), "scalar": 7.0}, grad=(0,)),
    case("scatter_set_nd", "_scatter_set_nd",
         [A, rand(14, (3,)), np.array([[0, 2, 3], [1, 4, 0]], np.float32)],
         {"shape": (4, 5)}, grad=(0, 1)),
    case("scatter_plus_scalar", "_scatter_plus_scalar", [A],
         {"scalar": 1.5}, grad=(0,)),
    case("scatter_minus_scalar", "_scatter_minus_scalar", [A],
         {"scalar": 1.5}, grad=(0,)),
    case("scatter_elemwise_div", "_scatter_elemwise_div",
         [A, rand(15, A.shape, 0.5, 2.0)], grad=(0, 1)),
    case("bipartite_matching", "_contrib_bipartite_matching", [SCORES],
         {"threshold": 0.2}, exact=(0, 1)),
    case("bipartite_matching_ascend_topk", "_contrib_bipartite_matching",
         [SCORES], {"threshold": 0.6, "is_ascend": True, "topk": 2},
         exact=(0, 1)),
    case("hypot_scalar", "_hypot_scalar", [A], {"scalar": 0.7}, grad=(0,)),
    case("broadcast_axis", "broadcast_axis", [rand(16, (3, 1, 1))],
         {"axis": (1, 2), "size": (4, 2)}, grad=(0,)),
]
BY_ID = {c.id: c for c in CASES}


@pytest.fixture(scope="module")
def want():
    return reference(CASES)


@pytest.mark.parametrize("cid", [c.id for c in CASES])
def test_compat_op_matches_the_reference(want, cid):
    check(BY_ID[cid], want[cid])


@pytest.mark.parametrize("scale", [None, 8.0], ids=["plain", "loss_scale"])
def test_kl_sparse_reg_matches_the_reference(scale):
    data = rand(17, (6, 5), 0.05, 0.95)
    avg = rand(18, (5,), 0.05, 0.3)
    cot = rand(19, data.shape)
    attrs = {"sparseness_target": 0.2, "penalty": 0.01, "momentum": 0.8}
    jop = JOPS["IdentityAttachKLSparseReg"]
    jp = jop.make_params(attrs)
    with jnn.loss_grad_scale_scope(None if scale is None
                                   else jnp.float32(scale)):
        (out, new_avg), vjp = jax.vjp(
            lambda d: jop.apply(jp, (d, jnp.asarray(avg))), data)
        jgrad = vjp((jnp.asarray(cot), jnp.zeros_like(new_avg)))[0]
    top = TOPS["IdentityAttachKLSparseReg"]
    x = torch.tensor(data, requires_grad=True)
    with tnn.loss_grad_scale_scope(None if scale is None
                                   else torch.tensor(scale)):
        tout, tavg = top.apply(top.make_params(attrs),
                               (x, torch.tensor(avg)))
        tgrad, = torch.autograd.grad(tout, x, torch.tensor(cot))
    np.testing.assert_allclose(tout.detach().numpy(), out, rtol=1e-6)
    np.testing.assert_allclose(tavg.detach().numpy(), new_avg, rtol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-5, atol=1e-6)
    args, _, aux = tmx.sym.IdentityAttachKLSparseReg(
        tmx.sym.Variable("data"), name="kl").infer_shape(data=(6, 5))
    assert aux == [(5,)]


def _proposal_target(seed, rois, gt):
    op = TOPS["_contrib_ProposalTarget"]
    params = op.make_params({"num_classes": 4, "batch_images": 1,
                             "batch_rois": 8, "fg_fraction": 0.5})
    return [o.numpy() for o in op.apply(
        params, (torch.tensor(rois), torch.tensor(gt)),
        rng=torch.Generator().manual_seed(seed))]


def test_proposal_target_samples_as_the_reference_defines():
    rng = np.random.RandomState(20)
    xy = rng.uniform(0, 40, (20, 2))
    rois = np.concatenate([np.zeros((20, 1)), xy, xy + rng.uniform(
        8, 30, (20, 2))], axis=1).astype(np.float32)
    gt = np.array([[5, 5, 30, 30, 1], [20, 10, 50, 45, 3],
                   [0, 0, 0, 0, 0]], np.float32)      # the last: padding
    rois[:3, 1:] = gt[0, :4] + [0, 0, 1, 0]           # three clear fg
    a = _proposal_target(1, rois, gt)
    b = _proposal_target(1, rois, gt)
    c = _proposal_target(2, rois, gt)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    out_rois, label, tgt, wgt = a
    # IoU against the valid ground truths, in numpy (+1 pixel widths)
    def iou(r, g):
        iw = max(min(r[2], g[2]) - max(r[0], g[0]) + 1, 0)
        ih = max(min(r[3], g[3]) - max(r[1], g[1]) + 1, 0)
        inter = iw * ih
        area = lambda b: (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
        return inter / (area(r) + area(g) - inter)
    ious = np.array([[iou(r[1:], g) for g in gt[:2]] for r in out_rois])
    fg = ious.max(axis=1) >= 0.5
    n_fg = int(fg.sum())
    assert 3 <= n_fg <= 4 and fg[:n_fg].all() and not fg[n_fg:].any()
    np.testing.assert_array_equal(label[:n_fg],
                                  gt[ious[:n_fg].argmax(axis=1), 4])
    assert not label[n_fg:].any()
    for i in range(n_fg):
        r, g = out_rois[i, 1:], gt[ious[i].argmax(), :4]
        bw, bh = r[2] - r[0] + 1, r[3] - r[1] + 1
        gw, gh = g[2] - g[0] + 1, g[3] - g[1] + 1
        t = np.array([(g[0] + 0.5 * (gw - 1) - r[0] - 0.5 * (bw - 1)) / bw,
                      (g[1] + 0.5 * (gh - 1) - r[1] - 0.5 * (bh - 1)) / bh,
                      np.log(gw / bw), np.log(gh / bh)]) / [0.1, 0.1, 0.2,
                                                             0.2]
        k = int(label[i]) * 4
        np.testing.assert_allclose(tgt[i, k:k + 4], t, rtol=1e-5, atol=1e-5)
        assert wgt[i].sum() == 4 and wgt[i, k:k + 4].all()
    assert not tgt[n_fg:].any() and not wgt[n_fg:].any()


def test_generalized_negative_binomial_moments_and_seed():
    def draw(seed):
        tmx.random.seed(seed)
        return tmx.nd.random_generalized_negative_binomial(
            mu=3.0, alpha=0.5, shape=(20000,), ctx=tmx.cpu()).asnumpy()
    a, b = draw(3), draw(3)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and (a >= 0).all() and \
        (a == np.round(a)).all()
    # mean mu, variance mu + alpha mu^2 (the reference's parametrisation)
    assert abs(a.mean() - 3.0) < 0.1
    assert abs(a.var() - (3.0 + 0.5 * 9.0)) < 0.5


def test_the_port_registers_every_reference_op_but_quantization():
    missing = sorted(set(JOPS) - set(TOPS))
    assert len(JOPS) == 271 and len(missing) == 7
    assert missing == sorted(QUANTIZED)
    assert set(QUANTIZED) == {n for n, op in JOPS.items()
                              if op.fn.__module__ ==
                              "mxnet_tpu.ops.quantization"}
    for alias in jregistry._ALIASES:
        assert find_op(alias).name == jfind_op(alias).name, alias
    for name in QUANTIZED:
        with pytest.raises(MXNetError, match="\\(ROADMAP A9"):
            get_op(name)
    with pytest.raises(MXNetError, match="not registered"):
        get_op("NoSuchOp")
    for ns in (tmx.nd.contrib, tmx.sym.contrib):
        with pytest.raises(AttributeError, match="\\(ROADMAP A9"):
            ns.quantize
        with pytest.raises(AttributeError, match="no contrib op"):
            ns.no_such_op
    for ns in (tmx.nd._internal, tmx.sym._internal):
        assert ns._contrib_box_nms is getattr(ns, "_contrib_box_nms")
        with pytest.raises(AttributeError, match="\\(ROADMAP A9"):
            ns._contrib_dequantize
    assert tmx.nd.contrib.ctc_loss is tmx.nd._contrib_ctc_loss
    assert callable(tmx.sym.contrib.ctc_loss)
    assert callable(tmx.nd.image.flip_left_right) and \
        callable(tmx.sym.image.to_tensor)
    assert "box_nms" in dir(tmx.nd.contrib)


def test_a_compat_alias_without_target_raises(monkeypatch):
    monkeypatch.setitem(compat_extra._COMPAT_ALIASES, "_NoSuchAlias",
                        "no_such_target")
    with pytest.raises(MXNetError, match="no target"):
        compat_extra._register_compat_aliases()
