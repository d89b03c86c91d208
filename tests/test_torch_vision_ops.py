"""The port's vision ops held against ``mxnet_tpu``'s on the CPU:
``ROIPooling``, ``Crop``, ``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``Correlation``, ``_contrib_BilinearResize2D``,
``_contrib_AdaptiveAvgPooling2D``, ``_contrib_box_iou`` and
``_contrib_box_nms`` (``mxnet_tpu_torch/ops/vision.py``), and
``Pooling`` over 4 spatial dims (``ops/nn.py``), and the contrib
detection ops ``DeformableConvolution``, ``ROIAlign``,
``DeformablePSROIPooling``, ``Proposal``, ``MultiProposal``,
``count_sketch`` and ``khatri_rao`` (``ops/contrib_extra.py``).

Each case runs through the reference op (one jitted program for the
file) and the port's ``mx.nd`` op on the same seeded numpy inputs; the
outputs, and where the reference is differentiable the gradients of the
first output for one seeded cotangent (``jax.vjp`` against torch's
autograd), agree within rtol 1e-5 / atol 1e-6 (the adaptive pool's
integral image, a difference of running sums, within atol 1e-5).
``box_nms``'s output (the kept rows, all -1 where suppressed) must be
equal. ROI coordinates sit on halves after scaling, so ROIPooling's
round-half-away-from-zero is held.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_op_parity import case, check, rand, reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMG = rand(0, (2, 3, 8, 9))
# (batch, x1, y1, x2, y2): x 2.5 and 5.5 at scale 1 round away from 0
ROIS = np.array([[0, 2.5, 1.0, 5.5, 6.0], [1, 0.0, 0.0, 8.0, 7.0],
                 [1, 3.0, 3.5, 3.0, 3.5], [0, -1.5, 2.0, 4.0, 9.5]],
                np.float32)
THETA = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.1],
                  [1.2, -0.2, 0.0, 0.3, 0.8, 0.2]], np.float32)
FLOW = rand(1, (2, 2, 8, 9), -1.5, 1.5)
GRID = rand(2, (2, 2, 5, 6), -1.1, 1.1)


def _boxes(seed, n, k=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 0.6, (2, n, 2))
    wh = rng.uniform(0.1, 0.4, (2, n, 2))
    d = np.zeros((2, n, k), np.float32)
    d[..., 0] = rng.randint(0, 3, (2, n))               # class id
    d[..., 1] = np.round(rng.uniform(0, 1, (2, n)), 1)  # scores with ties
    d[..., 2:4] = xy
    d[..., 4:6] = xy + wh
    return d


DETS = _boxes(3, 24)
CENTER = DETS.copy()
CENTER[..., 4:6] -= CENTER[..., 2:4]                    # (x, y, w, h)
CENTER[..., 2:4] += CENTER[..., 4:6] / 2

CASES = [
    case("roi_pooling", "ROIPooling", [IMG, ROIS],
         {"pooled_size": (2, 3), "spatial_scale": 1.0}, grad=(0,)),
    case("roi_pooling_scaled", "ROIPooling", [IMG, ROIS],
         {"pooled_size": (3, 3), "spatial_scale": 0.5}, grad=(0,)),
    case("crop_hw_offset", "Crop", [IMG], {"h_w": (4, 5),
                                           "offset": (1, 2)}, grad=(0,)),
    case("crop_like_center", "Crop", [IMG, rand(3, (2, 3, 5, 4))],
         {"num_args": 2, "center_crop": True}, grad=(0,)),
    case("grid_affine", "GridGenerator", [THETA],
         {"transform_type": "affine", "target_shape": (5, 7)}, grad=(0,)),
    case("grid_warp", "GridGenerator", [FLOW], {"transform_type": "warp"},
         grad=(0,)),
    case("bilinear_sampler", "BilinearSampler", [IMG, GRID], grad=(0, 1)),
    case("spatial_transformer", "SpatialTransformer", [IMG, THETA],
         {"transform_type": "affine", "sampler_type": "bilinear",
          "target_shape": (6, 5)}, grad=(0, 1)),
    case("correlation", "Correlation", [IMG, rand(4, IMG.shape)],
         {"max_displacement": 2, "pad_size": 2}, grad=(0, 1)),
    case("correlation_k3_strided_abs", "Correlation",
         [IMG, rand(5, IMG.shape)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "stride1": 2, "pad_size": 1, "is_multiply": False}, grad=(0, 1)),
    case("bilinear_resize", "_contrib_BilinearResize2D", [IMG],
         {"height": 5, "width": 13}, grad=(0,)),
    case("adaptive_avg_pool", "_contrib_AdaptiveAvgPooling2D", [IMG],
         {"output_size": (3, 4)}, grad=(0,), atol=1e-5),
    case("box_iou", "_contrib_box_iou", [DETS[0, :7, 2:6],
                                         DETS[1, :5, 2:6]], grad=(0, 1)),
    case("box_iou_center", "_contrib_box_iou",
         [CENTER[0, :6, 2:6], CENTER[1, :4, 2:6]], {"format": "center"},
         grad=(0, 1)),
    case("box_nms", "_contrib_box_nms", [DETS], {"overlap_thresh": 0.3},
         exact=(0,)),
    case("box_nms_by_class_topk", "_contrib_box_nms", [DETS],
         {"overlap_thresh": 0.2, "id_index": 0, "topk": 10,
          "valid_thresh": 0.15}, exact=(0,)),
    case("box_nms_force_center_to_corner", "_contrib_box_nms", [CENTER],
         {"overlap_thresh": 0.25, "id_index": 0, "force_suppress": True,
          "in_format": "center", "out_format": "corner"}, exact=(0,)),
    case("box_nms_corner_to_center", "_contrib_box_nms", [DETS],
         {"overlap_thresh": 0.25, "out_format": "center"}, exact=(0,)),
    case("pooling_4d_max_full", "Pooling", [rand(6, (1, 2, 3, 4, 5, 4))],
         {"kernel": (2, 2, 2, 2), "stride": (1, 2, 2, 1),
          "pooling_convention": "full"}, grad=(0,)),
    case("pooling_4d_avg_pad", "Pooling", [rand(7, (2, 1, 4, 3, 4, 5))],
         {"kernel": (2, 3, 2, 2), "stride": (2, 1, 2, 2),
          "pad": (1, 1, 0, 1), "pool_type": "avg"}, grad=(0,)),
    case("pooling_4d_sum", "Pooling", [rand(8, (1, 2, 3, 3, 3, 3))],
         {"kernel": (2, 2, 2, 2), "pool_type": "sum"}, grad=(0,)),
]


def _rpn(seed, n, a=6, h=5, w=6):
    """RPN inputs: fg/bg scores (n, 2a, h, w), deltas (n, 4a, h, w), and
    each image's (height, width, scale)."""
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 1, (n, 2 * a, h, w)).astype(np.float32),
            rng.uniform(-0.2, 0.2, (n, 4 * a, h, w)).astype(np.float32),
            np.array([[h * 16.0, w * 16.0, 1.0], [h * 16.0 - 8, w * 16.0,
                                                  0.8]][:n], np.float32)]


RPN = {"scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0),
       "rpn_pre_nms_top_n": 60, "rpn_post_nms_top_n": 12,
       "threshold": 0.6, "rpn_min_size": 4}
PS_FEAT = rand(20, (2, 8, 8, 9))
CASES += [
    case("deformable_convolution", "_contrib_DeformableConvolution",
         [rand(21, (2, 4, 6, 7)), rand(22, (2, 18, 6, 7), -0.8, 0.8),
          rand(23, (6, 4, 3, 3)), rand(24, (6,))],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6},
         grad=(0, 1, 2, 3)),
    case("deformable_convolution_groups_strided",
         "_contrib_DeformableConvolution",
         [rand(25, (1, 4, 7, 7)), rand(26, (1, 36, 3, 3), -1.5, 1.5),
          rand(27, (4, 2, 3, 3))],
         {"kernel": (3, 3), "stride": (2, 2), "dilate": (2, 2),
          "pad": (1, 1), "num_filter": 4, "num_group": 2,
          "num_deformable_group": 2, "no_bias": True}, grad=(0, 1, 2)),
    case("roi_align", "_contrib_ROIAlign", [IMG, ROIS],
         {"pooled_size": (2, 3), "spatial_scale": 0.5, "sample_ratio": 2},
         grad=(0,)),
    case("deformable_psroi_pooling", "_contrib_DeformablePSROIPooling",
         [PS_FEAT, ROIS, rand(28, (4, 2, 2, 2))],
         {"spatial_scale": 0.5, "output_dim": 2, "group_size": 2,
          "pooled_size": 2, "part_size": 2, "sample_per_part": 2,
          "trans_std": 0.1}, grad=(0, 2)),
    case("deformable_psroi_pooling_no_trans",
         "_contrib_DeformablePSROIPooling", [PS_FEAT, ROIS],
         {"spatial_scale": 0.5, "output_dim": 2, "group_size": 2,
          "pooled_size": 2, "no_trans": True}, grad=(0,)),
    case("proposal", "_contrib_Proposal", _rpn(29, 1),
         dict(RPN, output_score=True), rtol=1e-5, atol=1e-4),
    case("multi_proposal", "_contrib_MultiProposal", _rpn(30, 2), RPN,
         rtol=1e-5, atol=1e-4),
    case("count_sketch", "_contrib_count_sketch",
         [rand(31, (4, 10)), np.array([[0, 3, 1, 4, 3, 0, 2, 2, 4, 1]],
                                      np.float32),
          np.array([[1, -1, 1, 1, -1, -1, 1, -1, 1, 1]], np.float32)],
         {"out_dim": 5}, grad=(0,)),
    case("khatri_rao", "khatri_rao", [rand(32, (3, 4)), rand(33, (2, 4)),
                                      rand(34, (5, 4))], grad=(0, 1, 2)),
]
BY_ID = {c.id: c for c in CASES}


@pytest.fixture(scope="module")
def want():
    return reference(CASES)


@pytest.mark.parametrize("cid", [c.id for c in CASES])
def test_vision_op_matches_the_reference(want, cid):
    check(BY_ID[cid], want[cid])


def test_box_nms_suppresses_and_the_rois_round_away(want):
    """The NMS cases suppress rows, and the ROI at x 2.5 pools the columns
    from 3 on (round half away from zero), which round-half-even (2) would
    not."""
    for cid in ("box_nms", "box_nms_by_class_topk"):
        rows = want[cid][0][0]
        assert (rows[..., 1] == -1).any() and (rows[..., 1] >= 0).any()
    x = np.zeros((1, 1, 2, 8), np.float32)
    x[0, 0, :, 2] = 5.0
    roi = np.array([[0, 2.5, 0.0, 5.5, 1.0]], np.float32)
    got = tmx.nd.ROIPooling(tmx.nd.array(x, ctx=tmx.cpu()),
                            tmx.nd.array(roi, ctx=tmx.cpu()),
                            pooled_size=(1, 1), spatial_scale=1.0)
    assert got.asnumpy().item() == 0.0


def test_pooling_5d_and_v1_alias_in_a_symbol():
    sym = tmx.sym.Pooling_v1(tmx.sym.Variable("x"), kernel=(1, 1, 2, 2),
                             pool_type="max")
    assert sym.infer_shape(x=(1, 1, 2, 2, 4, 4))[1] == [(1, 1, 2, 2, 3, 3)]
