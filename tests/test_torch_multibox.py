"""The port's SSD multibox ops held against ``mxnet_tpu``'s on the CPU:
``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection``
(``mxnet_tpu_torch/ops/multibox.py``).

Every case goes through the reference op (one jitted program for the
file, ``torch_op_parity.reference``) and the port's ``mx.nd`` op on the
same seeded numpy inputs. Index outputs (``box_mask``, ``cls_target``,
the detection ids) must be equal; anchors, regression targets, scores
and boxes agree within rtol 1e-5 / atol 1e-6.

The inputs hold the cases the ops' loops and sorts must get right: a
sample whose label rows are all padding, two ground truths on one box
(an IoU tie across columns), two anchors on one box (a tie across rows),
a ground truth on an anchor (IoU 1), all-zero class scores (every
hard-negative score equal), uniform class probabilities (every
detection score equal), ``force_suppress``, ``nms_topk`` and NMS
switched off. The executor gives the two gradient-free ops' inputs a
zero gradient.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_op_parity import case, check, rand, reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, C, N = 3, 4, 80


def _anchors():
    rng = np.random.RandomState(1)
    xy = rng.uniform(0.0, 0.7, (N, 2))
    wh = rng.uniform(0.1, 0.4, (N, 2))
    a = np.concatenate([xy, np.minimum(xy + wh, 1.0)], axis=1)
    a[20] = a[10]                       # two anchors on one box
    return a.astype(np.float32)[None]


ANCHORS = _anchors()


def _labels():
    lab = np.full((B, 4, 5), -1.0, np.float32)
    lab[0, 0] = [1, 0.1, 0.1, 0.5, 0.6]
    lab[0, 1] = [0] + list(ANCHORS[0, 3])        # on an anchor: IoU 1
    lab[1, 0] = [2, 0.2, 0.3, 0.6, 0.7]
    lab[1, 1] = [2, 0.2, 0.3, 0.6, 0.7]          # the same box twice
    lab[1, 2] = [0] + list(ANCHORS[0, 10])       # on the twin anchors
    lab[1, 3] = [1, 0.5, 0.0, 0.9, 0.4]
    return lab                                   # sample 2: all padding


LABELS = _labels()
CLS_PRED = rand(2, (B, C, N), -2.0, 2.0)
ZEROS = np.zeros((B, C, N), np.float32)


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


CLS_PROB = _softmax(rand(3, (B, C, N), -3.0, 3.0))
UNIFORM = np.full((B, C, N), 0.25, np.float32)
LOC = rand(4, (B, N * 4), -0.5, 0.5)

MINING = {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5}
CASES = [
    case("prior", "MultiBoxPrior", [np.zeros((1, 3, 4, 5), np.float32)],
         {"sizes": (0.3, 0.6), "ratios": (1.0, 2.0, 0.5)}),
    case("prior_clip_steps", "MultiBoxPrior",
         [np.zeros((2, 3, 5, 3), np.float32)],
         {"sizes": (0.5, 0.9), "ratios": (1.0, 3.0), "clip": True,
          "steps": (0.2, 0.3), "offsets": (0.25, 0.75)}),
    case("target", "MultiBoxTarget", [ANCHORS, LABELS, CLS_PRED],
         exact=(1, 2)),
    case("target_mining", "MultiBoxTarget", [ANCHORS, LABELS, CLS_PRED],
         MINING, exact=(1, 2)),
    case("target_min_negatives", "MultiBoxTarget",
         [ANCHORS, LABELS, CLS_PRED],
         dict(MINING, minimum_negative_samples=10, ignore_label=-2.0),
         exact=(1, 2)),
    case("target_zero_scores", "MultiBoxTarget", [ANCHORS, LABELS, ZEROS],
         MINING, exact=(1, 2)),
    case("target_overlap_variances", "MultiBoxTarget",
         [ANCHORS, LABELS, CLS_PRED],
         {"overlap_threshold": 0.3, "variances": (0.2, 0.2, 0.1, 0.1)},
         exact=(1, 2)),
    case("detection", "MultiBoxDetection", [CLS_PROB, LOC, ANCHORS]),
    case("detection_force_suppress", "MultiBoxDetection",
         [CLS_PROB, LOC, ANCHORS], {"force_suppress": True,
                                    "nms_threshold": 0.3}),
    case("detection_topk", "MultiBoxDetection", [CLS_PROB, LOC, ANCHORS],
         {"nms_topk": 20, "threshold": 0.2}),
    case("detection_nms_off", "MultiBoxDetection", [CLS_PROB, LOC, ANCHORS],
         {"nms_threshold": 0.0}),
    case("detection_nms_above_one", "MultiBoxDetection",
         [CLS_PROB, LOC, ANCHORS], {"nms_threshold": 1.5}),
    case("detection_equal_scores", "MultiBoxDetection",
         [UNIFORM, LOC, ANCHORS], {"nms_threshold": 0.4}),
    case("detection_background_1", "MultiBoxDetection",
         [CLS_PROB, LOC, ANCHORS], {"background_id": 1, "clip": False}),
]
BY_ID = {c.id: c for c in CASES}


@pytest.fixture(scope="module")
def want():
    return reference(CASES)


@pytest.mark.parametrize("cid", [c.id for c in CASES])
def test_multibox_op_matches_the_reference(want, cid):
    got = check(BY_ID[cid], want[cid])
    if BY_ID[cid].op == "MultiBoxDetection":
        # the class ids (suppressed and sub-threshold rows -1) are equal
        np.testing.assert_array_equal(got[0][..., 0], want[cid][0][0][..., 0])


def test_the_cases_reach_what_they_hold(want):
    """The inputs exercise the matches, the mining and the NMS: positives
    in every sample with objects, none in the padding-only sample,
    ignored anchors under mining, suppressed detections under NMS."""
    cls_t = want["target_mining"][0][2]
    assert (cls_t[0] > 0).any() and (cls_t[1] > 0).any()
    assert not (cls_t[2] > 0).any()
    assert (cls_t == -1).any() and (cls_t == 0).any()
    # the twin ground truths: one claims an anchor in stage 1 (its first
    # column wins the tie), the other its own best anchor
    assert (want["target"][0][2][1] == 3).sum() >= 2
    kept = (want["detection"][0][0][..., 0] >= 0).sum()
    off = (want["detection_nms_off"][0][0][..., 0] >= 0).sum()
    assert 0 < kept < off
    # equal scores keep their index order
    ids = want["detection_equal_scores"][0][0]
    np.testing.assert_array_equal(ids[..., 1], np.full((B, N), 0.25,
                                                       np.float32))


def test_target_and_detection_give_zero_gradients():
    """In a bound graph, inputs of the two ops that ask for a gradient
    get zeros (the reference's backward writes zeros)."""
    anchor, label, pred = (tmx.sym.Variable(n) for n in ("anchor", "label",
                                                         "cls_pred"))
    tgt = tmx.sym.contrib.MultiBoxTarget(anchor, label, pred, **MINING)
    det = tmx.sym.contrib.MultiBoxDetection(
        tmx.sym.softmax(pred, axis=1), tmx.sym.Variable("loc"), anchor)
    sym = tmx.sym.Group([tmx.sym.MakeLoss(tgt[0]), tmx.sym.MakeLoss(det)])
    exe = sym.simple_bind(tmx.cpu(), anchor=ANCHORS.shape,
                          label=LABELS.shape, cls_pred=CLS_PRED.shape,
                          loc=LOC.shape)
    for name, value in (("anchor", ANCHORS), ("label", LABELS),
                        ("cls_pred", CLS_PRED), ("loc", LOC)):
        exe.arg_dict[name][:] = value
        exe.grad_dict[name][:] = 1.0
    exe.forward(is_train=True)
    exe.backward()
    for name in ("anchor", "cls_pred", "loc"):
        assert not exe.grad_dict[name].asnumpy().any(), name


def test_contrib_namespace_and_aliases_resolve():
    x = tmx.nd.array(np.zeros((1, 3, 4, 5), np.float32), ctx=tmx.cpu())
    base = tmx.nd.contrib.MultiBoxPrior(x, sizes=(0.3,)).asnumpy()
    for fn in (tmx.nd.MultiBoxPrior, tmx.nd._contrib_MultiBoxPrior,
               tmx.nd._internal._contrib_MultiBoxPrior):
        np.testing.assert_array_equal(fn(x, sizes=(0.3,)).asnumpy(), base)
    assert base.shape == (1, 20, 4)
    sym = tmx.sym.contrib.MultiBoxPrior(tmx.sym.Variable("x"), sizes=(0.3,))
    assert sym.infer_shape(x=(1, 3, 4, 5))[1] == [(1, 20, 4)]
