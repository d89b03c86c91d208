"""The port's image and extended linalg ops held against ``mxnet_tpu``'s
on the CPU (``mxnet_tpu_torch/ops/image_ops.py``, ``linalg_extra.py``).

- Image (channels last, [0, 255], float32 and uint8): the flips, PCA
  lighting and each random enhancement at a fixed draw (``min_factor ==
  max_factor``: the deterministic op, the hue round trip RGB -> HLS -> RGB
  included) through the reference op (one jitted program for the file)
  and the port's ``mx.nd`` op, within rtol 1e-5 / atol 1e-4 on the
  [0, 255] scale (uint8 outputs equal but where a value sits on a
  rounding half: at most one level, at most 1% of them). The random
  ops proper: reproducible from a seed, in range, a flip either flips or
  not, and a zero strength or spread is the identity.
- Linalg, batched over a leading dim: gemm (transposes, alpha, beta,
  ``axis``), trmm and trsm (both sides, transposed, upper), potri,
  sumlogdiag, extractdiag and makediag (offsets), outputs and gradients
  within rtol 1e-5 / atol 1e-5. gelqf and syevd against the reference
  up to each row's sign, and by reconstruction (``L Q = A``, ``U^T
  diag(l) U = A``, orthonormal rows) within 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_op_parity import case, check, rand, reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HWC = rand(0, (5, 6, 3), 0.0, 255.0)
NHWC = rand(1, (2, 4, 5, 3), 0.0, 255.0)
U8 = np.random.RandomState(2).randint(0, 256, (4, 5, 3)).astype(np.uint8)
IMG_TOL = {"rtol": 1e-5, "atol": 1e-4}


def _fixed(name, factor):
    return {"min_factor": factor, "max_factor": factor}


IMAGE_CASES = [
    case("flip_lr", "_image_flip_left_right", [HWC], grad=(0,)),
    case("flip_tb_batch", "_image_flip_top_bottom", [NHWC], grad=(0,)),
    case("flip_lr_u8", "_image_flip_left_right", [U8]),
    case("brightness", "_image_random_brightness", [HWC],
         _fixed("b", 1.3), grad=(0,), **IMG_TOL),
    case("contrast_batch", "_image_random_contrast", [NHWC],
         _fixed("c", 0.6), grad=(0,), **IMG_TOL),
    case("saturation", "_image_random_saturation", [HWC],
         _fixed("s", 1.4), grad=(0,), **IMG_TOL),
    case("hue", "_image_random_hue", [NHWC], _fixed("h", 0.1), **IMG_TOL),
    case("hue_negative", "_image_random_hue", [HWC], _fixed("h", -0.3),
         **IMG_TOL),
    case("lighting", "_image_adjust_lighting", [NHWC],
         {"alpha": (0.1, -0.2, 0.05)}, grad=(0,), **IMG_TOL),
    case("lighting_zero_std", "_image_random_lighting", [HWC],
         {"alpha_std": 0.0}, **IMG_TOL),
    case("color_jitter_zero", "_image_random_color_jitter", [HWC],
         {"brightness": 0.0, "contrast": 0.0, "saturation": 0.0,
          "hue": 0.0}),
]
#: uint8 cases: rounding a value that sits on a half may differ by one
U8_CASES = [
    case("brightness_u8", "_image_random_brightness", [U8],
         _fixed("b", 1.7)),
    case("hue_u8", "_image_random_hue", [U8], _fixed("h", 0.2)),
    case("lighting_u8", "_image_adjust_lighting", [U8],
         {"alpha": (0.3, 0.1, -0.2)}),
]


def _tri(seed, n=4, lower=True):
    a = rand(seed, (2, n, n), -0.5, 0.5) + 2.0 * np.eye(n, dtype=np.float32)
    return np.tril(a) if lower else np.triu(a)


def _spd(seed, n=4):
    a = rand(seed, (2, n, n))
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


L = np.linalg.cholesky(_spd(3)).astype(np.float32)
LIN_TOL = {"rtol": 1e-5, "atol": 1e-5}
LINALG_CASES = [
    case("gemm", "linalg_gemm", [rand(4, (2, 3, 4)), rand(5, (2, 4, 5)),
                                 rand(6, (2, 3, 5))],
         {"alpha": 0.7, "beta": -1.5}, grad=(0, 1, 2), **LIN_TOL),
    case("gemm_transposed_axis", "linalg_gemm",
         [rand(7, (4, 2, 3)), rand(8, (5, 2, 4)), rand(9, (3, 2, 5))],
         {"transpose_a": True, "transpose_b": True, "axis": -3},
         grad=(0, 1, 2), **LIN_TOL),
    case("trmm", "linalg_trmm", [_tri(10), rand(11, (2, 4, 3))],
         {"alpha": 2.0}, grad=(0, 1), **LIN_TOL),
    case("trmm_right_upper_t", "linalg_trmm",
         [_tri(12, lower=False), rand(13, (2, 3, 4))],
         {"rightside": True, "lower": False, "transpose": True},
         grad=(0, 1), **LIN_TOL),
    case("trsm", "linalg_trsm", [_tri(14), rand(15, (2, 4, 3))],
         {"alpha": 0.5}, grad=(0, 1), **LIN_TOL),
    case("trsm_right_t", "linalg_trsm", [_tri(16), rand(17, (2, 3, 4))],
         {"rightside": True, "transpose": True}, grad=(0, 1), **LIN_TOL),
    case("trsm_upper", "linalg_trsm", [_tri(18, lower=False),
                                       rand(19, (2, 4, 2))],
         {"lower": False}, grad=(0, 1), **LIN_TOL),
    case("potri", "linalg_potri", [L], grad=(0,), **LIN_TOL),
    case("sumlogdiag", "linalg_sumlogdiag", [_spd(20)], grad=(0,),
         **LIN_TOL),
    case("extractdiag", "linalg_extractdiag", [rand(21, (2, 4, 4))],
         {"offset": 1}, grad=(0,), **LIN_TOL),
    case("makediag", "linalg_makediag", [rand(22, (2, 3))],
         {"offset": -2}, grad=(0,), **LIN_TOL),
    case("gelqf", "linalg_gelqf", [rand(23, (2, 3, 5))]),
    case("syevd", "linalg_syevd", [_spd(24)]),
]
ALL = IMAGE_CASES + U8_CASES + LINALG_CASES
BY_ID = {c.id: c for c in ALL}
SIGNED = ("gelqf", "syevd")


@pytest.fixture(scope="module")
def want():
    return reference(ALL)


@pytest.mark.parametrize("cid", [c.id for c in IMAGE_CASES + LINALG_CASES
                                 if c.id not in SIGNED])
def test_op_matches_the_reference(want, cid):
    check(BY_ID[cid], want[cid])


@pytest.mark.parametrize("cid", [c.id for c in U8_CASES])
def test_uint8_op_matches_the_reference_to_a_level(want, cid):
    from torch_op_parity import port
    got = port(BY_ID[cid], None)[0][0].astype(np.int16)
    ref = want[cid][0][0].astype(np.int16)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, diff.max()


@pytest.mark.parametrize("cid", SIGNED)
def test_factorisations_match_up_to_sign_and_reconstruct(want, cid):
    from torch_op_parity import port
    a = BY_ID[cid].arrays[0].astype(np.float64)
    (first, second), _ = port(BY_ID[cid], None)
    j_first, j_second = want[cid][0]
    if cid == "gelqf":      # (Q, L): rows of Q, columns of L
        signs = np.sign(np.sum(first * j_first, axis=-1, keepdims=True))
        np.testing.assert_allclose(first * signs, j_first, **LIN_TOL)
        np.testing.assert_allclose(second * np.swapaxes(signs, -1, -2),
                                   j_second, **LIN_TOL)
        np.testing.assert_allclose(second @ first, a, **LIN_TOL)
        eye = np.broadcast_to(np.eye(first.shape[-2]), (2, 3, 3))
    else:                   # (U, l): rows of U
        np.testing.assert_allclose(second, j_second, **LIN_TOL)
        signs = np.sign(np.sum(first * j_first, axis=-1, keepdims=True))
        np.testing.assert_allclose(first * signs, j_first, **LIN_TOL)
        recon = np.swapaxes(first, -1, -2) @ (second[..., None] * first)
        np.testing.assert_allclose(recon, a, rtol=1e-5, atol=1e-4)
        eye = np.broadcast_to(np.eye(4), (2, 4, 4))
    np.testing.assert_allclose(first @ np.swapaxes(first, -1, -2), eye,
                               atol=1e-5)


def _draw(op, data, seed, **attrs):
    tmx.random.seed(seed)
    return getattr(tmx.nd, op)(tmx.nd.array(data, ctx=tmx.cpu(),
                                            dtype=data.dtype),
                               **attrs).asnumpy()


@pytest.mark.parametrize("op,attrs", [
    ("_image_random_brightness", {"min_factor": 0.5, "max_factor": 1.5}),
    ("_image_random_contrast", {"min_factor": 0.5, "max_factor": 1.5}),
    ("_image_random_saturation", {"min_factor": 0.5, "max_factor": 1.5}),
    ("_image_random_hue", {"min_factor": -0.4, "max_factor": 0.4}),
    ("_image_random_color_jitter", {"brightness": 0.3, "contrast": 0.3,
                                    "saturation": 0.3, "hue": 0.2}),
    ("_image_random_lighting", {"alpha_std": 0.3}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_random_image_ops_reproduce_and_stay_in_range(op, attrs):
    a, b = _draw(op, U8, 4, **attrs), _draw(op, U8, 4, **attrs)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.uint8 and a.shape == U8.shape
    outs = {_draw(op, U8, s, **attrs).tobytes() for s in range(5, 9)}
    assert len(outs) > 1, "the draw never moved the output"
    f = _draw(op, HWC, 4, **attrs)
    assert f.dtype == np.float32 and np.isfinite(f).all()


@pytest.mark.parametrize("op,axis", [("_image_random_flip_left_right", 1),
                                     ("_image_random_flip_top_bottom", 0)])
def test_random_flips_flip_or_keep(op, axis):
    seen = set()
    for seed in range(12):
        out = _draw(op, HWC, seed)
        if np.array_equal(out, HWC):
            seen.add("kept")
        else:
            np.testing.assert_array_equal(out, np.flip(HWC, axis))
            seen.add("flipped")
    assert seen == {"kept", "flipped"}
    np.testing.assert_array_equal(_draw(op, HWC, 3), _draw(op, HWC, 3))
