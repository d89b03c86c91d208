"""The port's elementwise ``mx.nd`` ops held against ``mxnet_tpu``'s on the
CPU (``ops/elemwise.py``: the ``_UNARY``, ``_BINARY`` and ``_SCALAR``
tables, ``identity``, ``BlockGrad``, ``make_loss``, ``softrelu``,
``smooth_l1``, ``clip``, ``Cast`` and ``add_n``), and the op list of the
slice against the reference's.

Each op runs in both packages on the same numpy inputs (a (3, 4) float32
array from a seed, in each op's domain), recorded under
``autograd.record()`` and seeded with one random cotangent
(``torch_nd_parity.check_op``): the output dtype must be the
reference's, and the output and the input gradients agree within
rtol 2e-5 / atol 1e-6 (float32 transcendentals of torch's CPU kernels
against XLA's differ by an ulp or two; ``gamma`` is ``exp(lgamma)`` in
both). Comparisons and logical ops have no gradient in the port (their
output is cast from booleans), so only their values are held.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import OPS as JOPS

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import OPS as TOPS
from torch_nd_parity import check_op, rand
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 2e-5, 1e-6
SHAPE = (3, 4)

#: the reference files of the imperative slice, RNN included, and of
#: the remaining op families (multibox, vision, compat, contrib, the
#: fork's ops, image and linalg)
SLICE_MODULES = ("mxnet_tpu.ops.elemwise", "mxnet_tpu.ops.tensor",
                 "mxnet_tpu.ops.nn", "mxnet_tpu.ops.random_ops",
                 "mxnet_tpu.ops.optimizer_ops", "mxnet_tpu.operator",
                 "mxnet_tpu.ops.multibox", "mxnet_tpu.ops.vision",
                 "mxnet_tpu.ops.compat_extra", "mxnet_tpu.ops.contrib_extra",
                 "mxnet_tpu.ops.fork_ops", "mxnet_tpu.ops.image_ops",
                 "mxnet_tpu.ops.linalg_extra")


def test_the_slice_registers_every_op_of_the_reference_files():
    want = {n for n, op in JOPS.items()
            if op.fn.__module__ in SLICE_MODULES}
    assert len(want) == 260
    assert want <= set(TOPS), sorted(want - set(TOPS))
    for name in sorted(want):
        assert callable(getattr(tmx.nd, name)), name
        assert callable(getattr(tmx.sym, name)), name
        j, t = JOPS[name], TOPS[name]
        assert j.need_rng == t.need_rng and j.need_train == t.need_train, \
            name
        assert sorted(j.param_cls._fields) == sorted(t.param_cls._fields), \
            name
        if not callable(j.input_names):
            assert tuple(j.input_names) == tuple(t.input_names), name


#: op -> input domain (lo, hi)
DOMAINS = {"arccosh": (1.2, 3.0), "arcsin": (-0.9, 0.9),
           "arccos": (-0.9, 0.9), "arctanh": (-0.9, 0.9),
           "log": (0.1, 3.0), "log10": (0.1, 3.0), "log2": (0.1, 3.0),
           "log1p": (-0.5, 3.0), "sqrt": (0.1, 3.0), "rsqrt": (0.1, 3.0),
           "gamma": (0.3, 3.0), "gammaln": (0.3, 3.0),
           "reciprocal": (0.2, 2.0), "cbrt": (0.1, 3.0),
           "rcbrt": (0.1, 3.0), "tan": (-1.2, 1.2)}
UNARY = ["abs", "sign", "negative", "exp", "log", "log10", "log2", "log1p",
         "expm1", "sqrt", "rsqrt", "cbrt", "rcbrt", "square", "reciprocal",
         "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
         "tanh", "arcsinh", "arccosh", "arctanh", "degrees", "radians",
         "floor", "ceil", "round", "rint", "trunc", "fix", "sigmoid",
         "relu", "softsign", "gamma", "gammaln", "erf", "identity",
         "BlockGrad", "make_loss", "softrelu"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_op_matches_the_reference(name):
    lo, hi = DOMAINS.get(name, (-2.0, 2.0))
    x = rand(1, SHAPE, lo, hi)
    check_op(name, [x], grad=(0,), rtol=RTOL, atol=ATOL)


def test_rounding_keeps_the_reference_ties():
    """``round`` halves away from zero and ``rint`` to the floor."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, -0.49999997],
                 np.float32)
    for name in ("round", "rint", "fix"):
        check_op(name, [x], rtol=0, atol=0)


def test_logical_not_matches_the_reference():
    x = np.array([[0.0, 1.5, -2.0, 0.0]], np.float32)
    check_op("logical_not", [x], rtol=0, atol=0)


BINARY = ["elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
          "mod", "power", "maximum", "minimum", "hypot"]
COMPARE = ["equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "logical_and", "logical_or", "logical_xor"]


#: the broadcast forms share their op's body; three of them are held
BROADCAST = ["elemwise_add", "power", "hypot"]


@pytest.mark.parametrize("name,form", [(n, "same") for n in BINARY]
                         + [(n, "broadcast") for n in BROADCAST])
def test_binary_op_matches_the_reference(name, form):
    lo = 0.2 if name == "power" else -2.0
    a = rand(2, SHAPE, lo, 2.0)
    b = rand(3, SHAPE if form == "same" else (1, 4), 0.3, 1.5)
    if name in ("mod", "elemwise_div"):
        b = b * np.where(rand(4, b.shape) > 0, 1, -1).astype(np.float32)
    op = name if form == "same" else "broadcast_" + name.replace(
        "elemwise_", "")
    check_op(op, [a, b], grad=(0, 1), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", COMPARE)
def test_comparison_returns_numbers_of_the_lhs_dtype(name):
    a = np.array([[0.0, 1.0, 2.0, -1.0]], np.float32)
    b = np.array([[0.0, 2.0, 1.0, 0.0]], np.float32)
    check_op(name, [a, b], rtol=0, atol=0)


def test_mod_by_zero_gives_zero_as_the_reference():
    a = np.array([[3.0, -3.0, 2.5, 1.0]], np.float32)
    b = np.array([[0.0, 2.0, 0.0, -0.75]], np.float32)
    to, _ = check_op("mod", [a, b], grad=(0, 1), rtol=0, atol=1e-7)
    assert to[0][0, 0] == 0 and to[0][0, 2] == 0


SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
          "_power_scalar", "_rpower_scalar", "_maximum_scalar",
          "_minimum_scalar", "_equal_scalar", "_not_equal_scalar",
          "_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
          "_lesser_equal_scalar"]


@pytest.mark.parametrize("name", SCALAR)
def test_scalar_op_matches_the_reference(name):
    x = rand(5, SHAPE, 0.2, 2.0)
    x[0, 0] = 1.5    # one exact tie with the scalar
    differentiable = "equal" not in name and "greater" not in name and \
        "lesser" not in name
    check_op(name, [x], {"scalar": 1.5},
             grad=(0,) if differentiable else (), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,attrs", [
    ("smooth_l1", {"scalar": 1.0}), ("smooth_l1", {"scalar": 2.0}),
    ("clip", {"a_min": -0.5, "a_max": 0.7}), ("clip", {"a_max": 0.2}),
])
def test_attr_op_matches_the_reference(name, attrs):
    check_op(name, [rand(6, SHAPE, -2.0, 2.0)], attrs, grad=(0,),
             rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float16", "int32", "float64", "uint8"])
def test_cast_matches_the_reference(dtype):
    x = rand(7, SHAPE, 0.0, 100.0)
    if dtype != "float64":
        check_op("Cast", [x], {"dtype": dtype}, rtol=0, atol=0)
        return
    # the JAX package runs without x64, so its float64 is float32; the
    # port casts to float64, as MXNet does: the same values, widened
    t = tmx.nd.Cast(tmx.nd.array(x, ctx=tmx.cpu()), dtype="float64")
    j = jmx.nd.Cast(jmx.nd.array(x), dtype="float64")
    assert t.dtype == np.float64 and j.dtype == np.float32
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_add_n_matches_the_reference():
    arrays = [rand(8 + i, SHAPE) for i in range(3)]
    check_op("add_n", arrays, grad=(0, 1, 2), rtol=0, atol=0)
    check_op("ElementWiseSum", arrays[:2], grad=(0, 1), rtol=0, atol=0)


def test_integer_inputs_keep_the_reference_dtypes():
    """MXNet's ops do not promote: int32 plus a float scalar, and the
    comparisons of int32 arrays, give the reference's dtypes."""
    i = np.arange(12, dtype=np.int32).reshape(SHAPE)
    check_op("_plus_scalar", [i], {"scalar": 2.0}, rtol=0, atol=0)
    check_op("equal", [i, i], rtol=0, atol=0)
    check_op("negative", [i], rtol=0, atol=0)
