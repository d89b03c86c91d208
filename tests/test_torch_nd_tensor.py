"""The port's tensor ``mx.nd`` ops held against ``mxnet_tpu``'s on the CPU
(``ops/tensor.py``: its 55 registrations), and ``Reshape``'s special
codes.

Each case runs in both packages on the same numpy inputs, recorded under
``autograd.record()`` and seeded with one random cotangent
(``torch_nd_parity.check_op``): the output dtype must be the reference's
(index outputs are float32, or the op's ``dtype``, where torch returns
int64; the reference runs without x64, so its int64 is int32: the port's
``shape_array`` and ``size_array`` are int64, as MXNet's), and outputs
and gradients agree within rtol 1e-5 / atol 1e-6 (sums and products in
another order); shape and index ops are exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.tensor import infer_reshape_shape
from torch_nd_parity import check_op, rand
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6

X = rand(1, (2, 3, 4))
M = rand(2, (3, 4))
SPD = (lambda a: a @ a.T + 3 * np.eye(3, dtype=np.float32))(rand(3, (3, 3)))
IDX = np.array([[0, 2], [1, 3]], np.float32)
SEQ = rand(4, (5, 2, 3))
LENS = np.array([3, 5], np.float32)

#: (id, op, inputs, attrs, differentiated inputs)
CASES = [
    ("reshape_codes", "Reshape", [X], {"shape": (0, -1)}, (0,)),
    ("reshape_m3", "Reshape", [X], {"shape": (-3, -2)}, (0,)),
    ("reshape_m4", "Reshape", [X], {"shape": (-4, 1, 2, -2)}, (0,)),
    ("transpose", "transpose", [X], {"axes": (2, 0, 1)}, (0,)),
    ("swapaxis", "SwapAxis", [X], {"dim1": 0, "dim2": 2}, (0,)),
    ("flatten", "Flatten", [X], {}, (0,)),
    ("expand_dims", "expand_dims", [X], {"axis": 1}, (0,)),
    ("squeeze", "squeeze", [X[:, :1]], {"axis": (1,)}, (0,)),
    ("slice", "slice", [X], {"begin": (0, 1), "end": (2, 3)}, (0,)),
    ("slice_step", "slice", [X], {"begin": (0, 2), "end": (2, 0),
                                  "step": (1, -1)}, (0,)),
    ("slice_axis", "slice_axis", [X], {"axis": 2, "begin": 1, "end": 3},
     (0,)),
    ("slice_like", "slice_like", [X, M[:2, :3]], {"axes": (0, 1)}, (0,)),
    ("concat", "Concat", [X, X * 2], {"dim": 1}, (0, 1)),
    ("stack", "stack", [M, M + 1, M * 3], {"axis": 1}, (0, 1, 2)),
    ("split", "SliceChannel", [X], {"num_outputs": 2, "axis": 2}, (0,)),
    ("split_squeeze", "split", [X], {"num_outputs": 3, "axis": 1,
                                     "squeeze_axis": True}, (0,)),
    ("tile", "tile", [M], {"reps": (2, 1, 2)}, (0,)),
    ("repeat", "repeat", [M], {"repeats": 2, "axis": 1}, (0,)),
    ("reverse", "reverse", [X], {"axis": (0, 2)}, (0,)),
    ("pad_constant", "Pad", [rand(5, (1, 2, 3, 3))],
     {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
      "constant_value": 0.5}, (0,)),
    ("pad_reflect", "Pad", [rand(5, (1, 2, 3, 3))],
     {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}, (0,)),
    ("broadcast_to", "broadcast_to", [M[:1]], {"shape": (3, 0)}, (0,)),
    ("broadcast_like", "broadcast_like", [M[:1], M], {}, (0,)),
    ("shape_array", "shape_array", [X], {}, ()),
    ("size_array", "size_array", [X], {}, ()),
    ("zeros_like", "zeros_like", [X], {}, ()),
    ("ones_like", "ones_like", [X], {}, ()),
    ("sum", "sum", [X], {"axis": (1,)}, (0,)),
    ("sum_exclude", "sum", [X], {"axis": (1,), "exclude": True,
                                 "keepdims": True}, (0,)),
    ("mean", "mean", [X], {"axis": (0, 2), "keepdims": True}, (0,)),
    ("prod", "prod", [X], {"axis": (2,)}, (0,)),
    ("max", "max", [X], {"axis": (1,)}, (0,)),
    ("min", "min", [X], {}, (0,)),
    ("nansum", "nansum", [np.where(X > 0.5, np.nan, X).astype(np.float32)],
     {"axis": (1,)}, ()),
    ("nanprod", "nanprod", [np.where(X > 0.5, np.nan, X).astype(np.float32)],
     {"axis": (2,)}, ()),
    ("square_sum", "_square_sum", [X], {"axis": (1,)}, (0,)),
    ("norm", "norm", [X], {}, (0,)),
    ("norm_l1_axis", "norm", [X], {"ord": 1, "axis": (2,)}, (0,)),
    ("argmax", "argmax", [X], {"axis": 1}, ()),
    ("argmin", "argmin", [X], {"axis": 2, "keepdims": True}, ()),
    ("argmax_channel", "argmax_channel", [M], {}, ()),
    ("dot", "dot", [M, rand(6, (4, 5))], {}, (0, 1)),
    ("dot_t", "dot", [M, rand(6, (5, 4))], {"transpose_b": True}, (0, 1)),
    ("dot_3d", "dot", [X, rand(7, (4, 2))], {}, (0, 1)),
    ("batch_dot", "batch_dot", [X, rand(8, (2, 3, 4))],
     {"transpose_b": True}, (0, 1)),
    ("gemm2", "linalg_gemm2", [M, rand(6, (4, 5))], {}, (0, 1)),
    ("potrf", "linalg_potrf", [SPD], {}, (0,)),
    ("syrk", "linalg_syrk", [M], {"alpha": 0.5}, (0,)),
    ("take", "take", [M, IDX], {}, (0,)),
    ("take_wrap", "take", [M, IDX + 2], {"mode": "wrap", "axis": 1}, (0,)),
    ("pick", "pick", [M, np.array([0, 3, 1], np.float32)], {"axis": 1},
     (0,)),
    ("one_hot", "one_hot", [np.array([0, 2, 1, 5], np.float32)],
     {"depth": 4, "on_value": 2.0, "off_value": -1.0}, ()),
    ("where", "where", [(M > 0).astype(np.float32), M, M * 3], {}, (1, 2)),
    ("gather_nd", "gather_nd", [M, np.array([[0, 2], [1, 3]], np.float32)],
     {}, (0,)),
    ("scatter_nd", "scatter_nd", [np.array([1.0, 2.0, 3.0], np.float32),
                                  np.array([[0, 1, 0], [1, 2, 1]],
                                           np.float32)],
     {"shape": (2, 3)}, (0,)),
    ("topk_idx", "topk", [M], {"k": 2}, ()),
    ("topk_value", "topk", [M], {"k": 2, "ret_typ": "value",
                                 "axis": 0}, (0,)),
    ("topk_both", "topk", [M], {"k": 3, "ret_typ": "both",
                                "is_ascend": True}, (0,)),
    ("topk_mask", "topk", [M], {"k": 2, "ret_typ": "mask"}, ()),
    ("sort", "sort", [M], {}, (0,)),
    ("argsort", "argsort", [M], {"is_ascend": False}, ()),
    ("argsort_int", "argsort", [M], {"dtype": "int32"}, ()),
    ("seq_mask", "SequenceMask", [SEQ, LENS],
     {"use_sequence_length": True, "value": -1.0}, (0,)),
    ("seq_last", "SequenceLast", [SEQ, LENS],
     {"use_sequence_length": True}, (0,)),
    ("seq_reverse", "SequenceReverse", [SEQ, LENS],
     {"use_sequence_length": True}, (0,)),
]


@pytest.mark.parametrize("name,inputs,attrs,grad",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_tensor_op_matches_the_reference(name, inputs, attrs, grad):
    check_op(name, inputs, attrs, grad=grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,attrs", [
    ("_zeros", {"shape": (2, 3)}), ("_ones", {"shape": (4,),
                                              "dtype": "int32"}),
    ("_full", {"shape": (2, 2), "value": 3.5}),
    ("_arange", {"start": 2.0, "stop": 11.0, "step": 3.0, "repeat": 2}),
    ("_arange", {"start": 5.0}),
])
def test_init_op_matches_the_reference(name, attrs):
    check_op(name, [], attrs, rtol=0, atol=0)


def test_reshape_codes_are_the_reference_codes():
    for spec, shape, want in (((0, -1), (2, 3, 4), (2, 12)),
                              ((-2,), (2, 3), (2, 3)),
                              ((-3, 0), (2, 3, 4), (6, 4)),
                              ((-4, -1, 2, 0), (6, 5), (3, 2, 5)),
                              ((0, 0, -1), (2, 3, 4), (2, 3, 4))):
        assert infer_reshape_shape(spec, shape) == want
    # the NDArray method takes the codes too
    a = tmx.nd.array(X, ctx=tmx.cpu())
    assert a.reshape((-3, -2)).shape == (6, 4)
    assert a.reshape(0, -1).shape == (2, 12)
