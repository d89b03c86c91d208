"""The port's runtime user kernels (``mxnet_tpu_torch.rtc``) held against
the JAX package's (``mxnet_tpu.rtc``) on the CPU.

- The slice as a whole: ResNet-8 (``get_symbol(10, 8, "3,28,28")``, batch
  2) in both packages, the same numpy weights and moving statistics, its
  symbol JSON rewritten so that every ``Activation`` node runs a user op
  (7 nodes), ``load_json`` -> ``simple_bind(grad_req="null")`` ->
  ``forward(is_train=False)``. The JAX side registers a Pallas relu with
  ``register_pallas_op`` (interpret mode); the port registers the CUDA C
  ``user_relu`` kernel with ``register_cuda_op``, which on CPU tensors
  runs its plain version ``torch.clamp_min(x, 0)``. Each rewritten graph
  equals its own built-in graph bit for bit; the two packages agree within
  the symbolic tests' 2e-4 relative / 2e-4 absolute (torch's convolutions
  against XLA's, another order of summation).
- The Triton analog's plain route against the JAX test's Pallas
  ``double`` (``tests/python/unittest/test_aux_subsystems.py``): exact.
- ``get_kernel``'s signature parser (MXNet's rule and C types), and shape
  inference of user ops on ``meta`` tensors through ``load_json`` and
  ``infer_shape``.

This host has no CUDA, so ``CudaModule`` is compiled by a stand-in for
NVRTC (``_stand_in_module``): the module holds no machine code, and the
ops can run only their plain versions on CPU tensors. The kernels
themselves run on the card in ``chip_smoke.py`` (phases ``rtc_kernel``
and ``rtc_infer``). Every test registers ops under names of its own: the
registries are global and refuse a name twice.
"""
import itertools
import json

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jres

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, rtc
from mxnet_tpu_torch.kernels import _rtc_driver
from mxnet_tpu_torch.models import resnet as tres
from mxnet_tpu_torch.ops import find_op

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = ATOL = 2e-4
CPU = tmx.cpu()
SHAPES = {"data": (2, 3, 28, 28), "softmax_label": (2,)}

#: The user op of the full-width path (chip_smoke.py's source).
USER_RELU = r"""
extern "C" __global__ void user_relu(const float *x, float *y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    y[i] = x[i] > 0.0f ? x[i] : 0.0f;
}
"""
RELU_SIG = "const float *x, float *y, int64_t n"

_ids = itertools.count()


def _unique(base):
    return "%s_t%d" % (base, next(_ids))


def _stand_in_module(monkeypatch, source, **kwargs):
    """A ``CudaModule`` compiled by a stand-in for NVRTC, which returns no
    machine code and lowers each name expression to ``lowered<i>``."""
    def compile_program(src, options, exports):
        return b"", {e: "lowered%d" % i for i, e in enumerate(exports)}, ""

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(_rtc_driver, "driver", lambda: None)
        m.setattr(_rtc_driver, "compile_program", compile_program)
        return rtc.CudaModule(source, **kwargs)


def _register_port_relu(monkeypatch, name):
    kernel = _stand_in_module(monkeypatch, USER_RELU).get_kernel(
        "user_relu", RELU_SIG)
    rtc.register_cuda_op(
        name, kernel, lambda x: torch.empty_like(x),
        lambda x: ((min(-(-x.numel() // 256), 65536), 1, 1), (256, 1, 1)),
        scalars=lambda x: (x.numel(),),
        plain_fn=lambda x: torch.clamp_min(x, 0))
    return kernel


def _register_jax_relu(name):
    def relu_kernel(x_ref, o_ref):
        o_ref[...] = jax.numpy.maximum(x_ref[...], 0.0)

    jmx.rtc.register_pallas_op(
        name, relu_kernel, lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)


def _rewrite(sym, op):
    """``sym``'s JSON with every Activation(relu) node's op set to ``op``;
    returns (the JSON, the number of nodes rewritten)."""
    graph = json.loads(sym.tojson())
    n = 0
    for node in graph["nodes"]:
        if node["op"] == "Activation" and \
                node.get("attrs", {}).get("act_type") == "relu":
            node["op"] = op
            n += 1
    return json.dumps(graph), n


def _resnet8_values(sym, seed=0):
    """Seeded numpy weights (He-normal), BN affine and moving statistics,
    and a batch, keyed by the graph's argument and aux names."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**SHAPES)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            v = rng.uniform(-1, 1, shape)
        elif name == "softmax_label":
            v = rng.randint(0, 10, shape)
        elif name.endswith("_gamma"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name.endswith("_beta") or name.endswith("_bias"):
            v = rng.normal(0, 0.1, shape)
        else:
            v = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        args[name] = v.astype(np.float32)
    aux = {}
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        v = (rng.normal(0, 0.1, shape) if name.endswith("_mean")
             else rng.uniform(0.5, 1.5, shape))
        aux[name] = v.astype(np.float32)
    return args, aux


def _infer(sym, ctx, args, aux):
    exe = sym.simple_bind(ctx, grad_req="null", **SHAPES)
    for k, v in args.items():
        exe.arg_dict[k][:] = v
    for k, v in aux.items():
        exe.aux_dict[k][:] = v
    return exe.forward(is_train=False)[0].asnumpy()


def test_resnet8_user_op_graph_matches_jax(monkeypatch):
    name = _unique("user_relu")
    _register_jax_relu(name)
    kernel = _register_port_relu(monkeypatch, name)
    with jmx.name.NameManager():
        jsym = jres.get_symbol(10, 8, "3,28,28")
    with tmx.name.NameManager():
        tsym = tres.get_symbol(10, 8, "3,28,28")
    assert tsym.tojson() == jsym.tojson()
    args, aux = _resnet8_values(tsym)

    jjson, n_j = _rewrite(jsym, name)
    tjson, n_t = _rewrite(tsym, name)
    assert n_j == n_t == 7 and jjson == tjson
    j_user = jmx.sym.load_json(jjson)
    t_user = tmx.sym.load_json(tjson)
    assert t_user.list_arguments() == tsym.list_arguments()

    activation = find_op("Activation")
    act_calls = []
    real_fn = activation.fn

    def counting(params, x):
        if x.device.type != "meta":    # shape inference runs every op
            act_calls.append(1)
        return real_fn(params, x)

    monkeypatch.setattr(activation, "fn", counting)
    j_builtin = _infer(jsym, jmx.cpu(), args, aux)
    j_rewritten = _infer(j_user, jmx.cpu(), args, aux)
    t_builtin = _infer(tsym, CPU, args, aux)
    assert len(act_calls) == 7
    t_rewritten = _infer(t_user, CPU, args, aux)
    assert len(act_calls) == 7, "Activation ran in the rewritten graph"
    assert kernel.launches == 0

    assert t_builtin.shape == (2, 10) and np.isfinite(t_builtin).all()
    np.testing.assert_array_equal(j_rewritten, j_builtin)
    np.testing.assert_array_equal(t_rewritten, t_builtin)
    np.testing.assert_allclose(t_rewritten, j_rewritten, RTOL, ATOL)


def test_triton_double_plain_route_matches_jax():
    def double_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    jmod = jmx.rtc.PallasModule()
    jk = jmod.add_kernel("double", double_kernel,
                         lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         interpret=True)

    def triton_double(x_ptr, out_ptr, n, BLOCK):
        raise AssertionError("the kernel runs only on the card")

    tmod = rtc.TritonModule()
    tk = tmod.add_kernel("double", triton_double,
                         lambda x: torch.empty_like(x),
                         plain_fn=lambda x: x * 2.0)
    assert tmod.get_kernel("double") is tk
    x = np.random.RandomState(3).normal(size=(2, 4, 33)).astype(np.float32)
    want = jk.launch([jmx.nd.array(x)]).asnumpy()
    got = tk.launch([tmx.nd.array(x, ctx=CPU)], (3,), BLOCK=1024)
    assert isinstance(got, tmx.nd.NDArray) and got.context.type == "cpu"
    np.testing.assert_array_equal(got.asnumpy(), want)
    assert tk.launches == 0
    with pytest.raises(MXNetError, match="no kernel"):
        tmod.get_kernel("triple")


def test_triton_op_registers_and_infers():
    name = _unique("tdouble")
    nd_fn = rtc.register_triton_op(
        name, lambda *a: None, lambda x: torch.empty_like(x),
        grid=lambda x: (x.numel() // 1024 + 1,),
        kwargs=lambda x: {"n": x.numel(), "BLOCK": 1024},
        plain_fn=lambda x: x * 2.0)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(nd_fn(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                                  x * 2)
    assert find_op(name).infer(find_op(name).make_params({}), [(5, 7)]) \
        == [(5, 7)]
    assert nd_fn.kernel.launches == 0


_C_TYPES = [("float", torch.float32), ("double", torch.float64),
            ("__half", torch.float16), ("uint8_t", torch.uint8),
            ("int", torch.int32), ("int32_t", torch.int32),
            ("int8_t", torch.int8), ("char", torch.int8),
            ("int64_t", torch.int64)]


@pytest.mark.parametrize("ctype,dtype", _C_TYPES)
def test_signature_parser_types(ctype, dtype):
    args = rtc.parse_signature(
        "const %s *x,%s  *  y , %s alpha, const %s beta" % ((ctype,) * 4))
    assert [(a.is_const, a.ctype, a.is_pointer, a.name) for a in args] == [
        (True, ctype, True, "x"), (False, ctype, True, "y"),
        (False, ctype, False, "alpha"), (True, ctype, False, "beta")]
    assert rtc.C_TYPES[ctype][0] == dtype
    # a name is optional, as in MXNet's rule
    assert rtc.parse_signature("%s*" % ctype)[0].is_pointer


@pytest.mark.parametrize("signature", [
    "float x y", "const *x", "float **x", "const", "", "float *x,",
    "float x[]", "float (*x)", "unsigned int n"])
def test_signature_parser_refuses_malformed(signature):
    with pytest.raises(ValueError, match="Invalid function prototype"):
        rtc.parse_signature(signature)


@pytest.mark.parametrize("signature", [
    "half *x", "unsigned *n", "float4 *x", "const float *x, size_t n",
    "__nv_bfloat16 *x"])
def test_signature_parser_refuses_unknown_types(signature):
    with pytest.raises(TypeError, match="Unsupported kernel argument type"):
        rtc.parse_signature(signature)


def test_get_kernel_uses_lowered_names(monkeypatch):
    mod = _stand_in_module(monkeypatch, "/* saxpy */",
                           options="--fmad=false",
                           exports=["saxpy<float>", "saxpy<double>"])
    k = mod.get_kernel("saxpy<double>", "const double *x, double *y, "
                                         "double a, int n")
    assert (k.name, k.lowered_name) == ("saxpy<double>", "lowered1")
    assert mod.get_kernel("axpy", "const float *x").lowered_name == "axpy"


def test_user_op_infers_shapes_on_meta(monkeypatch):
    """A user op whose output differs in shape from its input (row sums
    of two inputs): ``infer_shape`` on the loaded graph runs it on
    ``meta`` tensors, which launches nothing."""
    name = _unique("rowsum2")
    src = "/* two inputs, one output of one value per row */"
    kernel = _stand_in_module(monkeypatch, src).get_kernel(
        "rowsum2", "const float *a, const float *b, float *out, int rows, "
        "int cols")
    rtc.register_cuda_op(
        name, kernel, lambda a, b: torch.empty(a.shape[0], device=a.device),
        lambda a, b: ((1, 1, 1), (128, 1, 1)),
        scalars=lambda a, b: a.shape, plain_fn=lambda a, b: (a + b).sum(1),
        input_names=("lhs", "rhs"))
    graph = {"nodes": [{"op": "null", "name": "x", "inputs": []},
                       {"op": "null", "name": "y", "inputs": []},
                       {"op": name, "name": "s",
                        "inputs": [[0, 0, 0], [1, 0, 0]]}],
             "heads": [[2, 0, 0]]}
    sym = tmx.sym.load_json(json.dumps(graph))
    assert sym.list_arguments() == ["x", "y"]
    assert sym.infer_shape(x=(4, 6), y=(4, 6))[1] == [(4,)]
    op = find_op(name)
    assert op.list_inputs() == ["lhs", "rhs"] and op.n_outputs() == 1
    meta = torch.empty(3, 5, device="meta")
    assert op.apply(op.make_params({}), [meta, meta])[0].device.type == "meta"
    a = np.ones((3, 5), np.float32)
    exe = sym.simple_bind(CPU, grad_req="null", x=(3, 5), y=(3, 5))
    out = exe.forward(x=a, y=2 * a)[0].asnumpy()
    np.testing.assert_array_equal(out, np.full(3, 15.0, np.float32))
    assert kernel.launches == 0


def test_user_op_outputs_are_inferred_once_per_signature():
    """A user kernel's outputs are allocated from ``out_shape_fn``'s
    result on ``meta`` tensors, computed once per input shapes and
    dtypes."""
    calls = []

    def out_shape_fn(a, b):
        calls.append((tuple(a.shape), a.device.type))
        return torch.empty(a.shape[0], b.shape[1], dtype=torch.float64,
                           device=a.device), torch.empty_like(b)

    alloc = rtc._Outputs("pair", out_shape_fn, 2)
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    for _ in range(3):
        outs = alloc([a, b], torch.device("cpu"))
    assert [(tuple(o.shape), o.dtype, o.device.type) for o in outs] == [
        ((3, 5), torch.float64, "cpu"), ((4, 5), torch.float32, "cpu")]
    alloc([torch.ones(6, 4), b], torch.device("cpu"))
    assert calls == [((3, 4), "meta"), ((6, 4), "meta")]
    with pytest.raises(MXNetError, match="must return 1 tensor"):
        rtc._Outputs("bad", out_shape_fn, 1)([a, b], torch.device("cpu"))
