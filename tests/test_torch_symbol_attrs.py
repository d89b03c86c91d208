"""The port's Symbol attribute surface held against ``mxnet_tpu``'s on the
CPU: ``mx.AttrScope`` (nested scopes, the variables an op makes for
itself), ``mx.name.Prefix``, ``Symbol.attr`` / ``attr_dict``,
``get_children``, ``infer_shape_partial`` and ``grad``'s message. Each
graph is built the same way in both packages, and what each call returns
must be equal.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from torch_one_thread import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _graph(mx):
    with mx.AttrScope(ctx_group="dev1", lr_group="2"):
        data = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="dev2"):
            fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    with mx.name.Prefix("net_"):
        act = mx.sym.Activation(fc, act_type="relu")
        out = mx.sym.FullyConnected(act, num_hidden=2)
    return data, fc, act, out


def _summary(mx):
    data, fc, act, out = _graph(mx)
    return {
        "attr": [(s.attr("ctx_group"), s.attr("lr_group"), s.attr("none"))
                 for s in (data, fc, act, out)],
        "names": [s.name for s in (data, fc, act, out)],
        "attr_dict": out.attr_dict(),
        "arguments": out.list_arguments(),
        "children": out.get_children().list_outputs(),
        "fc_children": fc.get_children().list_outputs(),
        "leaf_children": data.get_children(),
        "group_attr": mx.sym.Group([fc, out]).attr("ctx_group"),
        "json_attrs": [n.get("attrs") for n in __import__("json").loads(
            out.tojson())["nodes"]],
    }


def test_attr_scope_prefix_attr_and_children_match_the_reference():
    assert _summary(tmx) == _summary(jmx)
    # the scope closes with the with-block, in the port as in the reference
    assert tmx.sym.Variable("x").attr("ctx_group") is None


@pytest.mark.parametrize("kwargs", [{}, {"data": (4, 5)}, {"data": (4, 0)},
                                    {"fc_weight": (3, 5)}],
                         ids=("nothing", "data", "unknown_dim", "weight"))
def test_infer_shape_partial_matches_the_reference(kwargs):
    got = _graph(tmx)[-1].infer_shape_partial(**kwargs)
    want = _graph(jmx)[-1].infer_shape_partial(**kwargs)
    assert got == want


def test_infer_shape_still_raises_where_partial_does_not():
    sym = _graph(tmx)[-1]
    with pytest.raises(MXNetError, match="cannot infer"):
        sym.infer_shape()
    args, outs, aux = sym.infer_shape(data=(4, 5))
    assert outs == [(4, 2)] and aux == []


def test_grad_raises_the_reference_message():
    msgs = []
    for mx in (jmx, tmx):
        with pytest.raises(mx.base.MXNetError) as err:
            _graph(mx)[-1].grad(["data"])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_scope_attrs_survive_json_and_reach_the_initializer():
    with tmx.AttrScope(__init__='["constant", {"value": 0.5}]'):
        w = tmx.sym.Variable("fc_weight")
    sym = tmx.sym.FullyConnected(tmx.sym.Variable("data"), weight=w,
                                 num_hidden=2, no_bias=True, name="fc")
    again = tmx.sym.load_json(sym.tojson())
    assert again.attr_dict()["fc_weight"]["__init__"] == \
        '["constant", {"value": 0.5}]'
    mod = tmx.mod.Module(again, label_names=None, context=tmx.cpu())
    mod.bind([("data", (1, 3))], for_training=False)
    mod.init_params(tmx.init.Uniform(1.0))
    np.testing.assert_array_equal(mod.get_params()[0]["fc_weight"].asnumpy(),
                                  np.full((2, 3), 0.5, np.float32))
