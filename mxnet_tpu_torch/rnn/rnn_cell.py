"""Symbolic RNN cells of the port (reference: ``mxnet_tpu/rnn/rnn_cell.py``).

Cells build ``mx.sym`` graphs step by step from ops the port already has
(``FullyConnected``, ``SliceChannel``, ``Activation``, ``Convolution``,
...); ``unroll`` expands them over time, one graph a sequence length,
which is how ``BucketingModule`` users build their buckets.
``FusedRNNCell`` rides the ``RNN`` op (cuDNN on the card) with the
reference's packed parameter layout; ``unpack_weights`` /
``pack_weights`` move between that blob and per-cell weights, and
``unfuse`` builds the same network from explicit cells.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError

sym = None  # set lazily to avoid import cycle


def _s():
    global sym
    if sym is None:
        from .. import sym as s
        sym = s
    return sym


def _host(arr):
    """An NDArray or array-like as numpy."""
    return arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)


def _nd(values, like):
    """``values`` as an NDArray on ``like``'s device (the CPU unless
    ``like`` is an NDArray)."""
    from ..context import cpu
    from ..ndarray.ndarray import NDArray, array
    return array(values, ctx=like.context if isinstance(like, NDArray)
                 else cpu())


class RNNParams(object):
    """Container tying weight Variables to a shared prefix
    (reference: rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = _s().Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """reference: rnn_cell.py BaseRNNCell."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Default zero states; shapes use 0 = batch placeholder
        (reference: rnn_cell.py begin_state with sym.zeros)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if func is None:
                state = _s().zeros(shape=info["shape"],
                                   name="%sbegin_state_%d" % (
                                       self._prefix, self._init_counter))
            else:
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                        self._init_counter),
                             **info, **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def __call__(self, inputs, states):
        raise NotImplementedError()

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """reference: rnn_cell.py unroll."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(
                func=_zeros_like_state(inputs[0]))
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states


def _zeros_like_state(first_input):
    """Build batch-matched zero states from the first input symbol: shape-0
    axes of state_info inherit the batch dim via broadcast_to. Reduces ALL
    non-batch axes so the state's spatial dims are free to differ from the
    input's (strided conv cells)."""
    def func(name=None, shape=None, **kwargs):
        s = _s()
        z = s.sum(first_input, axis=0, exclude=True, keepdims=False) * 0
        z = s.Reshape(z, shape=(-1,) + (1,) * (len(shape) - 1))
        return s.broadcast_to(z, shape=shape)
    return func


def _normalize_sequence(length, inputs, layout, merge):
    """list<->merged conversion (reference: rnn_cell.py _normalize_sequence)."""
    s = _s()
    axis = layout.find("T")
    if not isinstance(inputs, (list, tuple)):
        if merge is False:
            inputs = list(s.SliceChannel(inputs, axis=axis,
                                         num_outputs=length,
                                         squeeze_axis=1))
    else:
        inputs = list(inputs)
        if merge is True:
            inputs = [s.expand_dims(i, axis=axis) for i in inputs]
            inputs = s.Concat(*inputs, dim=axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (tanh/relu)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        s = _s()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = s.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                               num_hidden=self._num_hidden,
                               name="%si2h" % name)
        h2h = s.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                               num_hidden=self._num_hidden,
                               name="%sh2h" % name)
        output = s.Activation(i2h + h2h, act_type=self._activation,
                              name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        self._iW = self.params.get("i2h_weight")
        # forget_bias is an initializer concern (reference rnn_cell.py
        # attaches init.LSTMBias(forget_bias) to i2h_bias); runtime math
        # stays untouched so fused/unfused numerics agree.
        from ..initializer import LSTMBias
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        s = _s()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = s.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                               num_hidden=self._num_hidden * 4,
                               name="%si2h" % name)
        h2h = s.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                               num_hidden=self._num_hidden * 4,
                               name="%sh2h" % name)
        gates = i2h + h2h
        slices = list(s.SliceChannel(gates, num_outputs=4, axis=1,
                                     name="%sslice" % name))
        in_gate = s.Activation(slices[0], act_type="sigmoid")
        # forget_bias is an *initializer* concern in the reference (the
        # LSTMBias init writes it into i2h_bias, rnn_cell.py LSTMCell) —
        # nothing is added at runtime, keeping fused/unfused numerics equal
        forget_gate = s.Activation(slices[1], act_type="sigmoid")
        in_trans = s.Activation(slices[2], act_type="tanh")
        out_gate = s.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * s.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        s = _s()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = s.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                               num_hidden=self._num_hidden * 3,
                               name="%si2h" % name)
        h2h = s.FullyConnected(prev_h, weight=self._hW, bias=self._hB,
                               num_hidden=self._num_hidden * 3,
                               name="%sh2h" % name)
        i2h_r, i2h_z, i2h_o = list(s.SliceChannel(i2h, num_outputs=3, axis=1))
        h2h_r, h2h_z, h2h_o = list(s.SliceChannel(h2h, num_outputs=3, axis=1))
        reset = s.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = s.Activation(i2h_z + h2h_z, act_type="sigmoid")
        trans = s.Activation(i2h_o + reset * h2h_o, act_type="tanh")
        # h' = (1-z)*candidate + z*prev — matches the reference rnn_cell.py
        # GRUCell and this repo's fused RNN op (ops/nn.py), so fused/unfused
        # weights stay interchangeable.
        next_h = trans + update * (prev_h - trans)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Rides the fused ``RNN`` op (reference: rnn_cell.py FusedRNNCell over
    src/operator/rnn-inl.h; here cuDNN's RNN on the card, ops/nn.py)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._param = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell cannot be stepped; use unroll")

    def _slice_weights(self, arr):
        """Split the packed blob into per-layer/direction arrays matching the
        fused RNN op layout (ops/nn.py rnn_param_size: weights layer-major
        direction-minor i2h-then-h2h, then biases in the same order)."""
        from ..ops.nn import rnn_param_size
        g = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[self._mode]
        H = self._num_hidden
        L = self._num_layers
        d = 2 if self._bidirectional else 1
        total = arr.size
        # solve input_size from the total packed count
        rest = total - L * d * 2 * g * H \
            - (L - 1) * d * g * H * (H * d + H) - d * g * H * H
        input_size = rest // (d * g * H)
        assert rnn_param_size(self._mode, input_size, H, L,
                              self._bidirectional) == total, \
            "cannot infer input size from packed RNN parameters"
        names = []
        for layer in range(L):
            for dd in range(d):
                p = "%s%s%d_" % (self._prefix, "lr"[dd] if d == 2 else "l",
                                 layer)
                names.append(p)
        out = {}
        off = 0
        for layer in range(L):
            ins = input_size if layer == 0 else H * d
            for dd in range(d):
                p = names[layer * d + dd]
                out[p + "i2h_weight"] = arr[off:off + g * H * ins].reshape(
                    (g * H, ins)); off += g * H * ins
                out[p + "h2h_weight"] = arr[off:off + g * H * H].reshape(
                    (g * H, H)); off += g * H * H
        for layer in range(L):
            for dd in range(d):
                p = names[layer * d + dd]
                out[p + "i2h_bias"] = arr[off:off + g * H]; off += g * H
                out[p + "h2h_bias"] = arr[off:off + g * H]; off += g * H
        return out, names

    def unpack_weights(self, args):
        """Fused blob -> per-cell weights, on the blob's device (the CPU for
        numpy) (reference: FusedRNNCell.unpack_weights)."""
        args = dict(args)
        key = self._prefix + "parameters"
        if key not in args:
            return args
        blob = args.pop(key)
        pieces, _ = self._slice_weights(_host(blob))
        for name, val in pieces.items():
            args[name] = _nd(val, blob)
        return args

    def pack_weights(self, args):
        """Per-cell weights -> fused blob (reference: FusedRNNCell.pack_weights)."""
        args = dict(args)
        probe = "%sl0_i2h_weight" % self._prefix
        if probe not in args:
            return args
        like = args[probe]
        H = self._num_hidden
        L = self._num_layers
        d = 2 if self._bidirectional else 1
        names = []
        for layer in range(L):
            for dd in range(d):
                names.append("%s%s%d_" % (self._prefix,
                                          "lr"[dd] if d == 2 else "l", layer))
        chunks = []
        for p in names:
            for suffix in ("i2h_weight", "h2h_weight"):
                chunks.append(_host(args.pop(p + suffix)).reshape(-1))
        for p in names:
            for suffix in ("i2h_bias", "h2h_bias"):
                chunks.append(_host(args.pop(p + suffix)).reshape(-1))
        args[self._prefix + "parameters"] = _nd(_np.concatenate(chunks),
                                                like)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        s = _s()
        inputs, _ = _normalize_sequence(length, inputs, layout, True)
        if layout == "NTC":
            inputs = s.SwapAxis(inputs, dim1=0, dim2=1)  # -> TNC
        if begin_state is None:
            def func(name=None, shape=None, **kwargs):
                base = s.sum(inputs, axis=(0, 2), keepdims=True) * 0  # [1,N,1]
                return s.broadcast_to(base, shape=shape)
            states = []
            for info in self.state_info:
                self._init_counter += 1
                states.append(func(shape=info["shape"]))
        else:
            states = list(begin_state)
        if self._mode == "lstm":
            rnn = s.RNN(inputs, self._param, states[0], states[1],
                        state_size=self._num_hidden,
                        num_layers=self._num_layers,
                        bidirectional=self._bidirectional, p=self._dropout,
                        state_outputs=self._get_next_state,
                        mode=self._mode, name="%srnn" % self._prefix)
        else:
            rnn = s.RNN(inputs, self._param, states[0],
                        state_size=self._num_hidden,
                        num_layers=self._num_layers,
                        bidirectional=self._bidirectional, p=self._dropout,
                        state_outputs=self._get_next_state,
                        mode=self._mode, name="%srnn" % self._prefix)
        if self._get_next_state:
            outputs = rnn[0]
            states = list(rnn[1:])
        else:
            outputs = rnn if not isinstance(rnn, (list, tuple)) else rnn[0]
            states = []
        if layout == "NTC":
            outputs = s.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(s.SliceChannel(outputs, axis=layout.find("T"),
                                          num_outputs=length,
                                          squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """Explicit-cell equivalent (reference: FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
            "lstm": lambda p: LSTMCell(self._num_hidden, p),
            "gru": lambda p: GRUCell(self._num_hidden, p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        return self

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = (begin_state[p:p + n] if begin_state is not None
                      else None)
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, **kwargs):
        return (self._l_cell.begin_state(**kwargs)
                + self._r_cell.begin_state(**kwargs))

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        s = _s()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(
                func=_zeros_like_state(inputs[0]))
        n_l = len(self._l_cell.state_info)
        l_outputs, l_states = self._l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = self._r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [s.Concat(l_o, r_o, dim=1,
                            name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference: ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = _s().Dropout(inputs, p=self.dropout)
        return inputs, states


class ResidualCell(ModifierCell):
    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference: rnn_cell.py ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        s = _s()
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return s.Dropout(s.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else next_output * 0
        output = (s.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([s.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, new_states


class BaseConvRNNCell(BaseRNNCell):
    """Symbolic convolutional recurrent base (reference: rnn_cell.py:1094).

    Gates are 2D convolutions over NCHW feature maps; h2h convs use
    'same' padding (odd kernels, dilation-aware) so states keep their
    spatial shape across steps.
    """

    def __init__(self, input_shape, num_hidden, h2h_kernel, h2h_dilate,
                 i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                 activation, prefix="", params=None, conv_layout="NCHW",
                 i2h_bias_init=None):
        super().__init__(prefix=prefix, params=params)
        if conv_layout != "NCHW":
            raise MXNetError("conv cells support conv_layout='NCHW' only")
        self._input_shape = tuple(input_shape)  # (C, H, W)
        self._num_hidden = num_hidden
        self._h2h_kernel = tuple(h2h_kernel)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise MXNetError("h2h_kernel must be odd (shape-preserving)")
        self._h2h_dilate = tuple(h2h_dilate)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        self._i2h_kernel = tuple(i2h_kernel)
        self._i2h_stride = tuple(i2h_stride)
        self._i2h_pad = tuple(i2h_pad)
        self._i2h_dilate = tuple(i2h_dilate)
        self._activation = activation
        C, H, W = self._input_shape
        oh = (H + 2 * self._i2h_pad[0]
              - self._i2h_dilate[0] * (self._i2h_kernel[0] - 1) - 1) \
            // self._i2h_stride[0] + 1
        ow = (W + 2 * self._i2h_pad[1]
              - self._i2h_dilate[1] * (self._i2h_kernel[1] - 1) - 1) \
            // self._i2h_stride[1] + 1
        self._state_shape = (num_hidden, oh, ow)
        self._iW = self.params.get("i2h_weight")
        # init must attach on FIRST get (RNNParams.get ignores kwargs for
        # an existing name), so subclasses pass it through the constructor
        self._iB = self.params.get("i2h_bias", init=i2h_bias_init) \
            if i2h_bias_init is not None else self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def _num_gates(self):
        return len(self._gate_names)

    @property
    def state_info(self):
        return [{"shape": (0,) + self._state_shape, "__layout__": "NCHW"}]

    def _conv_gates(self, inputs, states, name):
        s = _s()
        ng = self._num_gates
        i2h = s.Convolution(inputs, weight=self._iW, bias=self._iB,
                            kernel=self._i2h_kernel,
                            stride=self._i2h_stride, pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            num_filter=ng * self._num_hidden,
                            name="%si2h" % name)
        h2h = s.Convolution(states[0], weight=self._hW, bias=self._hB,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            num_filter=ng * self._num_hidden,
                            name="%sh2h" % name)
        return i2h, h2h

    def _act(self, x, name=None):
        s = _s()
        if self._activation == "leaky":
            return s.LeakyReLU(x, act_type="leaky")
        return s.Activation(x, act_type=self._activation)


class ConvRNNCell(BaseConvRNNCell):
    """reference: rnn_cell.py:1176 ConvRNNCell."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="ConvRNN_", params=None, conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         activation, prefix=prefix, params=params,
                         conv_layout=conv_layout)

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_gates(inputs, states, name)
        output = self._act(i2h + h2h)
        return output, [output]


class ConvLSTMCell(BaseConvRNNCell):
    """reference: rnn_cell.py:1253 ConvLSTMCell (Shi et al. 2015)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="leaky",
                 prefix="ConvLSTM_", params=None, conv_layout="NCHW",
                 forget_bias=1.0):
        from ..initializer import LSTMBias
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         activation, prefix=prefix, params=params,
                         conv_layout=conv_layout,
                         i2h_bias_init=LSTMBias(forget_bias=forget_bias))

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    @property
    def state_info(self):
        return [{"shape": (0,) + self._state_shape, "__layout__": "NCHW"},
                {"shape": (0,) + self._state_shape, "__layout__": "NCHW"}]

    def __call__(self, inputs, states):
        s = _s()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_gates(inputs, states, name)
        gates = i2h + h2h
        slices = list(s.SliceChannel(gates, num_outputs=4, axis=1,
                                     name="%sslice" % name))
        in_gate = s.Activation(slices[0], act_type="sigmoid")
        forget_gate = s.Activation(slices[1], act_type="sigmoid")
        in_trans = self._act(slices[2])
        out_gate = s.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * self._act(next_c)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """reference: rnn_cell.py:1348 ConvGRUCell."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="leaky",
                 prefix="ConvGRU_", params=None, conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         activation, prefix=prefix, params=params,
                         conv_layout=conv_layout)

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        s = _s()
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_gates(inputs, states, name)
        i2h_s = list(s.SliceChannel(i2h, num_outputs=3, axis=1,
                                    name="%si2h_slice" % name))
        h2h_s = list(s.SliceChannel(h2h, num_outputs=3, axis=1,
                                    name="%sh2h_slice" % name))
        reset_gate = s.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update_gate = s.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        next_h_tmp = self._act(i2h_s[2] + reset_gate * h2h_s[2])
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]
