"""Recurrent layers (counterpart of paddle_tpu/nn/layers/rnn.py): the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell`` over ``RNNCellBase``, the
wrappers ``RNN`` (a cell over time) and ``BiRNN``, and the stacks
``SimpleRNN``, ``LSTM`` and ``GRU``.

The time loop. The JAX package runs it as one ``lax.scan``; the port runs
one route on every device: the input projection of all steps as one
product over ``[T·N, I]`` (bias ``b_ih`` included), then a Python loop over
time of the step math (``_simple_step``, ``_lstm_step``, ``_gru_step``),
whose backward is autograd's through the loop. There is no cuDNN route:
cuDNN zeroes the outputs past a sequence's length, where the reference
emits them raw. Sequence-length masking is the reference's ``_maybe_copy``:
each state keeps its value past its sequence's end (``m * new + (1 - m) *
old``), the outputs are emitted as computed, and a reverse pass walks the
same mask backwards. A user-defined cell, or a built-in one called with
extra keyword arguments, runs the eager loop of its ``forward`` a step.

Weights are ``[gates·H, in]`` and ``[gates·H, H]`` in both packages (not a
Linear's transpose), gates ``i, f, g, o`` (LSTM) and ``r, z, c`` (GRU,
whose reset gate multiplies the hidden product, bias included), drawn from
U(-1/sqrt(H), 1/sqrt(H)) unless a ``ParamAttr`` says otherwise.

AMP: the loop looks itself up as the JAX op ``"rnn_scan"`` and a cell's
single step as ``"rnn_cell_step"`` (``amp.cast_inputs``). Neither is on an
AMP list, so under O1 the recurrence runs in its inputs' dtype and under
O2 in the low dtype; the products inside are plain torch calls, not the
port's white-listed ``linear``. The stacks' zero initial states are f32.

``BiRNN`` runs its cells through two ``RNN`` wrappers kept outside the
module tree, so ``state_dict()`` names each weight once, as the JAX layer
does (``cell_fw.*``, ``cell_bw.*``). Dropout between a stack's layers draws
from its ``generator`` attribute (torch's default generator when None).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...amp import cast_inputs
from ...core import dtype as dtypes
from ...ops import nn_functional as F
from ..layer import Layer
from .common import init_uniform_, make_param, place
from .container import LayerList


# ---------------------------------------------------------------- step math
# step(xw, states, w_hh, b_hh) -> (output, new states); xw = x W_ih^T + b_ih
def _simple_step(act):
    actfn = torch.tanh if act == "tanh" else torch.relu

    def step(xw, states, w_hh, b_hh):
        nh = actfn(xw + TF.linear(states[0], w_hh, b_hh))
        return nh, (nh,)

    return step


def _lstm_step(xw, states, w_hh, b_hh):
    h, c = states
    i, f, g, o = (xw + TF.linear(h, w_hh, b_hh)).chunk(4, -1)
    nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    nh = torch.sigmoid(o) * torch.tanh(nc)
    return nh, (nh, nc)


def _gru_step(xw, states, w_hh, b_hh):
    (h,) = states
    x_r, x_z, x_c = xw.chunk(3, -1)
    h_r, h_z, h_c = TF.linear(h, w_hh, b_hh).chunk(3, -1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    c = torch.tanh(x_c + r * h_c)   # the reset gate after the hidden product
    nh = (h - c) * z + c
    return nh, (nh,)


def _loop_rnn(step, inputs, states, params, sequence_length=None, is_reverse=False,
              time_major=False):
    """The whole sequence: (outputs, final states)."""
    n = len(states)
    inputs, *rest = cast_inputs("rnn_scan", inputs, *states, *params)
    states, (w_ih, w_hh, b_ih, b_hh) = tuple(rest[:n]), rest[n:]
    xs = inputs if time_major else inputs.transpose(0, 1)     # [T, N, I]
    T = xs.shape[0]
    xw = TF.linear(xs, w_ih, b_ih)          # every step's input projection, one product
    mask = None
    if sequence_length is not None:
        mask = (torch.arange(T, device=xs.device)[:, None]
                < sequence_length.to(xs.device)[None, :]).to(xs.dtype)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        out, new = step(xw[t], states, w_hh, b_hh)
        if mask is not None:
            m = mask[t][:, None]
            new = tuple(m * a + (1 - m) * s for a, s in zip(new, states))
        outs[t] = out
        states = new
    outputs = torch.stack(outs, 0)
    return (outputs if time_major else outputs.transpose(0, 1)), states


def _single_step(step, inputs, states, params):
    """One cell step (the cell's own ``forward``): (output, new states)."""
    n = len(states)
    inputs, *rest = cast_inputs("rnn_cell_step", inputs, *states, *params)
    states, (w_ih, w_hh, b_ih, b_hh) = tuple(rest[:n]), rest[n:]
    return step(TF.linear(inputs, w_ih, b_ih), states, w_hh, b_hh)


# ---------------------------------------------------------------- cells
class RNNCellBase(Layer):
    """Base of the single-step cells (reference rnn.py:RNNCellBase)."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None, init_value=0.0,
                           batch_dim_idx=0):
        """``init_value``-filled states of ``state_shape`` (nested for the
        LSTM's (h, c)) for ``batch_ref``'s batch, on its device."""
        batch = batch_ref.shape[batch_dim_idx]
        dtype = dtypes.convert_dtype(dtype or "float32")

        def build(s):
            if isinstance(s, (tuple, list)) and s and isinstance(s[0], (tuple, list)):
                return tuple(build(e) for e in s)
            dims = [batch] + [int(d) for d in (s if isinstance(s, (tuple, list)) else [s])]
            return torch.full(dims, init_value, dtype=dtype, device=batch_ref.device)

        return build(shape or self.state_shape)


class _Cell(RNNCellBase):
    """The built-in cells' weights, initialization and single step."""

    def _make_params(self, gates, weight_ih_attr, weight_hh_attr, bias_ih_attr,
                     bias_hh_attr, device):
        rows = gates * self.hidden_size
        self.weight_ih = make_param((rows, self.input_size), weight_ih_attr)
        self.weight_hh = make_param((rows, self.hidden_size), weight_hh_attr)
        self.bias_ih = make_param((rows,), bias_ih_attr)
        self.bias_hh = make_param((rows,), bias_hh_attr)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        std = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            init_uniform_(p, -std, std, generator)

    def _param_list(self):
        return [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh]

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        nested = isinstance(self.state_shape[0], (tuple, list))
        out, new = _single_step(self._step_fn(), inputs,
                                tuple(states) if nested else (states,), self._param_list())
        return out, (new if nested else new[0])

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation for SimpleRNNCell should be tanh or relu")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._make_params(1, weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr,
                          device)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _step_fn(self):
        return _simple_step(self.activation)


class LSTMCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_params(4, weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr,
                          device)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def _step_fn(self):
        return _lstm_step


class GRUCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_params(3, weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr,
                          device)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _step_fn(self):
        return _gru_step


# ---------------------------------------------------------------- wrappers
class RNN(Layer):
    """A cell over time (reference rnn.py:RNN): ``forward(inputs,
    initial_states=None, sequence_length=None, **kwargs)`` -> (outputs,
    final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        if not hasattr(cell, "forward"):
            raise ValueError("RNN needs a cell with a forward method")
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None, **kwargs):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        if isinstance(self.cell, _Cell) and not kwargs:
            nested = isinstance(self.cell, LSTMCell)
            outputs, final = _loop_rnn(
                self.cell._step_fn(), inputs,
                tuple(initial_states) if nested else (initial_states,),
                self.cell._param_list(), sequence_length, self.is_reverse, self.time_major)
            return outputs, (final if nested else final[0])
        return self._eager_loop(inputs, initial_states, sequence_length, **kwargs)

    def _eager_loop(self, inputs, states, sequence_length=None, **kwargs):
        """A user-defined cell: its ``forward`` a step, states held past
        each sequence's length."""
        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        mask = None
        if sequence_length is not None:
            mask = F.sequence_mask(sequence_length, maxlen=T, dtype="float32")
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if self.is_reverse else range(T)):
            out, new_states = self.cell(inputs[:, t] if time_axis == 1 else inputs[t],
                                        states, **kwargs)
            if mask is not None:
                m = mask[:, t].unsqueeze(-1)
                seq = isinstance(new_states, (tuple, list))
                flat_new = new_states if seq else [new_states]
                flat_old = states if isinstance(states, (tuple, list)) else [states]
                blended = [m * a + (1.0 - m) * s for a, s in zip(flat_new, flat_old)]
                new_states = type(new_states)(blended) if seq else blended[0]
            outs[t] = out
            states = new_states
        return torch.stack(outs, time_axis), states


class BiRNN(Layer):
    """A forward and a backward cell over the same input, outputs
    concatenated (reference rnn.py:BiRNN)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major
        # outside the module tree (set in __dict__): the cells are registered
        # once, under cell_fw / cell_bw, as in the JAX layer's state_dict
        self.__dict__["rnn_fw"] = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.__dict__["rnn_bw"] = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None, **kwargs):
        states_fw, states_bw = (None, None) if initial_states is None else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length, **kwargs)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length, **kwargs)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)


# ---------------------------------------------------------------- stacks
class _RNNBase(Layer):
    """``num_layers`` RNN (or BiRNN) layers; states ``[L·D, N, H]`` (a pair
    of them for the LSTM), layer by layer, forward before backward."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, device=None):
        super().__init__()
        if direction in ("bidirectional", "bidirect"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"direction should be forward or bidirect(ional), got {direction}")
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.state_components = 2 if mode == "LSTM" else 1
        self.generator = None
        kw = dict(weight_ih_attr=weight_ih_attr, weight_hh_attr=weight_hh_attr,
                  bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr, device="cpu")

        def make_cell(in_size):
            if mode == "LSTM":
                return LSTMCell(in_size, hidden_size, **kw)
            if mode == "GRU":
                return GRUCell(in_size, hidden_size, **kw)
            return SimpleRNNCell(in_size, hidden_size, activation, **kw)

        self._all_layers = LayerList()
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * self.num_directions
            if self.num_directions == 2:
                self._all_layers.append(BiRNN(make_cell(in_size), make_cell(in_size),
                                              time_major))
            else:
                self._all_layers.append(RNN(make_cell(in_size), False, time_major))
        place(self, device)     # built on the CPU, moved once

    def forward(self, inputs, initial_states=None, sequence_length=None):
        D, L, C = self.num_directions, self.num_layers, self.state_components
        if initial_states is None:
            batch = inputs.shape[1 if self.time_major else 0]

            def zeros():
                return torch.zeros(L * D, batch, self.hidden_size, dtype=torch.float32,
                                   device=inputs.device)

            initial_states = (zeros(), zeros()) if C == 2 else zeros()
        comp = list(initial_states) if C == 2 else [initial_states]

        def at(i):      # the states of row i of [L*D, N, H]
            st = tuple(c[i] for c in comp)
            return st if C == 2 else st[0]

        x, finals = inputs, []
        for layer in range(L):
            st = (at(2 * layer), at(2 * layer + 1)) if D == 2 else at(layer)
            x, st = self._all_layers[layer](x, st, sequence_length)
            finals.extend(st if D == 2 else (st,))
            if self.dropout > 0.0 and layer < L - 1:
                x = F.dropout(x, p=self.dropout, training=self.training,
                              generator=self.generator)
        stacked = [torch.stack([f[i] if C == 2 else f for f in finals], 0) for i in range(C)]
        return x, (tuple(stacked) if C == 2 else stacked[0])

    def extra_repr(self):
        return (f"{self.input_size}, {self.hidden_size}, num_layers={self.num_layers}, "
                f"directions={self.num_directions}")


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None):
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU", input_size,
                         hidden_size, num_layers, direction, time_major, dropout,
                         activation, weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr, device)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, device=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, device)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, device=None):
        super().__init__("GRU", input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, device)
