"""Recurrent layers — the port of ``paddle_tpu/nn/rnn.py``:
``SimpleRNN``, ``GRU`` and ``LSTM`` over ``_RNNBase``, the cells
(``SimpleRNNCell``, ``GRUCell``, ``LSTMCell``, ``RNNCellBase``) and the
``RNN`` / ``BiRNN`` wrappers that drive a cell over a sequence.

The time loop is a Python loop over the port's own torch ops, one step
of the reference's ``lax.scan`` body at a time, in its order of
operations: ``x W_ih^T + b_ih + h W_hh^T + b_hh``; LSTM's gates i, f, g,
o; GRU's r, z, n with ``n = tanh(i_n + r * h_n)``. The reverse
direction walks the sequence backwards, as the reference's flip, scan,
flip. Parameters are drawn in the reference's order (layer by layer,
forward then ``_reverse``; weight_ih, weight_hh, bias_ih, bias_hh), each
``Uniform(-1 / sqrt(hidden), 1 / sqrt(hidden))``.

Pinned to the reference: ``_RNNBase.forward`` never reads
``sequence_length`` or ``dropout``; the ``RNN`` wrapper masks both its
outputs (zero past each length) and its states (kept past each length).
"""
from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..core.dtype import to_torch_dtype
from . import initializer as I
from .layer import Layer

__all__ = ["SimpleRNN", "GRU", "LSTM", "SimpleRNNCell", "GRUCell",
           "LSTMCell", "RNNCellBase", "RNN", "BiRNN"]


def _map(fn, *trees):
    """``fn`` over the tensors of like-shaped nests of tuples, lists and
    dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _cell_step(mode, carry, x_t, w_ih, w_hh, b_ih, b_hh):
    """One step of the reference's scan body: ``(new carry, output)``."""
    if mode == "LSTM":
        h, c = carry
        gates = x_t @ w_ih.T + b_ih + h @ w_hh.T + b_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        return (h_new, c_new), h_new
    if mode == "GRU":
        h = carry
        i_r, i_z, i_n = torch.chunk(x_t @ w_ih.T + b_ih, 3, dim=-1)
        h_r, h_z, h_n = torch.chunk(h @ w_hh.T + b_hh, 3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1 - z) * n + z * carry
        return h_new, h_new
    h_new = torch.tanh(x_t @ w_ih.T + b_ih + carry @ w_hh.T + b_hh)
    return h_new, h_new


def _uniform(layer, shape, std, attr=None, is_bias=False):
    return layer.create_parameter(shape, attr=attr, is_bias=is_bias,
                                  default_initializer=I.Uniform(-std, std))


class _RNNBase(Layer):
    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        gates = {"RNN": 1, "GRU": 3, "LSTM": 4}[self.MODE] * hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = "_reverse" if d else ""
                self.add_parameter(f"weight_ih_l{layer}{sfx}", _uniform(
                    self, (gates, in_sz), std, weight_ih_attr))
                self.add_parameter(f"weight_hh_l{layer}{sfx}", _uniform(
                    self, (gates, hidden_size), std, weight_hh_attr))
                self.add_parameter(f"bias_ih_l{layer}{sfx}", _uniform(
                    self, (gates,), std, bias_ih_attr, True))
                self.add_parameter(f"bias_hh_l{layer}{sfx}", _uniform(
                    self, (gates,), std, bias_hh_attr, True))

    def _layer_params(self, layer, reverse):
        sfx = "_reverse" if reverse else ""
        return tuple(self._parameters[f"{n}_l{layer}{sfx}"] for n in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, h_n)``, LSTM ``(outputs, (h_n, c_n))``; the states
        ``[num_layers * directions, batch, hidden]``. ``sequence_length``
        is accepted and not read, as in the reference."""
        has_cell = self.MODE == "LSTM"
        x = inputs if self.time_major else inputs.transpose(0, 1)
        nl, nd, h = self.num_layers, self.num_directions, self.hidden_size
        if initial_states is None:
            z = x.new_zeros((nl * nd, x.shape[1], h))
            initial_states = (z, z.clone()) if has_cell else z
        h0, c0 = initial_states if has_cell else (initial_states, None)
        layer_in, hs, cs = x, [], []
        steps = layer_in.shape[0]
        for layer in range(nl):
            outs_d = []
            for d in range(nd):
                params = self._layer_params(layer, bool(d))
                idx = layer * nd + d
                carry = (h0[idx], c0[idx]) if has_cell else h0[idx]
                outs = [None] * steps
                for t in (range(steps - 1, -1, -1) if d else range(steps)):
                    carry, outs[t] = _cell_step(self.MODE, carry,
                                                layer_in[t], *params)
                outs_d.append(torch.stack(outs))
                if has_cell:
                    hs.append(carry[0])
                    cs.append(carry[1])
                else:
                    hs.append(carry)
            layer_in = torch.cat(outs_d, dim=-1) if nd == 2 else outs_d[0]
        out = layer_in if self.time_major else layer_in.transpose(0, 1)
        if has_cell:
            return out, (torch.stack(hs), torch.stack(cs))
        return out, torch.stack(hs)


class SimpleRNN(_RNNBase):
    MODE = "RNN"


class GRU(_RNNBase):
    MODE = "GRU"


class LSTM(_RNNBase):
    MODE = "LSTM"


class _GateCell(Layer):
    """The LSTM and GRU cells: ``weight_ih [G, in]``, ``weight_hh [G,
    hidden]``, ``bias_ih``, ``bias_hh``; the ``*_attr`` arguments are
    accepted and not used, as in the reference."""
    MODE = "LSTM"

    def __init__(self, input_size, hidden_size, name=None, **kw):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        gates = {"GRU": 3, "LSTM": 4}[self.MODE] * hidden_size
        self.hidden_size = hidden_size
        self.weight_ih = _uniform(self, (gates, input_size), std)
        self.weight_hh = _uniform(self, (gates, hidden_size), std)
        self.bias_ih = _uniform(self, (gates,), std, is_bias=True)
        self.bias_hh = _uniform(self, (gates,), std, is_bias=True)

    def _params(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class LSTMCell(_GateCell):
    """``forward(inputs, states=None)`` -> ``(h, (h, c))``."""
    MODE = "LSTM"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size)

    def forward(self, inputs, states=None):
        if states is None:
            z = inputs.new_zeros((inputs.shape[0], self.hidden_size))
            states = (z, z.clone())
        (h_new, c_new), _ = _cell_step("LSTM", tuple(states), inputs,
                                       *self._params())
        return h_new, (h_new, c_new)


class GRUCell(_GateCell):
    """``forward(inputs, states=None)`` -> ``(h, h)``."""
    MODE = "GRU"

    def forward(self, inputs, states=None):
        if states is None:
            states = inputs.new_zeros((inputs.shape[0], self.hidden_size))
        h_new, _ = _cell_step("GRU", states, inputs, *self._params())
        return h_new, h_new


class RNNCellBase(Layer):
    """Base of single-step cells: ``get_initial_states``; a subclass
    defines ``forward(inputs, states) -> (outputs, new_states)`` and
    ``state_shape``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``shape`` (default ``state_shape``; a list of shapes
        gives a tuple) filled with ``init_value``, the batch taken from
        ``batch_ref``, its dtype by default (float32 for a non-tensor)."""
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape if shape is not None else self.state_shape
        is_t = isinstance(batch_ref, torch.Tensor)
        dt = (batch_ref.dtype if is_t else torch.float32) \
            if dtype is None else to_torch_dtype(dtype)
        dev = batch_ref.device if is_t else resolve_device(None)

        def make(s):
            dims = s if isinstance(s, (list, tuple)) else [s]
            return torch.full((batch,) + tuple(int(e) for e in dims),
                              init_value, dtype=dt, device=dev)

        if isinstance(shape, (list, tuple)) and shape and \
                isinstance(shape[0], (list, tuple)):
            return tuple(make(s) for s in shape)
        return make(shape)

    @property
    def state_shape(self):
        raise NotImplementedError


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, ``act`` tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        std = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        self.activation = activation
        self.weight_ih = _uniform(self, (hidden_size, input_size), std,
                                  weight_ih_attr)
        self.weight_hh = _uniform(self, (hidden_size, hidden_size), std,
                                  weight_hh_attr)
        self.bias_ih = _uniform(self, (hidden_size,), std, bias_ih_attr,
                                True)
        self.bias_hh = _uniform(self, (hidden_size,), std, bias_hh_attr,
                                True)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        h_new = act(inputs @ self.weight_ih.T + self.bias_ih
                    + states @ self.weight_hh.T + self.bias_hh)
        return h_new, h_new


class RNN(Layer):
    """Drive a single-step cell over a sequence, a Python loop over time.
    With ``sequence_length``, a row's states stop changing past its length
    (so a reverse pass starts at its last real step) and its outputs
    there are zero, as the reference masks them."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        steps = x.shape[0]
        states = initial_states
        if states is None and hasattr(self.cell, "get_initial_states"):
            states = self.cell.get_initial_states(x[0])
        lengths = None
        if sequence_length is not None:
            lengths = torch.as_tensor(sequence_length, device=x.device)

        def freeze(new, old, valid):
            def leaf(n, o):
                m = valid.reshape((-1,) + (1,) * (n.dim() - 1))
                return torch.where(m, n, o)
            return _map(leaf, new, old)

        outs = [None] * steps
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for t in order:
            out, new_states = self.cell(x[t], states, **kwargs)
            states = new_states if lengths is None else \
                freeze(new_states, states, t < lengths)
            outs[t] = out
        y = torch.stack(outs, dim=0 if self.time_major else 1)
        if lengths is not None:
            t_idx = torch.arange(steps, device=x.device)
            mask = (t_idx[:, None] < lengths[None, :]) if self.time_major \
                else (t_idx[None, :] < lengths[:, None])
            y = y * mask[..., None].to(y.dtype)
        return y, states


class BiRNN(Layer):
    """A forward and a reverse ``RNN`` over the same input, the outputs
    concatenated and the states paired."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        y_fw, s_fw = self.rnn_fw(inputs, st_fw, sequence_length, **kwargs)
        y_bw, s_bw = self.rnn_bw(inputs, st_bw, sequence_length, **kwargs)
        return torch.cat([y_fw, y_bw], dim=-1), (s_fw, s_bw)
