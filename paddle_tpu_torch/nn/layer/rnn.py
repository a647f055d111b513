"""RNN layers (port of ``paddle_tpu/nn/layer/rnn.py``): the cells, ``RNN``
and ``BiRNN`` over a cell, and ``SimpleRNN``/``LSTM``/``GRU``.

The gates are the reference's: LSTM i, f, g, o; GRU r, z, c with the
candidate ``tanh(cx + r * (W_hc h + b_hc))``. Weights are
``weight_ih_l{k}[_rev]`` (gates * hidden, in), ``weight_hh_l{k}[_rev]``,
``bias_ih_l{k}[_rev]`` and ``bias_hh_l{k}[_rev]``, all uniform in
+-1 / sqrt(hidden). A layer's input projection for every step is one
product before its time loop; each step then adds ``h @ W_hh^T``. The
reverse direction runs over the flipped sequence; a bidirectional layer
concatenates the two on the last axis. As in the reference, ``SimpleRNN``
always uses tanh, and ``sequence_length`` and the between-layer
``dropout`` are accepted and not used.
"""
from __future__ import annotations

import math

import torch

from ...core import dtype as dtypes
from .. import initializer as I
from .layers import Layer

_GATES = {"lstm": 4, "gru": 3, "rnn": 1}


def _lstm_step(g, h, c):
    i, f, gg, o = g.chunk(4, -1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def _gru_step(gx, gh, h):
    rx, zx, cx = gx.chunk(3, -1)
    rh, zh, ch = gh.chunk(3, -1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    c = torch.tanh(cx + r * ch)
    return (1 - z) * c + z * h


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``init_value``-filled states of ``[batch] + shape`` (the cell's
        ``state_shape``; a tuple of shapes gives a tuple of states)."""
        batch = batch_ref.shape[batch_dim_idx]
        state_shape = shape or getattr(self, "state_shape", None)
        dt = dtypes.convert_dtype(dtype) or dtypes.get_default_dtype()

        def build(s):
            return torch.full([batch] + list(s), init_value, dtype=dt,
                              device=batch_ref.device)

        if isinstance(state_shape, tuple) and state_shape and isinstance(
                state_shape[0], (list, tuple)):
            return tuple(build(s) for s in state_shape)
        return build(state_shape)

    def _make(self, gates, input_size, hidden_size, attrs, device, generator):
        u = I.Uniform(-1.0 / math.sqrt(hidden_size),
                      1.0 / math.sqrt(hidden_size))
        kw = {"default_initializer": u, "device": device,
              "generator": generator}
        w_ih, w_hh, b_ih, b_hh = attrs
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], attr=w_ih, **kw)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], attr=w_hh, **kw)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], attr=b_ih, is_bias=True, **kw)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], attr=b_hh, is_bias=True, **kw)
        self.input_size, self.hidden_size = input_size, hidden_size

    def _proj(self, x, h):
        return (x @ self.weight_ih.T + self.bias_ih,
                h @ self.weight_hh.T + self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self._make(1, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)
        self.activation = activation
        self.state_shape = (hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gx, gh = self._proj(inputs, states)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        out = act(gx + gh)
        return out, out


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._make(4, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)
        self.state_shape = ((hidden_size,), (hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        gx, gh = self._proj(inputs, h)
        h2, c2 = _lstm_step(gx + gh, h, c)
        return h2, (h2, c2)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._make(3, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)
        self.state_shape = (hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gx, gh = self._proj(inputs, states)
        h2 = _gru_step(gx, gh, states)
        return h2, h2


def _run_layer(mode, x, h, c, w_ih, w_hh, b_ih, b_hh, reverse):
    """One direction of one layer over (B, T, I) ``x``: (outputs (B, T, H),
    final h, final c)."""
    xp = x @ w_ih.T + b_ih  # every step's input projection at once
    T = x.shape[1]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hp = h @ w_hh.T + b_hh
        if mode == "lstm":
            h, c = _lstm_step(xp[:, t] + hp, h, c)
        elif mode == "gru":
            h = _gru_step(xp[:, t], hp, h)
        else:
            h = torch.tanh(xp[:, t] + hp)
        ys[t] = h
    return torch.stack(ys, 1), h, c


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.mode, self.input_size, self.hidden_size = mode, input_size, \
            hidden_size
        self.num_layers, self.time_major = num_layers, time_major
        self.dropout = dropout
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        g = _GATES[mode]
        std = 1.0 / math.sqrt(hidden_size)
        kw = {"default_initializer": I.Uniform(-std, std), "device": device,
              "generator": generator}
        self._names = []
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.bidirect
                sfx = f"_l{layer}" + ("_rev" if d else "")
                for n, shape, bias in (
                        ("weight_ih", [g * hidden_size, in_sz], False),
                        ("weight_hh", [g * hidden_size, hidden_size], False),
                        ("bias_ih", [g * hidden_size], True),
                        ("bias_hh", [g * hidden_size], True)):
                    self.add_parameter(n + sfx, self.create_parameter(
                        shape, is_bias=bias, **kw))
                self._names.append(sfx)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        B = x.shape[0]
        n = self.num_layers * self.bidirect
        lstm = self.mode == "lstm"
        if initial_states is None:
            z = torch.zeros(n, B, self.hidden_size,
                            dtype=dtypes.get_default_dtype(), device=x.device)
            h0, c0 = z, (z if lstm else None)
        elif lstm:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, None
        out, hs, cs, gi = x, [], [], 0
        for _ in range(self.num_layers):
            dirs = []
            for d in range(self.bidirect):
                sfx = self._names[gi]
                p = [getattr(self, n + sfx) for n in (
                    "weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                ys, hT, cT = _run_layer(self.mode, out, h0[gi],
                                        c0[gi] if lstm else None, *p,
                                        reverse=d == 1)
                dirs.append(ys)
                hs.append(hT)
                cs.append(cT)
                gi += 1
            out = dirs[0] if self.bidirect == 1 else torch.cat(dirs, -1)
        y = out.transpose(0, 1) if self.time_major else out
        if lstm:
            return y, (torch.stack(hs), torch.stack(cs))
        return y, torch.stack(hs)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("rnn", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("lstm", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("gru", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class RNN(Layer):
    """A cell run over time, step by step (backwards when
    ``is_reverse``)."""

    def __init__(self, cell, is_reverse=False, time_major=False, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.cell = cell
        self.is_reverse, self.time_major = is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        T = x.shape[1]
        states, outs = initial_states, [None] * T
        for t in (range(T - 1, -1, -1) if self.is_reverse else range(T)):
            outs[t], states = self.cell(x[:, t], states)
        y = torch.stack(outs, 1)
        return (y.transpose(0, 1) if self.time_major else y), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = initial_states or (None, None)
        y_fw, s_fw = self.rnn_fw(inputs, states_fw, sequence_length)
        y_bw, s_bw = self.rnn_bw(inputs, states_bw, sequence_length)
        return torch.cat([y_fw, y_bw], -1), (s_fw, s_bw)


__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]
