"""Recurrent cells as plain functions on tensors (the port of
``lets_face_it_tpu/core/rnn.py``).

Gate math and initialisation match ``torch.nn.GRUCell`` / ``torch.nn.LSTMCell``
so that reference glow_pytorch checkpoints load verbatim. The cells are
written out with explicit matmuls rather than calling ``torch.gru_cell`` so
that the CPU tests and the card run the same arithmetic.

Parameter layout (a mapping of tensors):
    w_ih: [3H or 4H, in]   gate order GRU: (r, z, n); LSTM: (i, f, g, o)
    w_hh: [3H or 4H, H]
    b_ih, b_hh: [3H or 4H]
"""

from __future__ import annotations

import math

import torch

from lets_face_it_tpu_torch.core.ops import uniform_init


def _init_cell(generator: torch.Generator, input_size: int, hidden_size: int,
               gates: int) -> dict:
    k = 1.0 / math.sqrt(hidden_size)
    g = gates * hidden_size
    return {
        "w_ih": uniform_init(generator, (g, input_size), k),
        "w_hh": uniform_init(generator, (g, hidden_size), k),
        "b_ih": uniform_init(generator, (g,), k),
        "b_hh": uniform_init(generator, (g,), k),
    }


def init_gru_cell(generator: torch.Generator, input_size: int,
                  hidden_size: int) -> dict:
    """U(-1/sqrt(H), 1/sqrt(H)) for all tensors, as torch does."""
    return _init_cell(generator, input_size, hidden_size, 3)


def init_lstm_cell(generator: torch.Generator, input_size: int,
                   hidden_size: int) -> dict:
    return _init_cell(generator, input_size, hidden_size, 4)


def gru_cell(params, x, h):
    """One GRU step. x: [..., in], h: [..., H] -> new h.

    r = sig(Wr x + br + Ur h + cr)
    z = sig(Wz x + bz + Uz h + cz)
    n = tanh(Wn x + bn + r * (Un h + cn))
    h' = (1 - z) n + z h
    """
    gi = x @ params["w_ih"].T + params["b_ih"]
    gh = h @ params["w_hh"].T + params["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def lstm_cell(params, x, state):
    """One LSTM step. state = (h, c)."""
    h, c = state
    gates = (x @ params["w_ih"].T + params["b_ih"]
             + h @ params["w_hh"].T + params["b_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def gru_scan(params, xs, h0=None):
    """A GRU over the time axis. xs: [B, T, in] -> (outputs [B, T, H], h_T).
    Equivalent to a single-layer batch_first ``torch.nn.GRU``."""
    hidden = params["w_hh"].shape[1]
    h = h0 if h0 is not None else xs.new_zeros(xs.shape[:-2] + (hidden,))
    ys = []
    for t in range(xs.shape[-2]):
        h = gru_cell(params, xs[..., t, :], h)
        ys.append(h)
    return torch.stack(ys, dim=-2), h


def lstm_scan(params, xs, state0=None):
    """Single-layer LSTM over time. xs: [B, T, in] -> (outputs, (h_T, c_T))."""
    hidden = params["w_hh"].shape[1]
    if state0 is None:
        zeros = xs.new_zeros(xs.shape[:-2] + (hidden,))
        state0 = (zeros, zeros)
    state = state0
    ys = []
    for t in range(xs.shape[-2]):
        state = lstm_cell(params, xs[..., t, :], state)
        ys.append(state[0])
    return torch.stack(ys, dim=-2), state
