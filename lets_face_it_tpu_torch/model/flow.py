"""The flow network: K stacked steps (actnorm -> 1x1 mix -> recurrent coupling),
the port of ``lets_face_it_tpu/model/flow.py``.

All K steps' parameters are stacked on a leading axis; every leaf of the flow
parameter tree is ``[K, ...]``. The per-step coupling-RNN hidden states are
explicit ``[K, B, H]`` tensors threaded by the caller (the MoGlow stateful
coupling, models.py:148-214). Every step's conditioning projection is hoisted
into one matmul per frame (``project_cond``).

The plain functions here are the reference for the sampling kernels in
``ops/flow_kernels.py`` and the training kernels in ``ops/train_kernels.py``,
and the path taken for flows outside those kernels' envelopes (LSTM or
additive couplings, shuffle/reverse permutations).
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from lets_face_it_tpu_torch.core import ops, rnn
from lets_face_it_tpu_torch.model.spec import FlowSpec


def is_tree(x) -> bool:
    """A parameter subtree: a dict, or the ModuleDict/ParameterDict of a
    ``SeqGlow``."""
    return isinstance(x, (Mapping, nn.ModuleDict, nn.ParameterDict))


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_index(tree, k: int):
    """Step k's parameters from the stacked [K, ...] tree."""
    if is_tree(tree):
        return {name: tree_index(v, k) for name, v in tree.items()}
    return tree[k]


def _init_one_step(generator: torch.Generator, spec: FlowSpec) -> dict:
    c = spec.channels
    params = {"actnorm": ops.init_actnorm(c)}
    if spec.permutation == "invconv":
        params["perm"] = ops.init_invconv_lu(generator, c)
    else:
        params["perm"] = ops.init_permute(generator, c,
                                          spec.permutation == "shuffle")
    rnn_in = spec.z1_dim + spec.cond.cond_dim
    if spec.rnn_type == "gru":
        params["rnn"] = rnn.init_gru_cell(generator, rnn_in, spec.hidden_channels)
    else:
        params["rnn"] = rnn.init_lstm_cell(generator, rnn_in, spec.hidden_channels)
    params["cond_proj"] = ops.init_linear(
        generator, spec.cond.feature_dim, spec.cond.cond_dim)
    params["out"] = ops.init_linear_zeros(spec.hidden_channels,
                                          spec.coupling_out_dim)
    return params


def init_flow(generator: torch.Generator, spec: FlowSpec) -> dict:
    """All K steps stacked: every leaf gains a leading [K] axis (CPU tensors)."""
    return _stack_trees([_init_one_step(generator, spec)
                         for _ in range(spec.n_steps)])


def init_flow_states(spec: FlowSpec, batch_size: int, device=None):
    """Fresh (zero) coupling-RNN states for a sequence start: [K, B, H]
    (a pair of them for LSTM couplings)."""
    shape = (spec.n_steps, batch_size, spec.hidden_channels)
    if spec.rnn_type == "gru":
        return torch.zeros(shape, device=device)
    return (torch.zeros(shape, device=device), torch.zeros(shape, device=device))


def _state_at(states, k):
    if isinstance(states, tuple):
        return tuple(s[k] for s in states)
    return states[k]


def _stack_states(per_step):
    if isinstance(per_step[0], tuple):
        return tuple(torch.stack(s) for s in zip(*per_step))
    return torch.stack(per_step)


def _perm_fwd(spec, p, z, logdet):
    if spec.permutation == "invconv":
        return ops.invconv_fwd(p, z, logdet)
    return ops.permute_fwd(p, z, logdet)


def _perm_rev(spec, p, z, logdet):
    if spec.permutation == "invconv":
        return ops.invconv_rev(p, z, logdet)
    return ops.permute_rev(p, z, logdet)


def _coupling_net(spec: FlowSpec, p, z1, cond_proj, state):
    """The recurrent transform net on [z1 | leaky_relu(cond_proj)];
    returns (head output, new state)."""
    rnn_in = torch.cat([z1, ops.leaky_relu(cond_proj)], dim=-1)
    if spec.rnn_type == "gru":
        h_new = rnn.gru_cell(p["rnn"], rnn_in, state)
        new_state = h_new
    else:
        h_new, c_new = rnn.lstm_cell(p["rnn"], rnn_in, state)
        new_state = (h_new, c_new)
    return ops.linear_zeros(p["out"], h_new), new_state


def _apply_coupling_fwd(spec, h, z2, logdet):
    if spec.coupling == "additive":
        return z2 + h, logdet
    shift, scale_raw = ops.split_cross(h)
    scale = ops.affine_scale(scale_raw, spec.scale_eps)
    return (z2 + shift) * scale, logdet + torch.log(scale).sum(-1)


def _apply_coupling_rev(spec, h, z2, logdet):
    if spec.coupling == "additive":
        return z2 - h, logdet
    shift, scale_raw = ops.split_cross(h)
    scale = ops.affine_scale(scale_raw, spec.scale_eps)
    return z2 / scale - shift, logdet - torch.log(scale).sum(-1)


def project_cond(flow_params, cond):
    """One matmul for all K steps' conditioning projections: cond [B, F] ->
    [K, B, cond_dim] (pre-activation, bias included)."""
    w = flow_params["cond_proj"]["w"]            # [K, c, F]
    b = flow_params["cond_proj"]["b"]            # [K, c]
    return torch.einsum("bf,kcf->kbc", cond, w) + b[:, None, :]


def project_cond_split(flow_params, p1_dim: int, fixed_cond_all):
    """Sampling-path split: the own-face encoding (first ``p1_dim`` features)
    is autoregressive, the rest is known upfront. Precomputes the fixed part
    (+ bias) for all frames and returns the p1 weight slice for the in-loop
    contribution: (fixed_projs [N, K, B, c], w_p1 [K, c, p1_dim])."""
    w = flow_params["cond_proj"]["w"]            # [K, c, F]
    b = flow_params["cond_proj"]["b"]
    w_p1 = w[:, :, :p1_dim]
    w_fixed = w[:, :, p1_dim:]
    bsz, n, f = fixed_cond_all.shape
    k, c, _ = w.shape
    flat = fixed_cond_all.reshape(bsz * n, f)
    wt = w_fixed.permute(2, 0, 1).reshape(f, k * c)
    fixed = ((flat @ wt).reshape(bsz, n, k, c).permute(1, 2, 0, 3)
             + b[None, :, None, :])
    return fixed.contiguous(), w_p1


def project_cond_frames(flow_params, cond_all):
    """Projections for every frame at once: [B, N, F] -> [N, K, B, cond_dim]
    (pre-activation, bias included), one [B*N, F] @ [F, K*c] matmul."""
    w = flow_params["cond_proj"]["w"]            # [K, c, F]
    b = flow_params["cond_proj"]["b"]
    bsz, n, f = cond_all.shape
    k, c, _ = w.shape
    wt = w.permute(2, 0, 1).reshape(f, k * c)
    proj = (cond_all.reshape(bsz * n, f) @ wt).reshape(bsz, n, k, c)
    return proj.permute(1, 2, 0, 3) + b[None, :, None, :]


def frame_fwd(spec: FlowSpec, flow_params, x, cond, states, *, cond_projs=None,
              collect_scales=False):
    """Encode one frame through all K steps. x: [B, C], cond: [B, F] (ignored
    when ``cond_projs`` [K, B, cond_dim] are given).
    Returns (z, logdet [B], new_states[, scales [K, B, Cout/2] of an affine
    coupling])."""
    if cond_projs is None:
        cond_projs = project_cond(flow_params, cond)
    z = x
    logdet = x.new_zeros(x.shape[:-1])
    new_states, scales = [], []
    for k in range(spec.n_steps):
        p = tree_index(flow_params, k)
        z, logdet = ops.actnorm_fwd(p["actnorm"], z, logdet)
        z, logdet = _perm_fwd(spec, p["perm"], z, logdet)
        z1, z2 = ops.split_half(z)
        h, new_state = _coupling_net(spec, p, z1, cond_projs[k],
                                     _state_at(states, k))
        if collect_scales and spec.coupling == "affine":
            scales.append(ops.affine_scale(ops.split_cross(h)[1], spec.scale_eps))
        z2, logdet = _apply_coupling_fwd(spec, h, z2, logdet)
        z = ops.cat_half(z1, z2)
        new_states.append(new_state)
    if collect_scales:
        return z, logdet, _stack_states(new_states), torch.stack(scales)
    return z, logdet, _stack_states(new_states)


def frame_rev(spec: FlowSpec, flow_params, z, cond, states, *, cond_projs=None):
    """Decode one frame: traverse the K steps in reverse order. Each step's
    coupling RNN still advances its own state once per frame
    (models.py:345-373, 453-462). Returns (x, logdet [B], new_states)."""
    if cond_projs is None:
        cond_projs = project_cond(flow_params, cond)
    logdet = z.new_zeros(z.shape[:-1])
    new_states = [None] * spec.n_steps
    for k in reversed(range(spec.n_steps)):
        p = tree_index(flow_params, k)
        z1, z2 = ops.split_half(z)
        h, new_states[k] = _coupling_net(spec, p, z1, cond_projs[k],
                                         _state_at(states, k))
        z2, logdet = _apply_coupling_rev(spec, h, z2, logdet)
        z = ops.cat_half(z1, z2)
        z, logdet = _perm_rev(spec, p["perm"], z, logdet)
        z, logdet = ops.actnorm_rev(p["actnorm"], z, logdet)
    return z, logdet, _stack_states(new_states)


@torch.no_grad()
def actnorm_sequential_init(spec: FlowSpec, flow_params, x0, cond0) -> dict:
    """Data-dependent actnorm init from the first conditioned frame x0 [B, C]
    (cond0 [B, F]): step k's actnorm sees x0 after steps 0..k-1 with their
    new actnorms (modules.py:32-43; the reference initialises lazily in its
    first forward). Returns {"bias": [K, C], "logs": [K, C]}."""
    cond_projs = project_cond(flow_params, cond0)
    states = init_flow_states(spec, x0.shape[0], x0.device)
    zero = x0.new_zeros(x0.shape[:-1])
    z = x0
    bias, logs = [], []
    for k in range(spec.n_steps):
        p = tree_index(flow_params, k)
        an = ops.actnorm_data_init(z, spec.actnorm_scale)
        bias.append(an["bias"])
        logs.append(an["logs"])
        z, _ = ops.actnorm_fwd(an, z, zero)
        z, _ = _perm_fwd(spec, p["perm"], z, zero)
        z1, z2 = ops.split_half(z)
        h, _ = _coupling_net(spec, p, z1, cond_projs[k], _state_at(states, k))
        z2, _ = _apply_coupling_fwd(spec, h, z2, zero)
        z = ops.cat_half(z1, z2)
    return {"bias": torch.stack(bias), "logs": torch.stack(logs)}
