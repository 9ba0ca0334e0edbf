"""Weights carried across: the reference's glow_pytorch names <-> ``SeqGlow``.

The reference's ``state_dict`` names (the names a PyTorch-Lightning ``.ckpt``
of glow_pytorch carries, and that ``lets_face_it_tpu/sample/torch_import.py``
maps) are:

  seq_glow.feature_encoder.<m>_encoder.encoder.{weight_ih_l0,...}  -> encoder[m]["rnn"]
  seq_glow.feature_encoder.<m>_encoder.encoder.0.{weight,bias}     -> encoder[m]["mlp"]
  seq_glow.feature_encoder.<m>_encoder.encoder.{weight,bias}       -> encoder[m] (cnn)
  seq_glow.glow.flow.layers.<k>.actnorm.{bias,logs} [1, C]         -> flow["actnorm"] [K, C]
  seq_glow.glow.flow.layers.<k>.invconv.{p,sign_s,l,log_s,u}       -> flow["perm"]
  seq_glow.glow.flow.layers.<k>.f.rnn.{weight_ih,...}              -> flow["rnn"]
  seq_glow.glow.flow.layers.<k>.f.cond_transform.0.{weight,bias}   -> flow["cond_proj"]
  seq_glow.glow.flow.layers.<k>.f.final_linear.{weight,bias,logs}  -> flow["out"]

Values are copied bit for bit (float32). An imported checkpoint is treated as
actnorm-initialised (models.py:515-518).
"""

from __future__ import annotations

import numpy as np
import torch

from lets_face_it_tpu_torch.model.encoders import MODALITY_ORDER
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec

_RNN_NAMES = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
              ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
_INVCONV = ("p", "sign_s", "l", "log_s", "u")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.array(v, np.float32))


def _encoder_names(spec: FlowSpec):
    """(modality, key path, reference name) for every encoder leaf."""
    for m in MODALITY_ORDER:
        espec = getattr(spec.cond, m)
        if espec is None or espec.out_dim == 0:
            continue
        pre = f"seq_glow.feature_encoder.{m}_encoder.encoder"
        if espec.enc in ("rnn", "lstm"):
            for ours, theirs in _RNN_NAMES:
                yield m, ("rnn", ours), f"{pre}.{theirs}_l0"
        elif espec.enc == "mlp":
            yield m, ("mlp", "w"), f"{pre}.0.weight"
            yield m, ("mlp", "b"), f"{pre}.0.bias"
        elif espec.enc == "cnn":
            yield m, ("w",), f"{pre}.weight"
            yield m, ("b",), f"{pre}.bias"


def _flow_names(spec: FlowSpec):
    """(key path, reference suffix) for every flow leaf of one step."""
    if spec.permutation != "invconv":
        raise NotImplementedError(
            "reference checkpoints only ship invconv permutations")
    yield ("actnorm", "bias"), "actnorm.bias"
    yield ("actnorm", "logs"), "actnorm.logs"
    for name in _INVCONV:
        yield ("perm", name), f"invconv.{name}"
    for ours, theirs in _RNN_NAMES:
        yield ("rnn", ours), f"f.rnn.{theirs}"
    yield ("cond_proj", "w"), "f.cond_transform.0.weight"
    yield ("cond_proj", "b"), "f.cond_transform.0.bias"
    yield ("out", "w"), "f.final_linear.weight"
    yield ("out", "b"), "f.final_linear.bias"
    yield ("out", "logs"), "f.final_linear.logs"


def _set(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def trees_from_reference(state: dict, spec: FlowSpec) -> tuple[dict, dict]:
    """Reference-named state -> (encoder tree, stacked flow tree) of CPU
    float32 tensors."""
    def arr(name):
        if name not in state:
            raise KeyError(f"missing parameter {name!r} in checkpoint "
                           f"(have e.g. {sorted(state)[:5]}...)")
        return _tensor(state[name])

    encoder: dict = {m: {} for m in MODALITY_ORDER
                     if m == "p1_face" or getattr(spec.cond, m) is not None}
    for m, path, name in _encoder_names(spec):
        _set(encoder[m], path, arr(name))
    flow: dict = {}
    for path, suffix in _flow_names(spec):
        leaves = [arr(f"seq_glow.glow.flow.layers.{k}.{suffix}")
                  for k in range(spec.n_steps)]
        if path[0] == "actnorm":
            leaves = [x.reshape(-1) for x in leaves]
        _set(flow, path, torch.stack(leaves))
    return encoder, flow


def model_from_reference(state: dict, spec: FlowSpec) -> SeqGlow:
    """A ``SeqGlow`` (on the CPU) holding a reference-named state."""
    return SeqGlow(spec, *trees_from_reference(state, spec))


@torch.no_grad()
def load_state_dict(model: SeqGlow, state: dict) -> SeqGlow:
    """Copy a reference-named state (numpy arrays or tensors) into ``model``
    in place; every parameter must be present with its shape."""
    encoder, flow = trees_from_reference(state, model.spec)

    def copy(dst, src, where):
        for key, value in src.items():
            if isinstance(value, dict):
                copy(dst[key], value, f"{where}.{key}")
                continue
            if tuple(dst[key].shape) != tuple(value.shape):
                raise ValueError(f"{where}.{key}: checkpoint shape "
                                 f"{tuple(value.shape)}, model "
                                 f"{tuple(dst[key].shape)}")
            dst[key].copy_(value.to(dst[key].dtype))

    copy(model.encoder, encoder, "encoder")
    copy(model.flow, flow, "flow")
    return model


def state_dict_reference(model: SeqGlow) -> dict[str, torch.Tensor]:
    """The inverse of ``load_state_dict``: reference-named CPU tensors."""
    spec = model.spec

    def leaf(tree, path):
        for key in path:
            tree = tree[key]
        return tree.detach().to("cpu", torch.float32)

    state = {name: leaf(model.encoder[m], path).clone()
             for m, path, name in _encoder_names(spec)}
    for path, suffix in _flow_names(spec):
        stacked = leaf(model.flow, path)
        for k in range(spec.n_steps):
            value = stacked[k]
            if path[0] == "actnorm":
                value = value[None]
            state[f"seq_glow.glow.flow.layers.{k}.{suffix}"] = value.clone()
    return state


@torch.no_grad()
def seeded_random_model(spec: FlowSpec, seed: int, *,
                        width_scaled_head: bool = False) -> SeqGlow:
    """Full-width random weights for smoke and profiling runs (the repo ships
    no trained ``final_model``): the port's init on the CPU, then
    ``0.05 * N(0, 1)`` added to every trained flow leaf except the invconv's
    off-diagonal LU factors, so that the zero-initialised coupling heads make
    the GRUs matter. The factors stay as initialised (W orthogonal up to its
    diagonal): perturbed as much, the sixteen 56x56 inverses of final_model
    are poorly conditioned and the autoregressive sequence turns chaotic, so
    that float32 rounding alone changes whole frames.

    ``width_scaled_head``: the coupling heads' weights perturbed by
    ``0.05 * sqrt(128 / H)`` instead, so that their outputs spread as at
    final_model's H = 128 at any width. With 0.05 the spread grows as
    sqrt(H), the coupling divides by scales near their floor, and from
    H = 2,048 at K = 16 (8,192 at K = 4) one frame of the random flow
    already spreads float32 rounding past 2e-4 (PERF.md §6)."""
    generator = torch.Generator().manual_seed(seed)
    model = SeqGlow.init(spec, generator)
    head = (128.0 / spec.hidden_channels) ** 0.5 if width_scaled_head else 1.0
    for name, p in model.flow.named_parameters():
        if p.requires_grad and name not in ("perm.l", "perm.u"):
            scale = 0.05 * (head if name == "out.w" else 1.0)
            p.add_(scale * torch.randn(p.shape, generator=generator))
    return model


def from_jax_params(encoder_np: dict, flow_np: dict, spec: FlowSpec) -> SeqGlow:
    """A ``SeqGlow`` (on the CPU) from the JAX package's ``SeqGlowParams``
    trees given as nested dicts of numpy arrays (the two trees have the same
    keys)."""
    def convert(tree):
        return {k: convert(v) if isinstance(v, dict) else
                torch.as_tensor(np.array(v)) for k, v in tree.items()}

    encoder = convert(encoder_np)
    encoder.setdefault("p1_face", {})
    return SeqGlow(spec, encoder, convert(flow_np))
