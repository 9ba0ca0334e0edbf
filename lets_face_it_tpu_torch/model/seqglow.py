"""Sequence-level model: parameters, the teacher-forced NLL, autoregressive
sampling and the teacher-forced inversion (the port of
``lets_face_it_tpu/model/seqglow.py``).

Training (``sequence_nll``): all conditioning is known up front (teacher
forcing), so it is encoded and projected for every frame in one pass; inside
the training kernels' envelope (``ops/train_kernels.py::train_supported``,
which holds for ``final_model``) the whole [N frames x K steps] traversal is
one launch of ``seq_fwd`` under a ``torch.autograd.Function`` whose backward
launches ``seq_bwd``; outside it, the plain ``flow.frame_fwd`` loop runs under
autograd. Loss convention (models.py:563-565): bits per frame,
``-(logdet + logp(z)) / ln 2``, mean over batch and frames, not divided by
the channel count.

Sampling: conditioning for all frames except the agent's own face is encoded in one
batched pass before the frame loop; only the own-face contribution to each
step's projection is autoregressive. Inside the sequence kernel's envelope
(``ops/flow_kernels.py::sampling_seq_supported``, which holds for
``final_model``) the whole loop is one launch of ``sequence_rev_fused``;
flows with a recurrent own-face encoder take the per-frame kernel, and flows
outside both envelopes take the plain ``flow.frame_rev`` path. The choice is
made from the ``FlowSpec`` alone. A spec of the JAX package's kernel
envelope (``flow_kernels.jax_envelope``) takes the kernels, on padded lanes
where its widths need them; where a kernel could not take such a spec the
choice raises rather than fall to the plain path.

Inversion (``sequence_invert``): the stored latents are decoded frame by
frame with the conditioning teacher-forced from the ground truth. On the card,
inside the per-frame kernel's envelope, each frame is one ``frame_rev_fused``
call; the kernel returns no logdet, which is recovered afterwards from the
GRU states it wrote (each step's scale depends on its new state alone). As
for sampling, a spec of the JAX kernels' envelope that the kernel could not
take raises on the card (``inversion_route``) rather than run the plain path.
"""

from __future__ import annotations

import functools
import logging

import torch
from torch import nn

from lets_face_it_tpu_torch.core import ops
from lets_face_it_tpu_torch.model import encoders, flow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import flow_kernels, train_kernels
from lets_face_it_tpu_torch.parallel.mesh import shard_batch

logger = logging.getLogger(__name__)

# Leaves that are fixed buffers, not trained parameters: the invconv's
# permutation matrix and diagonal signs, and the shuffle/reverse index maps.
FROZEN_LEAVES = ("p", "sign_s", "perm", "inv")


def _module_tree(tree, name: str = ""):
    """Nested dict of tensors -> ModuleDict of ParameterDicts."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=k not in FROZEN_LEAVES
                            and v.is_floating_point())
            for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        raise ValueError(f"parameter tree {name!r} mixes tensors and subtrees")
    return nn.ModuleDict({k: _module_tree(v, f"{name}.{k}")
                          for k, v in tree.items()})


class SeqGlow(nn.Module):
    """The conditioning encoders and the K stacked flow steps.

    ``encoder[m]`` holds modality m's encoder parameters
    (``model/encoders.py``); every leaf of ``flow`` is stacked ``[K, ...]``
    (``model/flow.py``). Parameter names inside follow the JAX package's
    parameter tree; ``sample/weights.py`` maps them to and from the
    reference's glow_pytorch names."""

    def __init__(self, spec: FlowSpec, encoder: dict, flow_params: dict):
        super().__init__()
        self.spec = spec
        self.encoder = _module_tree(encoder, "encoder")
        self.flow = _module_tree(flow_params, "flow")

    @classmethod
    def init(cls, spec: FlowSpec, generator: torch.Generator) -> "SeqGlow":
        """Fresh parameters on the CPU from a CPU ``torch.Generator``; move
        them with ``.to(device)``."""
        return cls(spec, encoders.init_feature_encoder(generator, spec.cond),
                   flow.init_flow(generator, spec))


def _frame_numbers(spec: FlowSpec, batch, n_frames: int):
    """[B, N, 1] frame-number conditioning, stepping by 2 per frame and offset
    by 2*start (models.py:540-542,557-558)."""
    base = batch["frame_nb"] + 2.0 * spec.cond.longest_history        # [B, 1]
    steps = 2.0 * torch.arange(n_frames, dtype=base.dtype, device=base.device)
    return base[:, None, :] + steps[None, :, None]


def nll_from_objective(objective):
    """Bits: -(logdet + logp) / ln 2 (models.py:563-565)."""
    return -objective / ops.LN2


def _refuse_plain(spec: FlowSpec, what: str):
    """A spec the JAX package runs on its kernels never takes the plain
    path here."""
    if flow_kernels.jax_envelope(spec):
        raise ValueError(f"the {what} kernels do not take this spec of the JAX "
                         f"kernels' envelope: {spec}")


@functools.lru_cache(maxsize=None)
def training_path(spec: FlowSpec) -> str:
    """'kernels' (the seq_fwd/seq_bwd pair) or 'plain' (``flow.frame_fwd``
    under autograd); decided from the spec and logged once."""
    path = "kernels" if train_kernels.train_supported(spec) else "plain"
    if path == "plain":
        _refuse_plain(spec, "training")
    logger.info("training path for this flow: %s", path)
    return path


def sequence_nll(spec: FlowSpec, params, batch, *, training: bool = False,
                 generator: torch.Generator | None = None,
                 dropout_masks: dict | None = None):
    """Teacher-forced NLL over [B, T, C] sequences (models.py:534-565).

    ``params`` is a ``SeqGlow``; ``batch`` holds the modalities as tensors on
    one device, in float32 (or float64 on the CPU, for a reference).
    ``training`` turns on frame dropout in the encoders, with
    masks from ``dropout_masks`` or drawn from ``generator``
    (``encoders.encode_conditioning``). Returns (z_seq [N, B, C], loss
    scalar, per-frame per-sample losses [N, B]), N = T - longest_history;
    differentiable."""
    x = batch["p1_face"]
    b, t, _ = x.shape
    start = spec.cond.longest_history
    n = t - start
    times = torch.arange(start, t, device=x.device)
    frame_nbs = _frame_numbers(spec, batch, n) if spec.cond.use_frame_nb else None
    cond_all = encoders.encode_conditioning(
        spec.cond, params.encoder, batch, x, times, frame_nbs=frame_nbs,
        training=training, generator=generator, dropout_masks=dropout_masks)
    xs = x[:, start:].transpose(0, 1).contiguous()                 # [N, B, C]
    cond_projs = flow.project_cond_frames(params.flow, cond_all)   # [N, K, B, c]
    states = flow.init_flow_states(spec, b, x.device, x.dtype)

    if training_path(spec) == "kernels":
        z_seq, logdet, _, _ = train_kernels.flow_sequence_fused(
            spec, params.flow, xs, cond_projs.contiguous(), states)
        losses = nll_from_objective(logdet + ops.gaussian_logp(z_seq))
        return z_seq, losses.mean(), losses

    zs, nlls = [], []
    for i in range(n):
        z, logdet, states = flow.frame_fwd(spec, params.flow, xs[i], None,
                                           states, cond_projs=cond_projs[i])
        zs.append(z)
        nlls.append(nll_from_objective(logdet + ops.gaussian_logp(z)))
    losses = torch.stack(nlls)
    return torch.stack(zs), losses.mean(), losses


@functools.lru_cache(maxsize=None)
def sampling_path(spec: FlowSpec) -> str:
    """'sequence' (one launch per sequence), 'frame' (one launch per frame) or
    'plain' (``flow.frame_rev``); decided from the spec and logged once."""
    if flow_kernels.sampling_seq_supported(spec):
        path = "sequence"
    elif flow_kernels.fused_supported(spec):
        path = "frame"
    else:
        _refuse_plain(spec, "sampling")
        path = "plain"
    logger.info("sampling path for this flow: %s", path)
    return path


@torch.no_grad()
def sequence_sample(spec: FlowSpec, params, data, seq_len: int, *,
                    eps_std: float = 1.0, generator: torch.Generator | None = None,
                    z_seq=None, mesh=None):
    """Autoregressive generation (models.py:567-596).

    ``params`` is a ``SeqGlow`` (or anything with ``encoder`` and ``flow``
    trees). ``data`` seeds the own-face history (``p1_face[:, :start]``) and
    provides interlocutor/speech conditioning for ``seq_len`` frames, as
    tensors on one device. ``z_seq`` [N, B, C], when given, is decoded
    instead of a draw of ``randn * eps_std`` from ``generator``. Returns the
    generated frames [B, N, C], N = seq_len - longest_history. ``mesh``
    (``parallel/mesh.py``): every rank generates its rows of the batch, from
    its rows of the latents drawn for the whole batch, and every rank
    returns the whole batch.
    """
    if mesh is not None:
        b, n = data["p1_face"].shape[0], seq_len - spec.cond.longest_history
        rows = mesh.rows(b)
        if z_seq is None:
            z_seq = torch.randn((n, b, spec.channels), generator=generator,
                                device=data["p1_face"].device) * eps_std
        local = sequence_sample(spec, params, shard_batch(mesh, data), seq_len,
                                z_seq=z_seq[:, rows])
        return mesh.all_gather(local)
    x_seed = data["p1_face"]
    dev = x_seed.device
    b, c = x_seed.shape[0], spec.channels
    start = spec.cond.longest_history
    n = seq_len - start
    times = torch.arange(start, seq_len, device=dev)

    frame_nbs = None
    if spec.cond.use_frame_nb:
        if "frame_nb" in data:
            frame_nbs = _frame_numbers(spec, data, n)
        else:
            steps = 2.0 * torch.arange(n, dtype=x_seed.dtype, device=dev)
            frame_nbs = (torch.ones(b, 1, 1, dtype=x_seed.dtype, device=dev)
                         + steps[None, :, None])

    fixed = encoders.encode_fixed_conditioning(
        spec.cond, params.encoder, data, times, frame_nbs=frame_nbs)
    p1_dim = spec.cond.p1_face.out_dim
    fixed_projs, w_p1 = flow.project_cond_split(params.flow, p1_dim, fixed)

    h1 = spec.cond.p1_face.history
    face_hist = x_seed[:, start - h1:start]                        # [B, h1, C]
    states = flow.init_flow_states(spec, b, dev)

    if z_seq is None:
        zs = torch.randn((n, b, c), generator=generator, device=dev) * eps_std
    else:
        zs = z_seq.to(dev, torch.float32).contiguous()

    path = sampling_path(spec)
    if path != "plain":
        weights = flow_kernels.round_sampling_weights(
            spec, flow_kernels.prepare_sampling_weights(spec, params.flow),
            flow_kernels.precision_mode())
    if path == "sequence":
        hist0 = (face_hist.reshape(b, p1_dim).contiguous() if p1_dim
                 else x_seed.new_zeros(b, 0))
        w_p1_t = w_p1.transpose(1, 2).contiguous()
        xs = flow_kernels.sequence_rev_fused(spec, weights, w_p1_t, zs,
                                             fixed_projs, hist0, states)
        return xs.transpose(0, 1)

    xs = []
    for t in range(n):
        proj_t = fixed_projs[t]
        if p1_dim > 0:
            p1_enc = encoders.encode_p1_face_single(spec.cond, params.encoder,
                                                    face_hist)
            proj_t = proj_t + torch.einsum("bd,kcd->kbc", p1_enc, w_p1)
        if path == "frame":
            x_t, states = flow_kernels.frame_rev_fused(
                spec, weights, zs[t], proj_t.contiguous(), states)
        else:
            x_t, _, states = flow.frame_rev(spec, params.flow, zs[t], None,
                                            states, cond_projs=proj_t)
        face_hist = torch.cat([face_hist[:, 1:], x_t[:, None]], dim=1)
        xs.append(x_t)
    return torch.stack(xs, dim=1)


def inversion_route(spec: FlowSpec, device) -> str:
    """'kernel' (``frame_rev_fused`` per frame) for CUDA tensors inside the
    per-frame kernel's envelope, else 'plain' (``flow.frame_rev``): on the
    CPU, or on the card for a spec outside the JAX kernels' envelope. On
    the card a spec of that envelope that the kernels do not take raises,
    as ``sampling_path`` does, rather than run the plain path there."""
    if torch.device(device).type != "cuda":
        return "plain"
    if flow_kernels.fused_supported(spec):
        return "kernel"
    _refuse_plain(spec, "inversion")
    return "plain"


def reverse_logdet_from_states(spec: FlowSpec, weights, flow_params, new_states):
    """The reverse logdet [N, B] of teacher-forced frames from the GRU states
    the flow wrote ([N, K, B, H]): step k's scale is
    ``max(sigmoid(h_k @ out_w_scale_k + out_b_scale_k + 2), eps)`` on the
    folded head (``flow_kernels.fold_output_head``, ``weights`` in the
    kernel spec's lanes), and the logdet is ``-(sum_k sum_c log scale +
    logdet_const)`` over the logical lanes."""
    half = spec.coupling_out_dim // 2
    lo = flow_kernels.kernel_spec(spec).coupling_out_dim // 2
    raw = (torch.einsum("nkbh,khc->nkbc", new_states,
                        weights.out_w_t[:, :, lo:lo + half])
           + weights.out_b[None, :, None, lo:lo + half])
    scale = ops.affine_scale(raw, spec.scale_eps)
    return -(torch.log(scale).sum(dim=(1, 3))
             + train_kernels.logdet_const(spec, flow_params))


@torch.no_grad()
def sequence_invert(spec: FlowSpec, params, z_seq, data, *, route: str | None = None):
    """Teacher-forced decode of stored latents (models.py:617-645): the
    conditioning comes from the ground-truth ``data['p1_face']`` history, not
    the decoded output. ``z_seq`` [N, B, C]. ``route``: 'kernel' or 'plain'
    (default ``inversion_route``); on CPU tensors the kernel route runs the
    kernel's plain version. Returns (reconstruction [B, N, C], backward loss
    scalar: the mean over frames and batch of the NLL in bits)."""
    x = data["p1_face"]
    b = x.shape[0]
    start = spec.cond.longest_history
    n = z_seq.shape[0]
    times = torch.arange(start, start + n, device=x.device)
    frame_nbs = _frame_numbers(spec, data, n) if spec.cond.use_frame_nb else None
    cond_all = encoders.encode_conditioning(spec.cond, params.encoder, data, x,
                                            times, frame_nbs=frame_nbs)
    cond_projs = flow.project_cond_frames(params.flow, cond_all).contiguous()
    states = flow.init_flow_states(spec, b, x.device)
    zs = z_seq.to(x.device, torch.float32).contiguous()              # [N, B, C]
    route = route or inversion_route(spec, x.device)

    xs = []
    if route == "kernel":
        weights = flow_kernels.prepare_sampling_weights(spec, params.flow)
        launched = flow_kernels.round_sampling_weights(
            spec, weights, flow_kernels.precision_mode())
        new_states = []
        for i in range(n):
            x_t, states = flow_kernels.frame_rev_fused(spec, launched, zs[i],
                                                       cond_projs[i], states)
            xs.append(x_t)
            new_states.append(states)
        logdet = reverse_logdet_from_states(spec, weights, params.flow,
                                            torch.stack(new_states))
    elif route == "plain":
        logdets = []
        for i in range(n):
            x_t, ld, states = flow.frame_rev(spec, params.flow, zs[i], None, states,
                                             cond_projs=cond_projs[i])
            xs.append(x_t)
            logdets.append(ld)
        logdet = torch.stack(logdets)
    else:
        raise ValueError(f"route={route!r}: expected 'kernel' or 'plain'")
    losses = nll_from_objective(logdet + ops.gaussian_logp(zs))          # [N, B]
    return torch.stack(xs, dim=1), losses.mean()
