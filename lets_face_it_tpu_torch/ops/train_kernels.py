"""The training kernels of the flow, each beside its plain PyTorch version,
wired as one ``torch.autograd.Function``.

* ``cond_gates``: the conditioning half of every step's GRU input product,
  ``gc[t, k] = leaky_relu(cond[t, k]) @ w_ih_t[k][Z1:] + b_ih[k]`` for all
  frames and steps at once (it does not depend on the serial chain). CUDA
  source ``csrc/cond_gates.cu`` with two plans (``cond_gates_plan``): "tc",
  the tensor-core tile product of ``csrc/gates_mma.cuh`` (TF32 or bf16
  operands; the launcher's at "high" and "medium"), and "simt", a
  register-tiled SIMT GEMM in float32 (the launcher's at "highest");
  replaces that product inside ``lets_face_it_tpu/ops/pallas_train.py``
  ``_fwd_kernel``.
* ``seq_fwd``: the teacher-forced forward of a whole sequence (N frames x K
  steps, the K GRU states kept on chip across frames). It runs
  ``cond_gates`` and then the serial chain, which adds ``gc`` to the Z1 rows
  of the product; it also returns the residuals the backward needs (each
  step's input z, each step's new state, and ``gc``). CUDA source
  ``csrc/seq_fwd.cu``; replaces ``_fwd_kernel``. Two plans
  (``seq_fwd_plan_name``): "walk", one block a tile of rows, and from
  ``HSPLIT_FROM_H`` on (or where a block cannot hold a row's H-wide state
  and 3H-wide weight rows) "hsplit" (``csrc/seq_fwd_hsplit.cu``): a cluster
  of blocks a tile, each owning a slice of the hidden units
  (``seq_fwd_hsplit_ref``: its plain version).
* ``seq_bwd``: the mirror backward. It walks the frames in reverse,
  recomputes each step from the residuals, threads the serial cotangent
  chains (dz within a frame, the K state cotangents across frames) and
  writes each (frame, step)'s local cotangents. CUDA source
  ``csrc/seq_bwd.cu``; replaces ``_bwd_kernel``. Two plans
  (``seq_bwd_plan_name``): "walk", every product of a step inside one
  launch's walk over all frames, and from ``HSPLIT_FROM_H`` on "hsplit"
  (``csrc/seq_bwd_hsplit.cu``): the two products that read w_hh taken off
  the walk as tile products over the whole card (``bwd_gh_ref``,
  ``bwd_dstate_ref``: their plain versions), and each frame's walk shared
  over a cluster by hidden units (``seq_bwd_hsplit_ref``).

The two serial kernels stream each step's weights through a ring of
shared-memory slots shared across a thread-block cluster
(``csrc/flow_stream.cuh``). ``flow_sequence_fused`` runs them as
``_FlowSequence`` (the role of ``_flow_seq_fused``'s custom VJP in the JAX
package): its backward launches ``seq_bwd`` and then forms every weight
gradient and the conditioning gradient as large contractions over frames x
rows (``torch.einsum``, as the JAX package leaves them to XLA). The
gradients on ``TrainWeights`` reach the flow parameters through the
differentiable ``prepare_train_weights``.

Lanes as in ``flow_kernels``: ``flow_sequence_fused`` takes and returns
the logical widths; the weights ``prepare_train_weights`` makes, the
wrappers and the plain versions are in the lanes of
``flow_kernels.kernel_spec`` (the two halves of the coupling split each
padded to a multiple of 4 for a spec of the JAX kernels' envelope), and
the logdet sums the logical lanes' scales only: a padded lane's scale is
sigmoid(2), and its cotangents are zero.

A wrapper runs its plain version (``*_ref``) only when it is given CPU
tensors; given CUDA tensors it launches its kernel or raises. Each wrapper
counts its kernel launches in its ``launches`` attribute (``cond_gates``
also by plan, in ``cond_gates.plans``). The kernels
compute in float32 with fused multiply-adds at a matmul ``precision``
(``flow_kernels.MODES``; None, the default, follows the ambient torch
setting): the operands of the products the JAX kernels mark with
``precision=`` (the GRU input and hidden products, the coupling head, the
1x1, the backward's four cotangent products and the weight-gradient
contractions) are rounded to TF32 ("high") or bf16 ("medium"), float32
sums either way. The wrappers round the weight operands once
(``round_train_weights``), the kernels the activations as they read them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lets_face_it_tpu_torch.core import ops
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import cuda_build
from lets_face_it_tpu_torch.ops.flow_kernels import (HSPLIT_CLUSTERS,
                                                     MAX_SMEM_BYTES,
                                                     _STREAM_CONSUMERS, _check,
                                                     _gru_slice, _least_block,
                                                     _raise_on, _rank_sum,
                                                     _round4, _spec_ints,
                                                     _xchg_floats,
                                                     fold_output_head,
                                                     ambient_matmul_precision,
                                                     hsplit_cluster,
                                                     hsplit_slices,
                                                     kernel_spec, pad_lanes,
                                                     pad_weight,
                                                     precision_mode,
                                                     round_operand,
                                                     unpad_lanes)


class TrainWeights(NamedTuple):
    """Flow weights prepared for the training kernels (float32, contiguous),
    in the lanes of ``kernel_spec``.

    Built by ``prepare_train_weights`` with differentiable ops, so the
    gradients the autograd Function returns for these tensors chain back to
    the flow parameters."""
    w: torch.Tensor         # [K, C, C]      P @ L @ U
    an_bias: torch.Tensor   # [K, C]
    an_scale: torch.Tensor  # [K, C]         exp(actnorm logs)
    w_ih_t: torch.Tensor    # [K, Z1+cond, 3H]  transposed GRU input weights
    w_hh_t: torch.Tensor    # [K, H, 3H]
    b_ih: torch.Tensor      # [K, 3H]
    b_hh: torch.Tensor      # [K, 3H]
    out_w_t: torch.Tensor   # [K, H, Cout]   columns [shift | scale_raw]
    out_b: torch.Tensor     # [K, Cout]      permuted, logscale folded


def prepare_train_weights(spec: FlowSpec, flow_params) -> TrainWeights:
    """W = P L U materialized once per call, exp(logs), the transposed GRU
    weights and the folded coupling head, in the kernel spec's lanes;
    differentiable."""
    if not (spec.rnn_type == "gru" and spec.coupling == "affine"
            and spec.permutation == "invconv"):
        raise ValueError("the training kernels need a GRU, affine, invconv flow")
    out_w, out_b = fold_output_head(flow_params["out"], spec.coupling_out_dim)
    rnn_p = flow_params["rnn"]
    tw = TrainWeights(
        w=ops.invconv_weight(flow_params["perm"]),
        an_bias=flow_params["actnorm"]["bias"],
        an_scale=torch.exp(flow_params["actnorm"]["logs"]),
        w_ih_t=rnn_p["w_ih"].transpose(1, 2),
        w_hh_t=rnn_p["w_hh"].transpose(1, 2),
        b_ih=rnn_p["b_ih"],
        b_hh=rnn_p["b_hh"],
        out_w_t=out_w.transpose(1, 2),
        out_b=out_b,
    )
    return TrainWeights(*(pad_weight(spec, name, t).contiguous()
                          for name, t in tw._asdict().items()))


_TRAIN_PRODUCT_WEIGHTS = ("w", "w_ih_t", "w_hh_t", "out_w_t")


def round_train_weights(tw: TrainWeights, mode: int) -> TrainWeights:
    """The weight operands of the products rounded at matmul precision
    ``mode`` (not differentiable: the autograd Function's gradients reach
    the float32 weights, as a JAX dot's do); biases and actnorm stay
    float32. Rounding is idempotent."""
    if mode == 0:
        return tw
    return tw._replace(**{name: round_operand(getattr(tw, name), mode).contiguous()
                          for name in _TRAIN_PRODUCT_WEIGHTS})


def logdet_const(spec: FlowSpec, flow_params):
    """Data-independent logdet per frame: (sum(actnorm logs) + sum(log|s|))
    * C summed over the K steps (modules.py:62,171 x-C convention)."""
    return (flow_params["actnorm"]["logs"].sum()
            + flow_params["perm"]["log_s"].sum()) * spec.channels


# ---------------------------------------------------------------------------
# Envelope
# ---------------------------------------------------------------------------

# The serial kernels' plans (each a library of its own: the wrappers
# choose), and the H from which both take the hidden split where the walk
# still holds a row. On an H100 (80GB HBM3, 700 W; probe_train_kernels.py
# --quick, B=64, N=56, K = 16, three runs each; PERF.md) the forward's
# serial chain read 7.77-7.79 ms on the hidden split against the walk's
# 11.10-11.18 at H = 256 and 11.97-12.14 against 27.48-27.65 at H = 384; the
# backward 11.95-12.09 against 12.44-12.54 on the split plan it replaced
# (the hidden split's schedule, each walk in one block), 14.90 against
# 16.39-16.44 at H = 384, and 17.7 against 22.4 at C = 54, H = 512. Below
# 256 the walks keep final_model's bits (ROADMAP.md).
SEQ_FWD_PLANS = SEQ_BWD_PLANS = ("walk", "hsplit")
HSPLIT_FROM_H = 256


def serial_smem_bytes(which: str, spec: FlowSpec, plan: str,
                      cs: int | None = None) -> int | None:
    """Least shared memory of a one-row block of the serial kernel
    ``which`` ("seq_fwd" or "seq_bwd") on ``plan`` (the hidden split at a
    cluster of ``cs``, None for ``hsplit_cluster``), in the kernel spec's
    lanes; None where the plan does not take the spec's widths (a product
    wider than 4 columns a consumer thread, no cluster for the split).
    Mirrors csrc/seq_fwd.cu::fwd_other_floats, csrc/seq_bwd.cu::
    bwd_other_floats and csrc/seq_{fwd,bwd}_hsplit.cu's, with
    csrc/flow_stream.cuh::plan_stream."""
    ks = kernel_spec(spec)
    k, c, h = ks.n_steps, ks.channels, ks.hidden_channels
    cout, z1 = ks.coupling_out_dim, ks.z1_dim
    g, half = 3 * h, cout // 2
    if plan == "hsplit":
        cs = cs or hsplit_cluster(ks)
        if cs is None:
            return None
        hs = h // cs
        gs = 3 * hs
        if which == "seq_fwd":
            step = 2 * c + gs + cout + gs + c
            other = (_xchg_floats(cs, cout) + _round4((k + 1) * hs) + _round4(h)
                     + 2 * _round4(c) + 2 * _round4(gs) + _round4(cout) + 2 * step)
            return _least_block(other, max(gs, c, cout))
        step = 2 * c + cout + (6 * hs + c + hs + half + c)
        other = (_xchg_floats(cs, cout) + _xchg_floats(cs, z1) + _round4(k * hs)
                 + 2 * _round4(hs) + 4 * _round4(c) + 2 * _round4(cout)
                 + 2 * _round4(gs) + _round4(z1) + 2 * step)
        return _least_block(other, max(gs, c, cout, hs, z1))
    if g > 4 * _STREAM_CONSUMERS:
        return None
    if which == "seq_fwd":
        step = 2 * c + g + cout + g + c
        other = (_round4(k * h) + 2 * _round4(c) + 2 * _round4(g) + _round4(cout)
                 + 2 * step)
        return _least_block(other, max(g, c, cout))
    step = 2 * c + g + cout + (g + c + h + half + c)
    other = (_round4(k * h) + 2 * _round4(h) + 4 * _round4(c)
             + 2 * _round4(cout) + 4 * _round4(g) + 2 * step)
    return _least_block(other, max(g, c, cout, h, z1))


def _fits(which: str, spec: FlowSpec, plan: str) -> bool:
    need = serial_smem_bytes(which, spec, plan)
    return need is not None and need <= MAX_SMEM_BYTES


def _plan_name(which: str, spec: FlowSpec) -> str:
    """The plan of serial kernel ``which``: the walk below ``HSPLIT_FROM_H``
    where its one-row block fits and its products are at most 4 columns a
    consumer thread wide (3H <= 1536), and where the hidden split has no
    cluster for H; else "hsplit"."""
    ks = kernel_spec(spec)
    if ((ks.hidden_channels < HSPLIT_FROM_H and _fits(which, ks, "walk"))
            or hsplit_cluster(ks) is None):
        return "walk"
    return "hsplit"


def seq_fwd_plan_name(spec: FlowSpec) -> str:
    """The plan ``seq_fwd`` takes (``_plan_name``)."""
    return _plan_name("seq_fwd", spec)


def seq_bwd_plan_name(spec: FlowSpec) -> str:
    """The plan ``seq_bwd`` takes (``_plan_name``)."""
    return _plan_name("seq_bwd", spec)


def train_smem_bytes(spec: FlowSpec, plan: str | None = None) -> int:
    """Least shared memory of a one-row block of the larger of the two
    serial kernels (``serial_smem_bytes``), both on ``plan``; None: each on
    the plan its launcher takes (``seq_fwd_plan_name``,
    ``seq_bwd_plan_name``). A plan that does not take the widths counts as
    above any block."""
    ks = kernel_spec(spec)
    if plan is None:
        plans = (seq_fwd_plan_name(ks), seq_bwd_plan_name(ks))
    else:
        plans = (plan, plan)
    needs = [serial_smem_bytes(which, ks, p)
             for which, p in zip(("seq_fwd", "seq_bwd"), plans)]
    return max(MAX_SMEM_BYTES + 1 if n is None else n for n in needs)


def train_supported(spec: FlowSpec) -> bool:
    """The training kernels' envelope: GRU + affine + invconv flows whose
    product widths (C, Z1, H, 3H, cond, Cout) in the kernel spec's lanes
    are multiples of 4 (16-byte weight loads) and for which each serial
    kernel has a plan whose one-row block fits one block's shared memory.
    Decided from the spec alone; the batch is arbitrary. It holds wherever
    ``flow_kernels.jax_envelope`` does at H up to the hidden split's
    ceiling: 8,192 at final_model's widths and K <= 32, where 3H / 16
    reaches 4 columns a consumer thread."""
    ks = kernel_spec(spec)
    widths = (ks.channels, ks.z1_dim, ks.hidden_channels,
              3 * ks.hidden_channels, ks.cond.cond_dim, ks.coupling_out_dim)
    return (ks.rnn_type == "gru" and ks.coupling == "affine"
            and ks.permutation == "invconv"
            and all(n % 4 == 0 for n in widths)
            and train_smem_bytes(ks) <= MAX_SMEM_BYTES)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _rounded(mode: int):
    """The operand rounding of matmul precision ``mode``."""
    return lambda x: round_operand(x, mode)


def cond_gates_ref(spec: FlowSpec, tw: TrainWeights, cond_seq, mode: int = 0):
    """Plain version of ``cond_gates``: cond_seq [N, K, B, cond] ->
    leaky_relu(cond_seq) @ w_ih_t[:, Z1:] + b_ih, [N, K, B, 3H], at matmul
    precision ``mode``."""
    rnd = _rounded(mode)
    w_c = rnd(tw.w_ih_t[:, spec.z1_dim:])
    gc = torch.einsum("nkbi,kig->nkbg", rnd(ops.leaky_relu(cond_seq)), w_c)
    return (gc + tw.b_ih[None, :, None, :]).contiguous()


def _recompute_step(spec: FlowSpec, tw: TrainWeights, k: int, z, gc_k, h_prev,
                    mode: int = 0):
    """One forward step on prepared weights (rounded for ``mode``), the
    conditioning gates gc_k given -> (zb, gi, gh, r, u, n, h_new, hout,
    sig, scale)."""
    rnd = _rounded(mode)
    hd, z1d, half = spec.hidden_channels, spec.z1_dim, spec.coupling_out_dim // 2
    za = (z + tw.an_bias[k]) * tw.an_scale[k]
    zb = rnd(za) @ tw.w[k]
    gi = rnd(zb[:, :z1d]) @ tw.w_ih_t[k, :z1d] + gc_k
    gh = rnd(h_prev) @ tw.w_hh_t[k] + tw.b_hh[k]
    r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
    u = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = torch.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
    h_new = (1.0 - u) * n + u * h_prev
    hout = rnd(h_new) @ tw.out_w_t[k] + tw.out_b[k]
    sig = torch.sigmoid(hout[:, half:] + 2.0)
    scale = torch.clamp(sig, min=spec.scale_eps)
    return zb, gi, gh, r, u, n, h_new, hout, sig, scale


def seq_fwd_ref(spec: FlowSpec, tw: TrainWeights, xs, cond_seq, states0,
                mode: int = 0):
    """Plain version of ``seq_fwd``: ``cond_gates_ref``, then loops over t
    and k, at matmul precision ``mode``."""
    n_frames, b, c = xs.shape
    k_steps, z1d, half = spec.n_steps, spec.z1_dim, spec.coupling_out_dim // 2
    tw = round_train_weights(tw, mode)
    gc = cond_gates_ref(spec, tw, cond_seq, mode)
    z_seq = torch.empty_like(xs)
    scales = xs.new_empty((n_frames, k_steps, b, half))
    zs_res = xs.new_empty((n_frames, k_steps, b, c))
    states_res = xs.new_empty((n_frames,) + tuple(states0.shape))
    states = states0.clone()
    for t in range(n_frames):
        z = xs[t]
        for k in range(k_steps):
            zs_res[t, k] = z
            zb, *_, h_new, hout, _, scale = _recompute_step(
                spec, tw, k, z, gc[t, k], states[k], mode)
            states[k] = h_new
            states_res[t, k] = h_new
            scales[t, k] = scale
            z = torch.cat([zb[:, :z1d], (zb[:, z1d:] + hout[:, :half]) * scale],
                          dim=-1)
        z_seq[t] = z
    return z_seq, scales, zs_res, states_res, gc


def _bwd_step(spec: FlowSpec, tw: TrainWeights, k: int, z, gc_k, h_prev, dz,
              dscale_k, dstate_k, mode: int):
    """One step of the backward walk on prepared weights: the step
    recomputed (``_recompute_step``), then its cotangents -> (dz of the
    step's input, dgi, dgh, dghn, dhout, dzb, dh * u); the state cotangent
    of the frame before is dh * u + dgh @ w_hh_t[k]^T."""
    rnd = _rounded(mode)
    hd, z1d, half = spec.hidden_channels, spec.z1_dim, spec.coupling_out_dim // 2
    zb, gi, gh, r, u, n, _, hout, sig, scale = _recompute_step(
        spec, tw, k, z, gc_k, h_prev, mode)
    dz2p = dz[:, z1d:]
    dscale = dz2p * (zb[:, z1d:] + hout[:, :half]) + dscale_k
    dsraw = torch.where(sig > spec.scale_eps, dscale, 0.0) * sig * (1.0 - sig)
    dhout = torch.cat([dz2p * scale, dsraw], dim=-1)
    dh_new = rnd(dhout) @ tw.out_w_t[k].T + dstate_k
    du = dh_new * (h_prev - n)
    dgn = dh_new * (1.0 - u) * (1.0 - n * n)
    dghn = dgn * r
    dgr = dgn * gh[:, 2 * hd:] * r * (1.0 - r)
    dgu = du * u * (1.0 - u)
    dgi = torch.cat([dgr, dgu, dgn], dim=-1)
    dgh = torch.cat([dgr, dgu, dghn], dim=-1)
    dz1 = dz[:, :z1d] + rnd(dgi) @ tw.w_ih_t[k, :z1d].T
    dzb = torch.cat([dz1, dz2p * scale], dim=-1)
    dz_in = (rnd(dzb) @ tw.w[k].T) * tw.an_scale[k]
    return dz_in, dgi, dgh, dghn, dhout, dzb, dh_new * u


def _bwd_outputs(spec: FlowSpec, dz_seq):
    n_frames, b, c = dz_seq.shape
    k_steps, hd = spec.n_steps, spec.hidden_channels
    return (torch.empty_like(dz_seq),
            dz_seq.new_empty((n_frames, k_steps, b, 3 * hd)),
            dz_seq.new_empty((n_frames, k_steps, b, hd)),
            dz_seq.new_empty((n_frames, k_steps, b, spec.coupling_out_dim)),
            dz_seq.new_empty((n_frames, k_steps, b, c)))


def seq_bwd_ref(spec: FlowSpec, tw: TrainWeights, gc, zs_res, hprev_all,
                dz_seq, dscales, dnew_states, mode: int = 0):
    """Plain version of ``seq_bwd``'s walk plan: loops over t and k in
    reverse, every product of a step inside the loop, at matmul precision
    ``mode``."""
    tw = round_train_weights(tw, mode)
    rnd = _rounded(mode)
    dx, dgi_all, dghn_all, dhout_all, dzb_all = _bwd_outputs(spec, dz_seq)
    dstates = dnew_states.clone()
    for t in reversed(range(dz_seq.shape[0])):
        dz = dz_seq[t]
        for k in reversed(range(spec.n_steps)):
            dz, dgi, dgh, dghn, dhout, dzb, dhu = _bwd_step(
                spec, tw, k, zs_res[t, k], gc[t, k], hprev_all[t, k], dz,
                dscales[t, k], dstates[k], mode)
            dstates[k] = dhu + rnd(dgh) @ tw.w_hh_t[k].T
            dgi_all[t, k], dghn_all[t, k] = dgi, dghn
            dhout_all[t, k], dzb_all[t, k] = dhout, dzb
        dx[t] = dz
    return dx, dstates, dgi_all, dghn_all, dhout_all, dzb_all


def bwd_gh_ref(tw: TrainWeights, hprev_all, mode: int = 0):
    """Plain version of the hidden split's first product
    (csrc/bwd_split.cuh::bwd_gh): the hidden gates of every frame and step,
    hprev_all [N, K, B, H] -> gh [N, K, B, 3H] = hprev @ w_hh_t[k] +
    b_hh[k], on weights rounded for ``mode``."""
    gh = torch.einsum("nkbh,khg->nkbg", round_operand(hprev_all, mode), tw.w_hh_t)
    return gh + tw.b_hh[None, :, None, :]


def bwd_dstate_ref(tw: TrainWeights, dgh, dhu, mode: int = 0):
    """Plain version of the hidden split's per-frame product
    (csrc/bwd_split.cuh::bwd_dstate): the state cotangents of the frame
    before, dgh [K, B, 3H], dhu [K, B, H] -> dhu + dgh @ w_hh_t[k]^T,
    [K, B, H], on weights rounded for ``mode``."""
    return dhu + torch.einsum("kbg,khg->kbh", round_operand(dgh, mode), tw.w_hh_t)


# The hidden split's cluster of the plain versions when the caller names
# none (a plain version gives the same function at any cluster; only the
# order of the sums over the cluster moves).
HSPLIT_REF_CLUSTER = 4


def _hsplit_head(spec: FlowSpec, tw: TrainWeights, k: int, h_parts):
    """The coupling head of the hidden split: each block's partial
    h[:, U_r] @ out_w_t[k][U_r], summed over the cluster in rank order, then
    out_b -> (hout, sig, scale)."""
    half = spec.coupling_out_dim // 2
    hout = tw.out_b[k] + _rank_sum(h_parts)
    sig = torch.sigmoid(hout[:, half:] + 2.0)
    return hout, sig, torch.clamp(sig, min=spec.scale_eps)


def seq_fwd_hsplit_ref(spec: FlowSpec, tw: TrainWeights, xs, cond_seq, states0,
                       mode: int = 0, cs: int = HSPLIT_REF_CLUSTER):
    """Plain version of ``seq_fwd``'s hidden split over a cluster of
    ``cs`` (csrc/seq_fwd_hsplit.cu), the same function as ``seq_fwd_ref``:
    each rank's gate columns of gh and gi and the GRU of its units from the
    whole previous state, its partial of the coupling head, the partials
    summed in rank order; at matmul precision ``mode``."""
    n_frames, b, c = xs.shape
    k_steps, z1d, h = spec.n_steps, spec.z1_dim, spec.hidden_channels
    half, hs = spec.coupling_out_dim // 2, h // cs
    tw = round_train_weights(tw, mode)
    rnd = _rounded(mode)
    units, cols = hsplit_slices(h, cs)
    gc = cond_gates_ref(spec, tw, cond_seq, mode)
    z_seq = torch.empty_like(xs)
    scales = xs.new_empty((n_frames, k_steps, b, half))
    zs_res = xs.new_empty((n_frames, k_steps, b, c))
    states_res = xs.new_empty((n_frames,) + tuple(states0.shape))
    states = states0.clone()
    for t in range(n_frames):
        z = xs[t]
        for k in range(k_steps):
            zs_res[t, k] = z
            zb = rnd((z + tw.an_bias[k]) * tw.an_scale[k]) @ tw.w[k]
            h_prev, h_new, parts = rnd(states[k]), torch.empty_like(states[k]), []
            for u, g in zip(units, cols):
                gh = h_prev @ tw.w_hh_t[k][:, g] + tw.b_hh[k][g]
                gi = rnd(zb[:, :z1d]) @ tw.w_ih_t[k, :z1d][:, g] + gc[t, k][:, g]
                h_new[:, u] = _gru_slice(gi, gh, states[k][:, u], hs)[3]
                parts.append(rnd(h_new[:, u]) @ tw.out_w_t[k][u])
            hout, _, scale = _hsplit_head(spec, tw, k, parts)
            states[k] = h_new
            states_res[t, k] = h_new
            scales[t, k] = scale
            z = torch.cat([zb[:, :z1d], (zb[:, z1d:] + hout[:, :half]) * scale],
                          dim=-1)
        z_seq[t] = z
    return z_seq, scales, zs_res, states_res, gc


def seq_bwd_hsplit_ref(spec: FlowSpec, tw: TrainWeights, gc, zs_res, hprev_all,
                       dz_seq, dscales, dnew_states, mode: int = 0,
                       cs: int = HSPLIT_REF_CLUSTER):
    """Plain version of ``seq_bwd``'s hidden split over a cluster of ``cs``
    (csrc/seq_bwd_hsplit.cu), the same function as ``seq_bwd_ref``: the
    hidden gates of every frame and step first (``bwd_gh_ref``), each
    frame's state cotangents for the frame before after it
    (``bwd_dstate_ref``), each step's walk by rank: the coupling head's
    partials and the partials of dgi @ w_ih[:, :Z1] summed in rank order,
    the rest of each rank's units and gate columns its own."""
    k_steps, z1d, h = spec.n_steps, spec.z1_dim, spec.hidden_channels
    half, hs = spec.coupling_out_dim // 2, h // cs
    tw = round_train_weights(tw, mode)
    rnd = _rounded(mode)
    units, cols = hsplit_slices(h, cs)
    dx, dgi_all, dghn_all, dhout_all, dzb_all = _bwd_outputs(spec, dz_seq)
    gh_all = bwd_gh_ref(tw, hprev_all, mode)
    dstates = dnew_states.clone()
    dgh_t = torch.empty_like(gh_all[0])
    dhu_t = torch.empty_like(dstates)
    for t in reversed(range(dz_seq.shape[0])):
        dz = dz_seq[t]
        for k in reversed(range(k_steps)):
            h_prev, gh_tk = hprev_all[t, k], gh_all[t, k]
            zb = rnd((zs_res[t, k] + tw.an_bias[k]) * tw.an_scale[k]) @ tw.w[k]
            gates, parts = [], []
            for u, g in zip(units, cols):
                gi = rnd(zb[:, :z1d]) @ tw.w_ih_t[k, :z1d][:, g] + gc[t, k][:, g]
                r_, u_, n_, h_new = _gru_slice(gi, gh_tk[:, g], h_prev[:, u], hs)
                gates.append((r_, u_, n_))
                parts.append(rnd(h_new) @ tw.out_w_t[k][u])
            hout, sig, scale = _hsplit_head(spec, tw, k, parts)
            dz2p = dz[:, z1d:]
            dscale = dz2p * (zb[:, z1d:] + hout[:, :half]) + dscales[t, k]
            dsraw = torch.where(sig > spec.scale_eps, dscale, 0.0) * sig * (1.0 - sig)
            dhout = torch.cat([dz2p * scale, dsraw], dim=-1)
            dgi, dghn = torch.empty_like(gh_tk), torch.empty_like(h_prev)
            z_parts = []
            for (r_, u_, n_), u, g in zip(gates, units, cols):
                dh = rnd(dhout) @ tw.out_w_t[k][u].T + dstates[k][:, u]
                dgn = dh * (1.0 - u_) * (1.0 - n_ * n_)
                dgr = dgn * gh_tk[:, g][:, 2 * hs:] * r_ * (1.0 - r_)
                dgu = dh * (h_prev[:, u] - n_) * u_ * (1.0 - u_)
                dgi[:, g] = torch.cat([dgr, dgu, dgn], dim=-1)
                dgh_t[k][:, g] = torch.cat([dgr, dgu, dgn * r_], dim=-1)
                dghn[:, u] = dgn * r_
                dhu_t[k][:, u] = dh * u_
                z_parts.append(rnd(dgi[:, g]) @ tw.w_ih_t[k, :z1d][:, g].T)
            dzb = torch.cat([dz[:, :z1d] + _rank_sum(z_parts), dz2p * scale], dim=-1)
            dz = (rnd(dzb) @ tw.w[k].T) * tw.an_scale[k]
            dgi_all[t, k], dghn_all[t, k] = dgi, dghn
            dhout_all[t, k], dzb_all[t, k] = dhout, dzb
        dx[t] = dz
        dstates = bwd_dstate_ref(tw, dgh_t, dhu_t, mode)
    return dx, dstates, dgi_all, dghn_all, dhout_all, dzb_all


# The per-block layouts each hidden-split kernel reads.
HSPLIT_PARTS = {"seq_fwd": ("w_hh", "w_ih"), "seq_bwd": ("w_ih", "out_w", "w_ih_z1")}


def hsplit_weights(spec: FlowSpec, tw: TrainWeights, cs: int,
                   parts=("w_hh", "w_ih", "out_w", "w_ih_z1")) -> dict:
    """The hidden split's per-block weight layouts (csrc/hsplit.cuh::
    HsplitWeights) named in ``parts``, rank r's contiguous: w_hh [K, cs, H,
    3hs] (w_hh_t's G_r columns), w_ih [K, cs, Z1, 3hs] (w_ih_t[:, :Z1]'s),
    out_w [K, cs, Cout, hs] (out_w_t's U_r rows, transposed) and w_ih_z1
    [K, cs, 3hs, Z1] (w_ih's G_r columns, transposed), from weights already
    rounded for the launch's mode."""
    k, h, z1 = spec.n_steps, spec.hidden_channels, spec.z1_dim
    hs = h // cs

    def by_rank(t):   # [K, IN, 3H] -> [K, cs, IN, 3hs]
        return t.unflatten(-1, (3, cs, hs)).permute(0, 3, 1, 2, 4).reshape(
            k, cs, t.shape[1], 3 * hs)

    make = {"w_hh": lambda: by_rank(tw.w_hh_t),
            "w_ih": lambda: by_rank(tw.w_ih_t[:, :z1]),
            "out_w": lambda: tw.out_w_t.unflatten(1, (cs, hs)).transpose(2, 3),
            "w_ih_z1": lambda: by_rank(tw.w_ih_t[:, :z1]).transpose(2, 3)}
    return {name: make[name]().contiguous() for name in parts}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _gates_fn():
    fn = cuda_build.load("cond_gates").cond_gates_launch
    fn.argtypes = [_P] * 4 + [_I] * 9 + [_P] * 2
    fn.restype = _I
    return fn


# csrc/cond_gates.cu: the plans and their tiles. "simt": the register-tiled
# GEMM, (depth of a staged tile, stages; the first the original, depth 8
# through registers, two buffers); "tc": the tensor-core tile product of
# csrc/gates_mma.cuh, (rows, columns, warp tile rows, columns, stages).
COND_GATES_TILES = {
    "simt": ((8, 2), (16, 3), (16, 4)),
    "tc": ((128, 128, 32, 64, 3), (128, 128, 64, 32, 3), (128, 128, 32, 64, 4),
           (256, 128, 64, 64, 3)),
}
COND_GATES_PLANS = tuple(COND_GATES_TILES)
_COND_PLAN_CODES = {"simt": 1, "tc": 2}


def cond_gates_plan(mode: int) -> tuple[str, int]:
    """The plan and tile ``cond_gates``' launcher takes at matmul precision
    ``mode`` (csrc/cond_gates.cu::cond_gates_plan): at "highest" the SIMT
    GEMM, whose float32 FMA chains give the plain version's bits, at "high"
    and "medium" the tensor cores (TF32 or bf16 operands). Either takes
    every width of ``train_supported`` (the tiles zero-fill their edges)."""
    return ("simt", 2) if mode == 0 else ("tc", 0)


def _cond_plan_arg(plan: str | None, tile: int | None) -> tuple[int, int]:
    """csrc/cond_gates.cu's (``plan``, ``tile``) for a wrapper's request."""
    if plan is None and tile is None:
        return 0, -1
    if plan in COND_GATES_TILES and (tile is None
                                     or 0 <= tile < len(COND_GATES_TILES[plan])):
        return _COND_PLAN_CODES[plan], -1 if tile is None else tile
    raise ValueError(f"cond_gates: no plan {plan!r} with tile {tile!r}; "
                     f"plans {', '.join(COND_GATES_PLANS)}")


@functools.cache
def _fwd_fn():
    fn = cuda_build.load("seq_fwd").seq_fwd_launch
    fn.argtypes = [_P] * 16 + [_I] * 8 + [ctypes.c_float] + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_fn():
    fn = cuda_build.load("seq_bwd").seq_bwd_launch
    fn.argtypes = [_P] * 25 + [_I] * 8 + [ctypes.c_float] + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _fwd_hs_fn():
    fn = cuda_build.load("seq_fwd_hsplit").seq_fwd_hsplit_launch
    fn.argtypes = [_P] * 15 + [_I] * 8 + [ctypes.c_float] + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_hs_fn():
    fn = cuda_build.load("seq_bwd_hsplit").seq_bwd_hsplit_launch
    fn.argtypes = [_P] * 28 + [_I] * 8 + [ctypes.c_float] + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


PLAN_KEYS = ("rows_per_block", "cluster", "blocks", "slots", "slot_bytes",
             "partial_bytes", "smem_bytes", "max_active_clusters")


def serial_plan(which: str, spec: FlowSpec, b: int, tile=(0, 0, 0),
                plan: str | None = None) -> dict:
    """The launch plan of ``seq_fwd``'s or ``seq_bwd``'s serial kernel
    (``which``) for B=b rows on the current CUDA device, with the cluster
    occupancy the device allows (``cudaOccupancyMaxActiveClusters``);
    ``tile`` as in ``seq_fwd``; ``plan`` as the kernel's wrapper takes it
    (None: its launcher's, ``seq_fwd_plan_name`` / ``seq_bwd_plan_name``),
    and its "plan" key the one planned (for "hsplit" the walk's launch:
    "cluster" the blocks sharing a tile's rows)."""
    bwd = which == "seq_bwd"
    ks = kernel_spec(spec)
    name = plan or (seq_bwd_plan_name if bwd else seq_fwd_plan_name)(ks)
    out = (ctypes.c_int * len(PLAN_KEYS))()
    lib = f"{which}_hsplit" if name == "hsplit" else which
    fn = getattr(cuda_build.load(lib), f"{lib}_plan")
    fn.argtypes = [_I] * 10 + [_P]
    fn.restype = _I
    _raise_on(fn(b, *_spec_ints(ks), *tile, ctypes.addressof(out)), f"{which} plan")
    got = dict(zip(PLAN_KEYS, out))
    got["plan"] = name
    return got


def _plan_arg(which: str, plan: str | None, plans) -> str | None:
    if plan is None or plan in plans:
        return plan
    raise ValueError(f"{which}: no plan {plan!r}; plans {', '.join(plans)}")


_HSPLIT_CLUSTER: dict = {}


def _hsplit_cluster(which: str, spec: FlowSpec, b: int, tile) -> int:
    """The cluster of the hidden split's plan for a launch of B=b rows and
    ``tile`` on the current device (the wrapper lays the weights out by it
    before the launch), asked of the launcher once per shape; the launch
    passes the same request, and its planner's memo answers both."""
    key = (which, _spec_ints(spec), b, tuple(tile), torch.cuda.current_device())
    if key not in _HSPLIT_CLUSTER:
        _HSPLIT_CLUSTER[key] = serial_plan(which, spec, b, tile, "hsplit")["cluster"]
    return _HSPLIT_CLUSTER[key]


def _check_weights(spec: FlowSpec, tw: TrainWeights, device):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    cout, ind = spec.coupling_out_dim, spec.z1_dim + spec.cond.cond_dim
    shapes = {"w": (k, c, c), "an_bias": (k, c), "an_scale": (k, c),
              "w_ih_t": (k, ind, 3 * h), "w_hh_t": (k, h, 3 * h),
              "b_ih": (k, 3 * h), "b_hh": (k, 3 * h), "out_w_t": (k, h, cout),
              "out_b": (k, cout)}
    for name, shape in shapes.items():
        _check(name, getattr(tw, name), shape, device)


def _dispatch(spec: FlowSpec, precision, device) -> tuple[bool, int]:
    """(whether the kernel is to be launched (False for the plain version,
    CPU tensors), the matmul precision's mode); raises for an unknown
    precision, outside the envelope or on another device. The wrappers
    below take every tensor in the kernel spec's lanes."""
    mode = precision_mode(precision)
    if not train_supported(spec):
        raise ValueError("spec is outside the training kernels' envelope")
    if device.type == "cpu":
        return False, mode
    if device.type != "cuda":
        raise ValueError(f"no training kernel for device {device}")
    return True, mode


def cond_gates(spec: FlowSpec, tw: TrainWeights, cond_seq, *,
               precision: str | None = None, plan: str | None = None,
               tile: int | None = None):
    """Conditioning gates of every frame and step: cond_seq [N, K, B, cond]
    (pre-activation projections) -> gc [N, K, B, 3H]. ``precision``: a name
    of ``flow_kernels.MODES``, or None for the ambient one; ``plan``: "tc"
    or "simt", None for the launcher's (``cond_gates_plan``); ``tile``
    indexes the plan's ``COND_GATES_TILES``, None for its first."""
    launch, mode = _dispatch(spec, precision, cond_seq.device)
    plan_arg = _cond_plan_arg(plan, tile)
    spec = kernel_spec(spec)
    if not launch:
        return cond_gates_ref(spec, tw, cond_seq, mode)
    n, k, b, cond = cond_seq.shape
    dev = cond_seq.device
    _check("cond_seq", cond_seq, (n, spec.n_steps, b, spec.cond.cond_dim), dev)
    _check_weights(spec, tw, dev)
    tw = round_train_weights(tw, mode)
    gc = cond_seq.new_empty((n, k, b, 3 * spec.hidden_channels))
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    err = _gates_fn()(cond_seq.data_ptr(), tw.w_ih_t.data_ptr(),
                      tw.b_ih.data_ptr(), gc.data_ptr(), b, n, k, spec.z1_dim,
                      cond, spec.hidden_channels, mode, *plan_arg, stream,
                      ctypes.addressof(launched))
    _raise_on(err, "cond_gates")
    cond_gates.launches += 1
    cond_gates.plans["tc" if launched.value == _COND_PLAN_CODES["tc"] else "simt"] += 1
    return gc


cond_gates.launches = 0
cond_gates.plans = dict.fromkeys(COND_GATES_PLANS, 0)


def seq_fwd(spec: FlowSpec, tw: TrainWeights, xs, cond_seq, states0, *,
            precision: str | None = None, tile=(0, 0, 0), plan: str | None = None):
    """Teacher-forced forward: xs [N, B, C], cond_seq [N, K, B, cond]
    (pre-activation projections), states0 [K, B, H] -> (z_seq [N, B, C],
    scales [N, K, B, Cout/2], zs_res [N, K, B, C], states_res [N, K, B, H],
    gc [N, K, B, 3H]): ``cond_gates``, then ``seq_fwd_serial``. ``plan``:
    "walk" or "hsplit", None for the launcher's (``seq_fwd_plan_name``; on
    CPU tensors the plan's plain version, ``seq_fwd_ref`` or
    ``seq_fwd_hsplit_ref`` at the cluster of ``tile`` or
    ``HSPLIT_REF_CLUSTER``)."""
    launch, mode = _dispatch(spec, precision, xs.device)
    plan = _plan_arg("seq_fwd", plan, SEQ_FWD_PLANS)
    spec = kernel_spec(spec)
    if not launch:
        if (plan or seq_fwd_plan_name(spec)) == "hsplit":
            return seq_fwd_hsplit_ref(spec, tw, xs, cond_seq, states0, mode,
                                      tile[1] or HSPLIT_REF_CLUSTER)
        return seq_fwd_ref(spec, tw, xs, cond_seq, states0, mode)
    tw = round_train_weights(tw, mode)
    gc = cond_gates(spec, tw, cond_seq, precision=precision)
    return (*seq_fwd_serial(spec, tw, xs, gc, states0, precision=precision,
                            tile=tile, plan=plan), gc)


def seq_fwd_serial(spec: FlowSpec, tw: TrainWeights, xs, gc, states0, *,
                   precision: str | None = None, tile=(0, 0, 0),
                   plan: str | None = None):
    """The serial chain of ``seq_fwd`` on CUDA tensors, the conditioning
    gates gc [N, K, B, 3H] given -> (z_seq, scales, zs_res, states_res).
    ``tile`` = (rows per block, blocks per cluster, ring slots), 0 for the
    launcher's plan; ``plan`` as in ``seq_fwd``. Counts its launches in
    ``seq_fwd.launches`` and by plan in ``seq_fwd.plans``."""
    launch, mode = _dispatch(spec, precision, xs.device)
    plan = _plan_arg("seq_fwd", plan, SEQ_FWD_PLANS)
    spec = kernel_spec(spec)
    if not launch:
        raise ValueError("seq_fwd_serial runs on CUDA tensors only")
    plan = plan or seq_fwd_plan_name(spec)
    n, b, c = xs.shape
    k, _, _, _, h, cout = _spec_ints(spec)
    dev = xs.device
    _check("xs", xs, (n, b, c), dev)
    _check("gc", gc, (n, k, b, 3 * h), dev)
    _check("states0", states0, (k, b, h), dev)
    _check_weights(spec, tw, dev)
    tw = round_train_weights(tw, mode)
    z_seq = torch.empty_like(xs)
    scales = xs.new_empty((n, k, b, cout // 2))
    zs_res = xs.new_empty((n, k, b, c))
    states_res = xs.new_empty((n, k, b, h))
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = (xs.data_ptr(), gc.data_ptr(), states0.data_ptr(), z_seq.data_ptr(),
            scales.data_ptr(), zs_res.data_ptr(), states_res.data_ptr())
    if plan == "hsplit":
        cs = _hsplit_cluster("seq_fwd", spec, b, tile)
        hw = hsplit_weights(spec, tw, cs, HSPLIT_PARTS["seq_fwd"])
        err = _fwd_hs_fn()(*outs, *(t.data_ptr() for t in (
                               tw.w, tw.an_bias, tw.an_scale, tw.b_hh, tw.out_w_t,
                               tw.out_b, hw["w_hh"], hw["w_ih"])),
                           b, n, *_spec_ints(spec), float(spec.scale_eps), *tile,
                           cs, mode, stream)
    else:
        err = _fwd_fn()(*outs, *(t.data_ptr() for t in tw),
                        b, n, *_spec_ints(spec), float(spec.scale_eps), *tile,
                        mode, stream)
    _raise_on(err, "seq_fwd")
    seq_fwd.launches += 1
    seq_fwd.plans[plan] += 1
    return z_seq, scales, zs_res, states_res


seq_fwd.launches = 0
seq_fwd.plans = dict.fromkeys(SEQ_FWD_PLANS, 0)


def seq_bwd(spec: FlowSpec, tw: TrainWeights, gc, zs_res, hprev_all,
            dz_seq, dscales, dnew_states, *, precision: str | None = None,
            tile=(0, 0, 0), plan: str | None = None):
    """Mirror backward: the residuals gc [N, K, B, 3H] (``seq_fwd``'s
    conditioning gates), zs_res [N, K, B, C] and hprev_all [N, K, B, H]
    (each step's previous state), the cotangents dz_seq [N, B, C], dscales
    [N, K, B, Cout/2] and dnew_states [K, B, H] -> (dx [N, B, C], dstates0
    [K, B, H], dgi [N, K, B, 3H], dghn [N, K, B, H], dhout [N, K, B, Cout],
    dzb [N, K, B, C]). ``tile`` as in ``seq_fwd``; ``plan``: "walk" or
    "hsplit", None for the launcher's (``seq_bwd_plan_name``; on CPU
    tensors the plan's plain version, ``seq_bwd_ref`` or
    ``seq_bwd_hsplit_ref`` at the cluster of ``tile`` or
    ``HSPLIT_REF_CLUSTER``). Counts its calls in
    ``seq_bwd.launches`` and by plan in ``seq_bwd.plans``."""
    launch, mode = _dispatch(spec, precision, dz_seq.device)
    plan = _plan_arg("seq_bwd", plan, SEQ_BWD_PLANS)
    spec = kernel_spec(spec)
    name = plan or seq_bwd_plan_name(spec)
    if not launch:
        args = (spec, tw, gc, zs_res, hprev_all, dz_seq, dscales, dnew_states, mode)
        if name == "hsplit":
            return seq_bwd_hsplit_ref(*args, tile[1] or HSPLIT_REF_CLUSTER)
        return seq_bwd_ref(*args)
    n, b, c = dz_seq.shape
    k, _, z1, _, h, cout = _spec_ints(spec)
    dev = dz_seq.device
    for arg, t, shape in (("dz_seq", dz_seq, (n, b, c)),
                          ("dscales", dscales, (n, k, b, cout // 2)),
                          ("zs_res", zs_res, (n, k, b, c)),
                          ("hprev_all", hprev_all, (n, k, b, h)),
                          ("dnew_states", dnew_states, (k, b, h)),
                          ("gc", gc, (n, k, b, 3 * h))):
        _check(arg, t, shape, dev)
    _check_weights(spec, tw, dev)
    tw = round_train_weights(tw, mode)
    # the backward products read the transposed weights row by row (the
    # hidden split W's and w_hh's; its others are laid out by block)
    transposed = (tw.w, tw.w_hh_t) + ((tw.w_ih_t[:, :z1], tw.out_w_t)
                                       if name == "walk" else ())
    transposed = [t.transpose(1, 2).contiguous() for t in transposed]
    dx = torch.empty_like(dz_seq)
    dstates0 = torch.empty_like(dnew_states)
    dgi = dz_seq.new_empty((n, k, b, 3 * h))
    dghn = dz_seq.new_empty((n, k, b, h))
    dhout = dz_seq.new_empty((n, k, b, cout))
    dzb = dz_seq.new_empty((n, k, b, c))
    stream = torch.cuda.current_stream(dev).cuda_stream
    io = (dz_seq.data_ptr(), dscales.data_ptr(), zs_res.data_ptr(),
          hprev_all.data_ptr(), dnew_states.data_ptr(), gc.data_ptr(),
          dx.data_ptr(), dstates0.data_ptr(), dgi.data_ptr(), dghn.data_ptr(),
          dhout.data_ptr(), dzb.data_ptr())
    if name == "hsplit":
        cs = _hsplit_cluster("seq_bwd", spec, b, tile)
        hw = hsplit_weights(spec, tw, cs, HSPLIT_PARTS["seq_bwd"])
        # its scratch: gh of every frame and step, a frame's dgh, dh * u and
        # state cotangents
        scratch = (gc.new_empty(gc.shape), gc.new_empty((k, b, 3 * h)),
                   dnew_states.new_empty((k, b, h)), dnew_states.new_empty((k, b, h)))
        err = _bwd_hs_fn()(*io, *(t.data_ptr() for t in (
                               tw.w, tw.an_bias, tw.an_scale, tw.w_hh_t, tw.b_hh,
                               tw.out_w_t, tw.out_b, *transposed, hw["w_ih"],
                               hw["out_w"], hw["w_ih_z1"], *scratch)),
                           b, n, *_spec_ints(spec), float(spec.scale_eps), *tile,
                           cs, mode, stream)
    else:
        err = _bwd_fn()(*io, *(t.data_ptr() for t in tw),
                        *(t.data_ptr() for t in transposed),
                        b, n, *_spec_ints(spec), float(spec.scale_eps), *tile,
                        mode, stream)
    _raise_on(err, "seq_bwd")
    seq_bwd.launches += 1
    seq_bwd.plans[name] += 1
    return dx, dstates0, dgi, dghn, dhout, dzb


seq_bwd.launches = 0
seq_bwd.plans = dict.fromkeys(SEQ_BWD_PLANS, 0)


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

def flow_sequence_vjp(spec: FlowSpec, tw: TrainWeights, cond_seq, gc, states0,
                      zs_res, states_res, dz_seq, dscales, dnew_states, *,
                      precision: str | None = None):
    """Cotangents of (z_seq, scales, new_states) -> gradients on
    (TrainWeights..., xs, cond_seq, states0): ``seq_bwd`` for the serial
    chains, then the weight gradients as contractions over frames x rows
    (pallas_train.py:554-602), every operand of them rounded at the matmul
    precision as the JAX package's einsums take it; in the kernel spec's
    lanes."""
    spec = kernel_spec(spec)
    z1d, h = spec.z1_dim, spec.hidden_channels
    mode = precision_mode(precision)
    tw = round_train_weights(tw, mode)
    rnd = _rounded(mode)
    hprev_all = torch.cat([states0[None], states_res[:-1]], dim=0)
    dx, dstates0, dgi, dghn, dhout, dzb = seq_bwd(
        spec, tw, gc, zs_res, hprev_all, dz_seq, dscales, dnew_states,
        precision=precision)

    def ein(eq, a, b):
        return torch.einsum(eq, rnd(a), rnd(b))

    bias = tw.an_bias[None, :, None, :]
    scale = tw.an_scale[None, :, None, :]
    za = (zs_res + bias) * scale
    z1 = ein("nkbc,kcd->nkbd", za, tw.w)[..., :z1d]
    dgh = torch.cat([dgi[..., :2 * h], dghn], dim=-1)
    dza = ein("nkbd,kcd->nkbc", dzb, tw.w)
    d_w_ih = torch.cat([ein("nkbi,nkbg->kig", z1, dgi),
                        ein("nkbi,nkbg->kig", ops.leaky_relu(cond_seq), dgi)],
                       dim=1)
    dtw = TrainWeights(
        w=ein("nkbc,nkbd->kcd", za, dzb),
        an_bias=(dza * scale).sum(dim=(0, 2)),
        an_scale=(dza * (zs_res + bias)).sum(dim=(0, 2)),
        w_ih_t=d_w_ih,
        w_hh_t=ein("nkbh,nkbg->khg", hprev_all, dgh),
        b_ih=dgi.sum(dim=(0, 2)),
        b_hh=dgh.sum(dim=(0, 2)),
        out_w_t=ein("nkbh,nkbo->kho", states_res, dhout),
        out_b=dhout.sum(dim=(0, 2)),
    )
    dcond = ein("nkbg,kig->nkbi", dgi, tw.w_ih_t[:, z1d:])
    dcond = dcond * torch.where(cond_seq > 0, 1.0, 0.01)
    return (*dtw, dx, dcond, dstates0)


class _FlowSequence(torch.autograd.Function):
    """(TrainWeights..., xs, cond_seq, states0) -> (z_seq, scales,
    new_states), forward by ``seq_fwd``, backward by ``flow_sequence_vjp``,
    both at ``precision`` (a name of ``flow_kernels.MODES``; the weights are
    rounded once here and saved so, and their gradients are those of the
    float32 weights)."""

    @staticmethod
    def forward(ctx, spec, precision, *inputs):
        tw = round_train_weights(TrainWeights(*inputs[:9]),
                                 precision_mode(precision))
        xs, cond_seq, states0 = inputs[9:]
        z_seq, scales, zs_res, states_res, gc = seq_fwd(
            spec, tw, xs, cond_seq, states0, precision=precision)
        ctx.spec, ctx.precision = spec, precision
        ctx.save_for_backward(*tw, cond_seq, gc, states0, zs_res, states_res)
        return z_seq, scales, states_res[-1].clone()

    @staticmethod
    def backward(ctx, dz_seq, dscales, dnew_states):
        *tw, cond_seq, gc, states0, zs_res, states_res = ctx.saved_tensors
        grads = flow_sequence_vjp(
            ctx.spec, TrainWeights(*tw), cond_seq, gc, states0, zs_res, states_res,
            dz_seq.contiguous(), dscales.contiguous(), dnew_states.contiguous(),
            precision=ctx.precision)
        return (None, None, *grads)


def flow_sequence_fused(spec: FlowSpec, flow_params, xs, cond_seq, states0, *,
                        precision: str | None = None):
    """The teacher-forced flow traversal of a whole sequence on the training
    kernel pair, differentiable. xs [N, B, C]; cond_seq [N, K, B, cond]
    pre-projected conditioning (``flow.project_cond_frames``); states0
    [K, B, H], all contiguous. ``precision``: a name of
    ``flow_kernels.MODES``, or None for the ambient one (read here, once, so
    the backward runs at the forward's). Returns (z_seq [N, B, C], logdet
    [N, B], new_states [K, B, H], scales [N, K, B, Cout/2]), at the logical
    widths: the kernels run in the lanes of ``kernel_spec``."""
    if precision is None:
        precision = ambient_matmul_precision()
    precision_mode(precision)
    if not train_supported(spec):
        raise ValueError("spec is outside the training kernels' envelope")
    tw = prepare_train_weights(spec, flow_params)
    z_seq, scales, new_states = _FlowSequence.apply(
        kernel_spec(spec), precision, *tw, pad_lanes(spec, xs), cond_seq,
        states0)
    z_seq = unpad_lanes(spec, z_seq)
    # the logical lanes' scales only: a padded lane's is sigmoid(2), not 1
    scales = scales[..., :spec.coupling_out_dim // 2]
    logdet = torch.log(scales).sum(dim=(1, 3)) + logdet_const(spec, flow_params)
    return z_seq, logdet, new_states, scales
