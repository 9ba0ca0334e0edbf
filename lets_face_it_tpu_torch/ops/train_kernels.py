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
  ``csrc/seq_fwd.cu``; replaces ``_fwd_kernel``.
* ``seq_bwd``: the mirror backward. It walks the frames in reverse,
  recomputes each step from the residuals, threads the serial cotangent
  chains (dz within a frame, the K state cotangents across frames) and
  writes each (frame, step)'s local cotangents. CUDA source
  ``csrc/seq_bwd.cu``; replaces ``_bwd_kernel``. Two plans
  (``seq_bwd_plan_name``): "walk", every product of a step inside one
  launch's walk over all frames, and, at wide H, "split", the two products
  that read w_hh taken off the walk as tile products over the whole card
  (``bwd_gh_ref``, ``bwd_dstate_ref``: their plain versions).

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
from lets_face_it_tpu_torch.ops.flow_kernels import (MAX_SMEM_BYTES, _check,
                                                     _raise_on, _round4,
                                                     _spec_ints,
                                                     fold_output_head,
                                                     ambient_matmul_precision,
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

# flow_stream.cuh: the barrier area and the slots of the weight ring (floats)
_STREAM_BAR_FLOATS, _STREAM_SLOTS = 96, 3


def train_smem_bytes(spec: FlowSpec) -> int:
    """Least shared memory of a one-row seq_bwd.cu block (the larger of the
    two serial kernels) of the plan its launcher takes
    (``seq_bwd_plan_name``): the ring's barriers and three slots of four
    rows of the widest product, the K state cotangents, the backward's
    buffers (the split plan's without gh and b_hh), two steps of prefetched
    inputs (with the split plan's gh rows) and one slice of partial sums (csrc/seq_bwd.cu::bwd_other_floats,
    csrc/flow_stream.cuh::plan_stream), in the kernel spec's lanes."""
    spec = kernel_spec(spec)
    c, h, cout = spec.channels, spec.hidden_channels, spec.coupling_out_dim
    g = 3 * h
    widest = max(g, c, cout, h, spec.z1_dim)
    split = seq_bwd_plan_name(spec) == "split"
    step = (2 * c + (0 if split else g) + cout
            + (g + c + h + cout // 2 + c + (g if split else 0)))
    other = (_round4(spec.n_steps * h) + 2 * _round4(h) + 4 * _round4(c)
             + 2 * _round4(cout) + (3 if split else 4) * _round4(g) + 2 * step)
    ring = _STREAM_BAR_FLOATS + _STREAM_SLOTS * 4 * widest
    return 4 * (ring + other + _round4(widest))


# csrc/seq_bwd.cu: the backward's plans, by the launcher's codes, and the H
# from which it takes the split one (SPLIT_FROM_H).
SEQ_BWD_PLANS = ("walk", "split")
_BWD_PLAN_CODES = {"walk": 1, "split": 2}
SEQ_BWD_SPLIT_FROM_H = 256


def seq_bwd_plan_name(spec: FlowSpec) -> str:
    """The plan ``seq_bwd``'s launcher takes (csrc/seq_bwd.cu::bwd_split):
    "split" from H = ``SEQ_BWD_SPLIT_FROM_H`` on (the two products that read
    w_hh taken off the serial walk: gh for every frame and step before it,
    each frame's state cotangents of the frame before after it, as tile
    products over the whole card), "walk" below (every product of a step
    inside the walk). Both take every spec of ``train_supported``."""
    return ("split" if kernel_spec(spec).hidden_channels >= SEQ_BWD_SPLIT_FROM_H
            else "walk")


def train_supported(spec: FlowSpec) -> bool:
    """The training kernels' envelope: GRU + affine + invconv flows whose
    product widths (C, Z1, H, 3H, cond, Cout) in the kernel spec's lanes
    are multiples of 4 (16-byte weight loads) and whose one-row backward
    tile fits one block's shared memory. Decided from the spec alone; the
    batch is arbitrary. It holds wherever ``flow_kernels.jax_envelope``
    does at the widths of ``hparam_tuning_configs/large_hparam_search.py``."""
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
                    mode: int = 0, gh_k=None):
    """One forward step on prepared weights (rounded for ``mode``), the
    conditioning gates gc_k (and, where given, the hidden gates gh_k) given
    -> (zb, gi, gh, r, u, n, h_new, hout, sig, scale)."""
    rnd = _rounded(mode)
    hd, z1d, half = spec.hidden_channels, spec.z1_dim, spec.coupling_out_dim // 2
    za = (z + tw.an_bias[k]) * tw.an_scale[k]
    zb = rnd(za) @ tw.w[k]
    gi = rnd(zb[:, :z1d]) @ tw.w_ih_t[k, :z1d] + gc_k
    gh = rnd(h_prev) @ tw.w_hh_t[k] + tw.b_hh[k] if gh_k is None else gh_k
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
              dscale_k, dstate_k, mode: int, gh_k=None):
    """One step of the backward walk on prepared weights: the step
    recomputed (``_recompute_step``), then its cotangents -> (dz of the
    step's input, dgi, dgh, dghn, dhout, dzb, dh * u); the state cotangent
    of the frame before is dh * u + dgh @ w_hh_t[k]^T."""
    rnd = _rounded(mode)
    hd, z1d, half = spec.hidden_channels, spec.z1_dim, spec.coupling_out_dim // 2
    zb, gi, gh, r, u, n, _, hout, sig, scale = _recompute_step(
        spec, tw, k, z, gc_k, h_prev, mode, gh_k)
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
    """Plain version of the split plan's first product (csrc/seq_bwd.cu::
    bwd_gh): the hidden gates of every frame and step, hprev_all [N, K, B,
    H] -> gh [N, K, B, 3H] = hprev @ w_hh_t[k] + b_hh[k], on weights rounded
    for ``mode``."""
    gh = torch.einsum("nkbh,khg->nkbg", round_operand(hprev_all, mode), tw.w_hh_t)
    return gh + tw.b_hh[None, :, None, :]


def bwd_dstate_ref(tw: TrainWeights, dgh, dhu, mode: int = 0):
    """Plain version of the split plan's per-frame product (csrc/seq_bwd.cu::
    bwd_dstate): the state cotangents of the frame before, dgh [K, B, 3H],
    dhu [K, B, H] -> dhu + dgh @ w_hh_t[k]^T, [K, B, H], on weights rounded
    for ``mode``."""
    return dhu + torch.einsum("kbg,khg->kbh", round_operand(dgh, mode), tw.w_hh_t)


def seq_bwd_split_ref(spec: FlowSpec, tw: TrainWeights, gc, zs_res, hprev_all,
                      dz_seq, dscales, dnew_states, mode: int = 0):
    """Plain version of ``seq_bwd``'s split plan, the same function as
    ``seq_bwd_ref``: the hidden gates of every (t, k) first
    (``bwd_gh_ref``), then the walk over each frame's steps without the two
    products that read w_hh, and after each frame its state cotangents for
    the frame before (``bwd_dstate_ref``)."""
    tw = round_train_weights(tw, mode)
    dx, dgi_all, dghn_all, dhout_all, dzb_all = _bwd_outputs(spec, dz_seq)
    gh_all = bwd_gh_ref(tw, hprev_all, mode)
    dstates = dnew_states.clone()
    dgh_t = torch.empty_like(gh_all[0])
    dhu_t = torch.empty_like(dstates)
    for t in reversed(range(dz_seq.shape[0])):
        dz = dz_seq[t]
        for k in reversed(range(spec.n_steps)):
            dz, dgi, dgh_t[k], dghn, dhout, dzb, dhu_t[k] = _bwd_step(
                spec, tw, k, zs_res[t, k], gc[t, k], hprev_all[t, k], dz,
                dscales[t, k], dstates[k], mode, gh_all[t, k])
            dgi_all[t, k], dghn_all[t, k] = dgi, dghn
            dhout_all[t, k], dzb_all[t, k] = dhout, dzb
        dx[t] = dz
        dstates = bwd_dstate_ref(tw, dgh_t, dhu_t, mode)
    return dx, dstates, dgi_all, dghn_all, dhout_all, dzb_all


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
    fn.argtypes = [_P] * 29 + [_I] * 8 + [ctypes.c_float] + [_I] * 5 + [_P] * 2
    fn.restype = _I
    return fn


PLAN_KEYS = ("rows_per_block", "cluster", "blocks", "slots", "slot_bytes",
             "partial_bytes", "smem_bytes", "max_active_clusters")


def serial_plan(which: str, spec: FlowSpec, b: int, tile=(0, 0, 0),
                plan: str | None = None) -> dict:
    """The launch plan of ``seq_fwd``'s or ``seq_bwd``'s serial kernel
    (``which``) for B=b rows on the current CUDA device, with the cluster
    occupancy the device allows (``cudaOccupancyMaxActiveClusters``);
    ``tile`` as in ``seq_fwd``; for ``seq_bwd`` also ``plan`` as
    ``seq_bwd`` takes it, and its "plan" key the one planned."""
    bwd = which == "seq_bwd"
    fn = getattr(cuda_build.load(which), f"{which}_plan")
    fn.argtypes = [_I] * (11 if bwd else 10) + [_P]
    fn.restype = _I
    keys = PLAN_KEYS + (("plan",) if bwd else ())
    out = (ctypes.c_int * len(keys))()
    extra = (_bwd_plan_arg(plan),) if bwd else ()
    _raise_on(fn(b, *_spec_ints(kernel_spec(spec)), *tile, *extra,
                 ctypes.addressof(out)), f"{which} plan")
    got = dict(zip(keys, out))
    if bwd:
        got["plan"] = SEQ_BWD_PLANS[got["plan"] - 1]
    return got


def _bwd_plan_arg(plan: str | None) -> int:
    """csrc/seq_bwd.cu's ``plan`` for a wrapper's request (0: the
    launcher's)."""
    if plan is None:
        return 0
    if plan in _BWD_PLAN_CODES:
        return _BWD_PLAN_CODES[plan]
    raise ValueError(f"seq_bwd: no plan {plan!r}; plans {', '.join(SEQ_BWD_PLANS)}")


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
            precision: str | None = None, tile=(0, 0, 0)):
    """Teacher-forced forward: xs [N, B, C], cond_seq [N, K, B, cond]
    (pre-activation projections), states0 [K, B, H] -> (z_seq [N, B, C],
    scales [N, K, B, Cout/2], zs_res [N, K, B, C], states_res [N, K, B, H],
    gc [N, K, B, 3H]): ``cond_gates``, then ``seq_fwd_serial``."""
    launch, mode = _dispatch(spec, precision, xs.device)
    spec = kernel_spec(spec)
    if not launch:
        return seq_fwd_ref(spec, tw, xs, cond_seq, states0, mode)
    tw = round_train_weights(tw, mode)
    gc = cond_gates(spec, tw, cond_seq, precision=precision)
    return (*seq_fwd_serial(spec, tw, xs, gc, states0, precision=precision,
                            tile=tile), gc)


def seq_fwd_serial(spec: FlowSpec, tw: TrainWeights, xs, gc, states0, *,
                   precision: str | None = None, tile=(0, 0, 0)):
    """The serial chain of ``seq_fwd`` on CUDA tensors, the conditioning
    gates gc [N, K, B, 3H] given -> (z_seq, scales, zs_res, states_res).
    ``tile`` = (rows per block, blocks per cluster, ring slots), 0 for the
    launcher's plan."""
    launch, mode = _dispatch(spec, precision, xs.device)
    spec = kernel_spec(spec)
    if not launch:
        raise ValueError("seq_fwd_serial runs on CUDA tensors only")
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
    err = _fwd_fn()(xs.data_ptr(), gc.data_ptr(), states0.data_ptr(),
                    z_seq.data_ptr(), scales.data_ptr(), zs_res.data_ptr(),
                    states_res.data_ptr(), *(t.data_ptr() for t in tw),
                    b, n, *_spec_ints(spec), float(spec.scale_eps), *tile,
                    mode, stream)
    _raise_on(err, "seq_fwd")
    seq_fwd.launches += 1
    return z_seq, scales, zs_res, states_res


seq_fwd.launches = 0


def seq_bwd(spec: FlowSpec, tw: TrainWeights, gc, zs_res, hprev_all,
            dz_seq, dscales, dnew_states, *, precision: str | None = None,
            tile=(0, 0, 0), plan: str | None = None):
    """Mirror backward: the residuals gc [N, K, B, 3H] (``seq_fwd``'s
    conditioning gates), zs_res [N, K, B, C] and hprev_all [N, K, B, H]
    (each step's previous state), the cotangents dz_seq [N, B, C], dscales
    [N, K, B, Cout/2] and dnew_states [K, B, H] -> (dx [N, B, C], dstates0
    [K, B, H], dgi [N, K, B, 3H], dghn [N, K, B, H], dhout [N, K, B, Cout],
    dzb [N, K, B, C]). ``tile`` as in ``seq_fwd``; ``plan``: "walk" or
    "split", None for the launcher's (``seq_bwd_plan_name``; on CPU tensors
    the plan's plain version, ``seq_bwd_ref`` or ``seq_bwd_split_ref``).
    Counts its calls in ``seq_bwd.launches`` and by plan in
    ``seq_bwd.plans``."""
    launch, mode = _dispatch(spec, precision, dz_seq.device)
    plan_arg = _bwd_plan_arg(plan)
    spec = kernel_spec(spec)
    split = (plan or seq_bwd_plan_name(spec)) == "split"
    if not launch:
        return (seq_bwd_split_ref if split else seq_bwd_ref)(
            spec, tw, gc, zs_res, hprev_all, dz_seq, dscales, dnew_states, mode)
    n, b, c = dz_seq.shape
    k, _, z1, _, h, cout = _spec_ints(spec)
    dev = dz_seq.device
    for name, t, shape in (("dz_seq", dz_seq, (n, b, c)),
                           ("dscales", dscales, (n, k, b, cout // 2)),
                           ("zs_res", zs_res, (n, k, b, c)),
                           ("hprev_all", hprev_all, (n, k, b, h)),
                           ("dnew_states", dnew_states, (k, b, h)),
                           ("gc", gc, (n, k, b, 3 * h))):
        _check(name, t, shape, dev)
    _check_weights(spec, tw, dev)
    tw = round_train_weights(tw, mode)
    # the backward products read the transposed weights row by row
    transposed = (tw.w.transpose(1, 2), tw.w_hh_t.transpose(1, 2),
                  tw.w_ih_t[:, :z1].transpose(1, 2), tw.out_w_t.transpose(1, 2))
    transposed = [t.contiguous() for t in transposed]
    dx = torch.empty_like(dz_seq)
    dstates0 = torch.empty_like(dnew_states)
    dgi = dz_seq.new_empty((n, k, b, 3 * h))
    dghn = dz_seq.new_empty((n, k, b, h))
    dhout = dz_seq.new_empty((n, k, b, cout))
    dzb = dz_seq.new_empty((n, k, b, c))
    # the split plan's scratch: gh of every frame and step, a frame's dgh,
    # dh * u and state cotangents
    scratch = ()
    if split:
        scratch = (gc.new_empty(gc.shape), gc.new_empty((k, b, 3 * h)),
                   dnew_states.new_empty((k, b, h)), dnew_states.new_empty((k, b, h)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    launched = ctypes.c_int(0)
    err = _bwd_fn()(dz_seq.data_ptr(), dscales.data_ptr(), zs_res.data_ptr(),
                    hprev_all.data_ptr(), dnew_states.data_ptr(),
                    gc.data_ptr(), dx.data_ptr(), dstates0.data_ptr(),
                    dgi.data_ptr(), dghn.data_ptr(), dhout.data_ptr(),
                    dzb.data_ptr(), *(t.data_ptr() for t in tw),
                    *(t.data_ptr() for t in transposed),
                    *(t.data_ptr() for t in scratch) if split else [None] * 4,
                    b, n, *_spec_ints(spec), float(spec.scale_eps), *tile,
                    plan_arg, mode, stream, ctypes.addressof(launched))
    _raise_on(err, "seq_bwd")
    seq_bwd.launches += 1
    seq_bwd.plans[SEQ_BWD_PLANS[launched.value - 1]] += 1
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
