"""The two sampling kernels of the flow, each beside its plain PyTorch version.

* ``frame_rev_fused``: one frame inverted through the K flow steps (reverse
  order) with the coupling-GRU states advanced; the streaming step. CUDA
  source ``csrc/frame_rev.cu``; replaces ``lets_face_it_tpu/ops/pallas_flow.py``
  ``_kernel``.
* ``sequence_rev_fused``: the whole autoregressive sampling loop (N frames x
  K steps, own-face ring buffer and GRU states kept on chip); offline
  generation. CUDA source ``csrc/seq_rev.cu``; replaces ``_seq_rev_kernel``.

A wrapper runs its plain version (``*_ref``) only when it is given CPU
tensors; given CUDA tensors it launches its kernel or raises. Each wrapper
counts its kernel launches in its ``launches`` attribute.

Both kernels compute in float32 with fused multiply-adds (the JAX package's
``highest`` matmul precision); ``precision="highest"`` is the only value
accepted. The weights are prepared once by ``prepare_sampling_weights``: the
coupling head is folded to contiguous ``[shift | scale_raw]`` halves and the
1x1 inverse is taken in float64 and rounded to float32, as the reference does
(modules.py:175-177).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lets_face_it_tpu_torch.core import ops
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import cuda_build

# Opt-in shared memory per block of an H100 (bytes). The envelope below is
# decided from the FlowSpec alone against it; the launchers read the device's
# own limit and pick their batch tile from it.
MAX_SMEM_BYTES = 232_448


class SamplingWeights(NamedTuple):
    """Flow weights prepared for the sampling kernels (all float32, contiguous)."""
    w_ih_t: torch.Tensor    # [K, Z1+cond, 3H]  transposed GRU input weights
    w_hh_t: torch.Tensor    # [K, H, 3H]
    b_ih: torch.Tensor      # [K, 3H]
    b_hh: torch.Tensor      # [K, 3H]
    out_w_t: torch.Tensor   # [K, H, Cout]  columns [shift | scale_raw]
    out_b: torch.Tensor     # [K, Cout]     permuted, logscale folded
    w_inv: torch.Tensor     # [K, C, C]     (P L U)^-1
    an_bias: torch.Tensor   # [K, C]
    an_neg_logs_exp: torch.Tensor  # [K, C] = exp(-logs)


def fold_output_head(out_params, cout: int):
    """Fold the linear-zeros log-scale (factor 3) into weight and bias and
    reorder the rows so that ``h @ W^T`` yields ``[shift(0::2) | scale_raw(1::2)]``
    as contiguous halves. -> (w [K, Cout, H], b [K, Cout])."""
    scale = torch.exp(out_params["logs"] * 3.0)
    w = out_params["w"] * scale[..., None]
    b = out_params["b"] * scale
    perm = torch.cat([torch.arange(0, cout, 2), torch.arange(1, cout, 2)]
                     ).to(w.device)
    return w[:, perm, :], b[:, perm]


@torch.no_grad()
def prepare_sampling_weights(spec: FlowSpec, flow_params) -> SamplingWeights:
    if not fused_supported(spec):
        raise ValueError("the sampling kernels need a GRU, affine, invconv flow")
    perm = {k: v.double() for k, v in flow_params["perm"].items()}
    w_inv = torch.linalg.inv(ops.invconv_weight(perm)).float()
    out_w, out_b = fold_output_head(flow_params["out"], spec.coupling_out_dim)
    rnn_p = flow_params["rnn"]

    def c(t):
        return t.detach().float().contiguous()

    return SamplingWeights(
        w_ih_t=c(rnn_p["w_ih"].transpose(1, 2)),
        w_hh_t=c(rnn_p["w_hh"].transpose(1, 2)),
        b_ih=c(rnn_p["b_ih"]),
        b_hh=c(rnn_p["b_hh"]),
        out_w_t=c(out_w.transpose(1, 2)),
        out_b=c(out_b),
        w_inv=c(w_inv),
        an_bias=c(flow_params["actnorm"]["bias"]),
        an_neg_logs_exp=c(torch.exp(-flow_params["actnorm"]["logs"])),
    )


# ---------------------------------------------------------------------------
# Envelopes (one block's shared memory; widths for 16-byte loads)
# ---------------------------------------------------------------------------

def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _one_row_step_floats(spec: FlowSpec) -> int:
    """Least step scratch of a one-row block, as flow_step.cuh lays it out:
    the fixed buffers plus one slice of partial sums of the widest product."""
    c, z1, h = spec.channels, spec.z1_dim, spec.hidden_channels
    cond, cout = spec.cond.cond_dim, spec.coupling_out_dim
    fixed = (2 * _round4(c) + _round4(z1 + cond) + 2 * _round4(3 * h)
             + _round4(cout))
    return fixed + max(3 * h, cond)


def frame_smem_bytes(spec: FlowSpec) -> int:
    """Least shared memory of a one-row frame_rev.cu block."""
    return 4 * (_round4(spec.hidden_channels) + _one_row_step_floats(spec))


def seq_smem_bytes(spec: FlowSpec) -> int:
    """Least shared memory of a one-row seq_rev.cu block."""
    p1 = spec.cond.p1_face.out_dim
    return 4 * (_round4(spec.n_steps * spec.hidden_channels) + 2 * _round4(p1)
                + _one_row_step_floats(spec))


def fused_supported(spec: FlowSpec) -> bool:
    """The per-frame kernel's envelope: GRU + affine + invconv flows whose
    product widths are multiples of 4 (16-byte weight loads) and whose
    one-row tile fits one block's shared memory."""
    widths = (3 * spec.hidden_channels, spec.cond.cond_dim,
              spec.coupling_out_dim, spec.channels)
    return (spec.rnn_type == "gru" and spec.coupling == "affine"
            and spec.permutation == "invconv"
            and all(n % 4 == 0 for n in widths)
            and frame_smem_bytes(spec) <= MAX_SMEM_BYTES)


def sampling_seq_supported(spec: FlowSpec) -> bool:
    """The whole-sequence kernel's envelope: the per-frame one, plus an
    own-face conditioning that is absent or the 'none' encoder (a flat window
    the kernel keeps as a ring buffer), and a one-row tile that fits."""
    p1 = spec.cond.p1_face
    p1_ok = p1.out_dim == 0 or (p1.enc == "none" and p1.out_dim >= spec.channels)
    return (fused_supported(spec) and p1_ok
            and seq_smem_bytes(spec) <= MAX_SMEM_BYTES)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _reverse_step_ref(spec: FlowSpec, w: SamplingWeights, k: int, z, proj, h):
    """One reversed step on folded weights: -> (z, new GRU state)."""
    z1d = spec.z1_dim
    half = spec.coupling_out_dim // 2
    hd = spec.hidden_channels
    z1, z2 = z[:, :z1d], z[:, z1d:]
    rnn_in = torch.cat([z1, ops.leaky_relu(proj)], dim=-1)
    gi = rnn_in @ w.w_ih_t[k] + w.b_ih[k]
    gh = h @ w.w_hh_t[k] + w.b_hh[k]
    r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
    zz = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = torch.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
    h_new = (1.0 - zz) * n + zz * h
    hout = h_new @ w.out_w_t[k] + w.out_b[k]
    scale = torch.clamp(torch.sigmoid(hout[:, half:] + 2.0), min=spec.scale_eps)
    z = torch.cat([z1, z2 / scale - hout[:, :half]], dim=-1) @ w.w_inv[k]
    return z * w.an_neg_logs_exp[k] - w.an_bias[k], h_new


def frame_rev_fused_ref(spec: FlowSpec, weights: SamplingWeights, z,
                        cond_projs, states):
    """Plain version of ``frame_rev_fused``: a Python loop over k."""
    new_states = states.clone()
    for k in reversed(range(spec.n_steps)):
        z, new_states[k] = _reverse_step_ref(spec, weights, k, z,
                                             cond_projs[k], states[k])
    return z, new_states


def sequence_rev_fused_ref(spec: FlowSpec, weights: SamplingWeights, w_p1_t,
                           zs, fixed_projs, hist0, states0):
    """Plain version of ``sequence_rev_fused``: loops over t and k."""
    c = spec.channels
    p1_dim = hist0.shape[-1]
    states = states0.clone()
    hist = hist0
    xs = []
    for t in range(zs.shape[0]):
        z = zs[t]
        for k in reversed(range(spec.n_steps)):
            proj = fixed_projs[t, k]
            if p1_dim:
                proj = proj + hist @ w_p1_t[k]
            z, states[k] = _reverse_step_ref(spec, weights, k, z, proj,
                                             states[k])
        xs.append(z)
        if p1_dim:
            hist = torch.cat([hist[:, c:], z], dim=-1)
    return torch.stack(xs)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _frame_fn():
    fn = cuda_build.load("frame_rev").frame_rev_launch
    fn.argtypes = [_P] * 14 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


@functools.cache
def _seq_fn():
    fn = cuda_build.load("seq_rev").seq_rev_launch
    fn.argtypes = [_P] * 15 + [_I] * 9 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 expected, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_weights(spec: FlowSpec, w: SamplingWeights, device):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    cout, ind = spec.coupling_out_dim, spec.z1_dim + spec.cond.cond_dim
    shapes = {"w_ih_t": (k, ind, 3 * h), "w_hh_t": (k, h, 3 * h),
              "b_ih": (k, 3 * h), "b_hh": (k, 3 * h), "out_w_t": (k, h, cout),
              "out_b": (k, cout), "w_inv": (k, c, c), "an_bias": (k, c),
              "an_neg_logs_exp": (k, c)}
    for name, shape in shapes.items():
        _check(name, getattr(w, name), shape, device)


def _check_precision(precision):
    if precision != "highest":
        raise ValueError(f"precision {precision!r}: only 'highest' (float32 "
                         "FMA) is implemented")


def _spec_ints(spec: FlowSpec):
    return (spec.n_steps, spec.channels, spec.z1_dim, spec.cond.cond_dim,
            spec.hidden_channels, spec.coupling_out_dim)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def frame_rev_fused(spec: FlowSpec, weights: SamplingWeights, z, cond_projs,
                    states, *, precision: str = "highest"):
    """Inverse of one frame through all K steps: z [B, C], cond_projs
    [K, B, cond] (pre-activation), states [K, B, H] -> (x [B, C],
    new_states [K, B, H])."""
    _check_precision(precision)
    if not fused_supported(spec):
        raise ValueError("spec is outside the per-frame kernel's envelope")
    if z.device.type == "cpu":
        return frame_rev_fused_ref(spec, weights, z, cond_projs, states)
    if z.device.type != "cuda":
        raise ValueError(f"no sampling kernel for device {z.device}")
    b = z.shape[0]
    k, c, _, cond, h, _ = _spec_ints(spec)
    _check("z", z, (b, c), z.device)
    _check("cond_projs", cond_projs, (k, b, cond), z.device)
    _check("states", states, (k, b, h), z.device)
    _check_weights(spec, weights, z.device)
    x = torch.empty_like(z)
    new_states = torch.empty_like(states)
    fn = _frame_fn()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = fn(z.data_ptr(), cond_projs.data_ptr(), states.data_ptr(),
             x.data_ptr(), new_states.data_ptr(),
             *(t.data_ptr() for t in weights), b, *_spec_ints(spec),
             float(spec.scale_eps), stream)
    _raise_on(err, "frame_rev")
    frame_rev_fused.launches += 1
    return x, new_states


frame_rev_fused.launches = 0


def sequence_rev_fused(spec: FlowSpec, weights: SamplingWeights, w_p1_t, zs,
                       fixed_projs, hist0, states0, *,
                       precision: str = "highest"):
    """Generate a whole sequence: zs [N, B, C] latents, fixed_projs
    [N, K, B, cond] (the non-autoregressive part of every projection, bias
    included), hist0 [B, P1] flattened own-face history (oldest frame first),
    w_p1_t [K, P1, cond] own-face projection slice, states0 [K, B, H]
    -> xs [N, B, C]. P1 = 0 turns the own-face path off."""
    _check_precision(precision)
    if not sampling_seq_supported(spec):
        raise ValueError("spec is outside the sequence kernel's envelope")
    if zs.device.type == "cpu":
        return sequence_rev_fused_ref(spec, weights, w_p1_t, zs, fixed_projs,
                                      hist0, states0)
    if zs.device.type != "cuda":
        raise ValueError(f"no sampling kernel for device {zs.device}")
    n, b, c = zs.shape
    k, _, _, cond, h, _ = _spec_ints(spec)
    p1 = spec.cond.p1_face.out_dim
    dev = zs.device
    _check("zs", zs, (n, b, c), dev)
    _check("fixed_projs", fixed_projs, (n, k, b, cond), dev)
    _check("hist0", hist0, (b, p1), dev)
    _check("w_p1_t", w_p1_t, (k, p1, cond), dev)
    _check("states0", states0, (k, b, h), dev)
    _check_weights(spec, weights, dev)
    xs = torch.empty_like(zs)
    fn = _seq_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(zs.data_ptr(), fixed_projs.data_ptr(), hist0.data_ptr(),
             w_p1_t.data_ptr(), states0.data_ptr(), xs.data_ptr(),
             *(t.data_ptr() for t in weights), b, n, p1, *_spec_ints(spec),
             float(spec.scale_eps), stream)
    _raise_on(err, "seq_rev")
    sequence_rev_fused.launches += 1
    return xs


sequence_rev_fused.launches = 0
