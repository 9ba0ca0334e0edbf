"""The two sampling kernels of the flow, each beside its plain PyTorch version.

* ``frame_rev_fused``: one frame inverted through the K flow steps (reverse
  order) with the coupling-GRU states advanced; the streaming step. CUDA
  launcher ``csrc/frame_rev.cu``; replaces ``lets_face_it_tpu/ops/pallas_flow.py``
  ``_kernel``.
* ``sequence_rev_fused``: the whole autoregressive sampling loop (N frames x
  K steps, own-face history and GRU states kept on the device); offline
  generation. CUDA launcher ``csrc/seq_rev.cu``; replaces ``_seq_rev_kernel``.

Both run each frame as two kinds of hand-written kernel:

* ``sample_gates`` (``csrc/sample_gates.cuh``): the products of a frame that
  do not depend on the serial chain, for all K steps at once: the own-face
  projection ``proj[k] = fixed[k] + hist @ w_p1_t[k]``, the conditioning
  rows of the GRU input product ``gc[k] = leaky_relu(proj[k]) @
  w_ih_t[k][Z1:] + b_ih[k]`` and the hidden gates ``gh[k] = h[k] @
  w_hh_t[k] + b_hh[k]``; on two plans by rows (``gates_plan``): matrix-vector
  products below ``GATES_TILE_FROM_ROWS`` rows ("vector"), tensor-core tiles
  (``csrc/gates_mma.cuh``) from there ("tile", a 3xTF32 split at
  "highest");
* ``sample_chain`` (``csrc/sample_chain.cuh``): the K reversed steps given
  those gates, on a thread-block cluster whose shared memory holds the
  chain's weights.

Each is also callable alone (``csrc/sample_gates.cu``, ``csrc/sample_chain.cu``)
for tests, timing and the probe.

A wrapper runs its plain version (``*_ref``) only when it is given CPU
tensors; given CUDA tensors it launches its kernels or raises. Each wrapper
counts its calls into a launcher in its ``launches`` attribute; the
launchers report the gates and chain kernels they launch (an ``int *`` out
parameter, counted where each launch is enqueued), which the wrappers add to
``sample_gates.launches`` and ``sample_chain.launches``, and the gates
launches by plan to ``sample_gates.plans``.

The kernels compute in float32 with fused multiply-adds, the gates' tile
plan on the tensor cores (float32 as a 3xTF32 split). Each wrapper takes
a matmul ``precision`` (``MODES``; None, the default, follows the ambient
torch setting, ``ambient_matmul_precision``, as the JAX kernels follow
JAX's): "highest" multiplies float32 operands, "high" rounds the operands of
every product to TF32 and "medium" to bf16, with float32 sums either way.
The rounding happens at the products the JAX kernels mark with
``precision=`` and nowhere else: the weight operands are rounded once
(``round_sampling_weights``, which tags the set with its mode) and the
kernels round the activation operands as they read them (the gates kernel
its weights too, so the own-face slice ``w_p1_t`` goes to it as it is); the
plain versions round both. The owners of the weights (``model/seqglow.py``,
``sample/streaming.py``) hand the wrappers a set rounded at the launch's
mode, which a wrapper takes as it is; a float32 set it rounds per call. The
weights are prepared once by ``prepare_sampling_weights``: the
coupling head is folded to contiguous ``[shift | scale_raw]`` halves and the
1x1 inverse is taken in float64 and rounded to float32, as the reference does
(modules.py:175-177).

Lanes. The kernels read their weights and activations 16 bytes at a time,
so every width they take is a multiple of 4. A spec of the JAX kernels'
envelope (``jax_envelope``) whose coupling halves (C/2 each) are not runs
on padded lanes (``kernel_spec``): each half widened to the next multiple
of 4, the logical lanes first (``lane_index``). The prepared weights carry
zeros in the padded rows and columns, but 1 on the padded diagonal of the
1x1 and in the padded actnorm scale, so a padded lane enters every step as
zero and leaves it as zero; its coupling scale is sigmoid(2), not 1, so
only the logical lanes may enter a logdet. ``frame_rev_fused`` and
``sequence_rev_fused`` take and return the logical widths and pad inside;
the single kernels' wrappers (``sample_gates``, ``sample_chain``) and the
prepared weights are in the kernel spec's lanes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from lets_face_it_tpu_torch.core import ops
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import cuda_build

# Opt-in shared memory per block of an H100 (bytes). The envelope below is
# decided from the FlowSpec alone against it; the launchers read the device's
# own limit and plan from it.
MAX_SMEM_BYTES = 232_448

# The kernels' matmul precisions, by torch's names for the ambient setting,
# and the launchers' ``mode`` (csrc/flow_step.cuh::FlowPrecision). The JAX
# package's classes they stand for: HIGHEST (float32 operands), HIGH (TF32
# operands) and DEFAULT (bf16 operands, the TPU's production arithmetic).
MODES = {"highest": 0, "high": 1, "medium": 2}


def ambient_matmul_precision() -> str:
    """The precision the kernels take when the caller names none: torch's
    ``get_float32_matmul_precision()``, mapped as the JAX package maps JAX's
    ambient setting (pallas_flow.py:35): "highest" and "high" as they are,
    anything else "medium"."""
    v = torch.get_float32_matmul_precision()
    return v if v in ("highest", "high") else "medium"


def precision_mode(precision=None) -> int:
    """``precision`` (None: ``ambient_matmul_precision()``) -> the launchers'
    mode; raises ``ValueError`` for a name not in ``MODES``."""
    if precision is None:
        precision = ambient_matmul_precision()
    if precision not in MODES:
        raise ValueError(f"precision {precision!r}: expected one of "
                         f"{', '.join(MODES)} (or None for the ambient one)")
    return MODES[precision]


def round_tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``), float32 -> float32, bit for bit on the int32
    view (torch has no tf32 dtype). NaN passes through."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    return torch.where(torch.isnan(x), x, u.view(torch.float32).view(x.shape))


def round_operand(x, mode: int):
    """A product operand at matmul precision ``mode``: as it is (0), rounded
    to TF32 (1) or to bf16 (2, to nearest even), in x's dtype."""
    if mode == 0:
        return x
    if mode == 2:
        return x.to(torch.bfloat16).to(x.dtype)
    return round_tf32(x.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Lanes: the widths the kernels take
# ---------------------------------------------------------------------------

def jax_envelope(spec: FlowSpec) -> bool:
    """The JAX package's kernel envelope (pallas_flow.py:248-257
    ``pallas_supported``, pallas_train.py:114-125
    ``train_fused_spec_supported``): GRU + affine + invconv flows with C
    even and 3H and cond multiples of 128."""
    return (spec.rnn_type == "gru" and spec.coupling == "affine"
            and spec.permutation == "invconv" and spec.channels % 2 == 0
            and (3 * spec.hidden_channels) % 128 == 0
            and spec.cond.cond_dim % 128 == 0)


def kernel_spec(spec: FlowSpec) -> FlowSpec:
    """The spec whose widths the kernels run: ``spec`` itself, or, for a
    spec of ``jax_envelope`` whose halves C/2 are not multiples of 4, the
    same flow on padded lanes, C' = 2 * round4(C/2), with a 'none' own-face
    window of whole padded frames. Idempotent."""
    half = spec.channels // 2
    if not jax_envelope(spec) or half % 4 == 0:
        return spec
    c = 2 * _round4(half)
    cond, p1 = spec.cond, spec.cond.p1_face
    if p1.enc == "none" and p1.input_dim == spec.channels and p1.out_dim:
        wide = dataclasses.replace(p1, input_dim=c, out_dim=c * p1.history)
        cond = dataclasses.replace(
            cond, p1_face=wide,
            feature_dim=cond.feature_dim + wide.out_dim - p1.out_dim)
    return dataclasses.replace(spec, channels=c, cond=cond)


def lane_index(spec: FlowSpec, device=None):
    """Where the C logical lanes sit among the kernel spec's C': the
    first C/2 at 0.., the second at C'/2.. (the Cout = C lanes of the
    coupling head likewise)."""
    half, wide = spec.channels // 2, kernel_spec(spec).channels // 2
    r = torch.arange(half, device=device)
    return torch.cat([r, r + wide])


def _embed(t, dim: int, index, size: int):
    """``t`` placed at ``index`` along ``dim`` of zeros ``size`` long
    there; differentiable."""
    shape = list(t.shape)
    shape[dim] = size
    return t.new_zeros(shape).index_copy(dim, index, t)


def pad_lanes(spec: FlowSpec, x, dim: int = -1):
    """x with its C lanes (axis ``dim``) on the kernel spec's, zeros in
    the padded ones; x itself where there is no padding."""
    ks = kernel_spec(spec)
    if ks is spec:
        return x
    return _embed(x, dim % x.dim(), lane_index(spec, x.device), ks.channels)


def unpad_lanes(spec: FlowSpec, x, dim: int = -1):
    """The logical C lanes of x (axis ``dim`` in the kernel spec's
    lanes); differentiable."""
    if kernel_spec(spec) is spec:
        return x
    return x.index_select(dim, lane_index(spec, x.device)).contiguous()


def pad_history(spec: FlowSpec, hist, dim: int):
    """A flat 'none' own-face window (axis ``dim``: h frames of C) as h
    frames of the kernel spec's C'; as it is when the own face is not so
    padded."""
    ks = kernel_spec(spec)
    if ks.cond.p1_face.out_dim == spec.cond.p1_face.out_dim:
        return hist
    dim = dim % hist.dim()
    frames = hist.unflatten(dim, (spec.cond.p1_face.history, spec.channels))
    return pad_lanes(spec, frames, dim + 1).flatten(dim, dim + 1).contiguous()


# The prepared weights whose padded diagonal (the 1x1 and its inverse) or
# padded lanes (the actnorm's exp(logs) and exp(-logs)) hold 1.
_ONE_ON_DIAGONAL = ("w", "w_inv")
_ONE_IN_LANES = ("an_scale", "an_neg_logs_exp")


def pad_weight(spec: FlowSpec, name: str, t):
    """A prepared weight (a field of ``SamplingWeights`` or
    ``train_kernels.TrainWeights``) of ``spec`` in the kernel spec's lanes:
    zero rows and columns in the padded lanes, 1 on the padded diagonal of
    the 1x1 and in the padded actnorm scale; differentiable."""
    ks = kernel_spec(spec)
    if ks is spec or name in ("w_hh_t", "b_ih", "b_hh"):
        return t
    idx, c = lane_index(spec, t.device), ks.channels
    ones = 1.0 - _embed(torch.ones(spec.channels, device=t.device, dtype=t.dtype),
                        0, idx, c)                       # 1 in the padded lanes
    if name in _ONE_ON_DIAGONAL:
        return _embed(_embed(t, 2, idx, c), 1, idx, c) + torch.diag(ones)
    if name in _ONE_IN_LANES:
        return _embed(t, 1, idx, c) + ones
    if name in ("an_bias", "out_b"):
        return _embed(t, 1, idx, c)
    if name == "out_w_t":
        return _embed(t, 2, idx, c)
    if name == "w_ih_t":                      # rows [z1 | cond]
        z1, wide, n = spec.z1_dim, ks.z1_dim, t.shape[1]
        rows = torch.arange(n, device=t.device)
        return _embed(t, 1, torch.where(rows < z1, rows, rows + wide - z1),
                      n + wide - z1)
    raise ValueError(f"no lane layout for weight {name!r}")


class SamplingWeights(NamedTuple):
    """Flow weights prepared for the sampling kernels (all float32,
    contiguous), in the lanes of ``kernel_spec``."""
    w_ih_t: torch.Tensor    # [K, Z1+cond, 3H]  transposed GRU input weights
    w_hh_t: torch.Tensor    # [K, H, 3H]
    b_ih: torch.Tensor      # [K, 3H]
    b_hh: torch.Tensor      # [K, 3H]
    out_w_t: torch.Tensor   # [K, H, Cout]  columns [shift | scale_raw]
    out_b: torch.Tensor     # [K, Cout]     permuted, logscale folded
    w_inv: torch.Tensor     # [K, C, C]     (P L U)^-1
    an_bias: torch.Tensor   # [K, C]
    an_neg_logs_exp: torch.Tensor  # [K, C] = exp(-logs)
    chain: torch.Tensor     # [K, chain_step_floats]  see chain_weights
    mode: int = 0           # precision the products' operands are rounded at


def fold_output_head(out_params, cout: int):
    """Fold the linear-zeros log-scale (factor 3) into weight and bias and
    reorder the rows so that ``h @ W^T`` yields ``[shift(0::2) | scale_raw(1::2)]``
    as contiguous halves. -> (w [K, Cout, H], b [K, Cout])."""
    scale = torch.exp(out_params["logs"] * 3.0)
    w = out_params["w"] * scale[..., None]
    b = out_params["b"] * scale
    perm = torch.cat([torch.arange(0, cout, 2, device=w.device),
                      torch.arange(1, cout, 2, device=w.device)])
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

    w = dict(
        w_ih_t=rnn_p["w_ih"].transpose(1, 2),
        w_hh_t=rnn_p["w_hh"].transpose(1, 2),
        b_ih=rnn_p["b_ih"],
        b_hh=rnn_p["b_hh"],
        out_w_t=out_w.transpose(1, 2),
        out_b=out_b,
        w_inv=w_inv,
        an_bias=flow_params["actnorm"]["bias"],
        an_neg_logs_exp=torch.exp(-flow_params["actnorm"]["logs"]),
    )
    w = {name: c(pad_weight(spec, name, t)) for name, t in w.items()}
    return SamplingWeights(**w, chain=chain_weights(kernel_spec(spec), **w))


_SAMPLING_PRODUCT_WEIGHTS = ("w_ih_t", "w_hh_t", "out_w_t", "w_inv")


def round_sampling_weights(spec: FlowSpec, w: SamplingWeights,
                           mode: int) -> SamplingWeights:
    """The set for matmul precision ``mode``: the weight operands of the
    products rounded (the chain's copy laid out again from them), the
    biases and the actnorm float32, tagged with ``mode``; ``w`` itself when
    it is tagged so already. Rounding is idempotent, so rounding once here
    is rounding at every use; a set rounded at another mode cannot be
    unrounded and raises."""
    if w.mode == mode:
        return w
    if w.mode != 0:
        raise ValueError(f"weights rounded at mode {w.mode} cannot run at {mode}")
    fields = w._asdict()
    for name in _SAMPLING_PRODUCT_WEIGHTS:
        fields[name] = round_operand(fields[name], mode).contiguous()
    fields.pop("chain")
    fields["mode"] = mode
    return SamplingWeights(**fields,
                           chain=chain_weights(kernel_spec(spec), **fields))


# Slices of the chain's three products: each of a product's lanes takes the
# rows p, p + S, p + 2S, .. (csrc/sample_chain.cuh, CHAIN_PARTS_GRU,
# CHAIN_SLICES_OUT, CHAIN_SLICES_MIX).
_CHAIN_SLICES = (4, 16, 8)


def _interleave(w, s: int):
    """[K, R, N] -> [K, ceil(R/s) * N * s] with row s*m + p at [m][n][p],
    rows past R zero: the S lanes of one output column read S consecutive
    words."""
    k, r, n = w.shape
    rp = -(-r // s) * s
    padded = w.new_zeros((k, rp, n))
    padded[:, :r] = w
    return padded.reshape(k, rp // s, s, n).transpose(2, 3).reshape(k, -1)


def chain_weights(spec: FlowSpec, *, w_ih_t, out_w_t, out_b, w_inv, an_bias,
                  an_neg_logs_exp, **_):
    """Each step's chain weights as the chain kernel holds them in shared
    memory, one contiguous row a step: w_ih_t[k][:Z1], out_w_t[k] and W^-1[k]
    interleaved by their slices (``_interleave``), then out_b[k], the
    actnorm bias and exp(-logs), each piece padded to 16 bytes."""
    def pad4(t):
        return torch.nn.functional.pad(t, (0, (-t.shape[-1]) % 4))

    s_gru, s_out, s_mix = _CHAIN_SLICES
    pieces = (_interleave(w_ih_t[:, :spec.z1_dim], s_gru),
              _interleave(out_w_t, s_out), pad4(out_b),
              _interleave(w_inv, s_mix), pad4(an_bias), pad4(an_neg_logs_exp))
    return torch.cat(pieces, dim=1).contiguous()


# ---------------------------------------------------------------------------
# Envelopes (one cluster's shared memory; widths for 16-byte loads)
# ---------------------------------------------------------------------------

# csrc/sample_chain.cuh: the barrier area (floats), the largest portable
# cluster the envelope counts on, and the most steps a block may hold.
_CHAIN_BAR_FLOATS, _CHAIN_CLUSTER, _CHAIN_MAX_HELD = 96, 8, 16
# csrc/sample_gates.cuh: 8 warps' partial sums of a 32-column tile.
_GATES_RED_FLOATS = 8 * 32


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def chain_step_bytes(spec: FlowSpec) -> int:
    """Resident bytes of one step's chain weights as ``chain_weights`` lays
    them out: w_ih_t[k][:Z1], out_w_t[k], out_b[k], W^-1[k] and the actnorm
    (csrc/sample_chain.cuh::chain_step_floats). They depend on C, Z1, H and
    Cout only, not on the conditioning width (in the kernel spec's lanes)."""
    spec = kernel_spec(spec)
    c, z1, h, cout = (spec.channels, spec.z1_dim, spec.hidden_channels,
                      spec.coupling_out_dim)
    s_gru, s_out, s_mix = _CHAIN_SLICES
    return 4 * (_round_up(z1, s_gru) * 3 * h + _round_up(h, s_out) * cout
                + _round4(cout) + _round_up(c, s_mix) * c + 2 * _round4(c))


def _chain_held(spec: FlowSpec) -> int:
    """The most steps a block of a cluster of min(K, 8) holds."""
    return -(-spec.n_steps // min(spec.n_steps, _CHAIN_CLUSTER))


def chain_smem_bytes(spec: FlowSpec, resident: bool = True) -> int:
    """Least shared memory of a one-row sample_chain block in a cluster of
    min(K, 8): the barriers, the weights of the most steps a block holds
    (with ``resident``; else they are read from global memory), the row's
    buffers and its gates and states of those steps
    (csrc/sample_chain.cuh::chain_smem_floats)."""
    spec = kernel_spec(spec)
    c, h, held = spec.channels, spec.hidden_channels, _chain_held(spec)
    return (4 * (_CHAIN_BAR_FLOATS + 3 * _round4(c) + _round4(h) + held * 7 * h)
            + (held * chain_step_bytes(spec) if resident else 0))


def chain_resident(spec: FlowSpec) -> bool:
    """Whether the chain holds its weights in shared memory (the plan's
    choice where they fit, csrc/sample_chain.cuh::chain_plan) or reads them
    from global memory."""
    return chain_smem_bytes(spec) <= MAX_SMEM_BYTES


def gates_smem_bytes(spec: FlowSpec) -> int:
    """Least shared memory of a one-row sample_gates block: the widest input
    row and the partial sums."""
    spec = kernel_spec(spec)
    widest = max(spec.cond.p1_face.out_dim, spec.cond.cond_dim,
                 spec.hidden_channels)
    return 4 * (widest + _GATES_RED_FLOATS)


# csrc/sample_gates.cuh: rows from which the launcher takes the tile plan,
# by mode (at "highest" its 3xTF32 split triples the products), the tiles
# (rows x columns a block, warp tile rows x columns, stages of the ring:
# gates_tile_launch) and the default one.
GATES_TILE_FROM_ROWS = {0: 64, 1: 16, 2: 16}
GATES_TILES = ((64, 64, 32, 32, 3), (64, 64, 32, 32, 6), (64, 32, 32, 16, 6))
GATES_TILE_DEFAULT = 0


def mma_smem_bytes(tile, mode: int) -> int:
    """Shared memory of a gates_mma.cuh tile (BM, BN, WM, WN, stages) at
    matmul precision ``mode``: the stages of the X and W tiles of depth 32,
    their rows padded per mode (csrc/gates_mma.cuh::mma_smem_bytes)."""
    bm, bn, _, _, stages = tile
    apad, bpad = (8, 4) if mode == 2 else (4, 8)
    return stages * (bm * (32 + apad) + 32 * (bn + bpad)) * 4


def gates_plan(b: int, rows: int = 0, groups: int = 0, mode: int = 0) -> str:
    """The gates launcher's plan for B=b rows at matmul precision ``mode``
    (csrc/sample_gates.cuh::gates_plan): "tile" from
    ``GATES_TILE_FROM_ROWS[mode]`` rows on, else, or when a vector tile
    (``rows``, ``groups``) is asked for, "vector". Both take every width of
    ``fused_supported`` (the tile plan zero-fills its edges)."""
    if rows or groups or b < GATES_TILE_FROM_ROWS[mode]:
        return "vector"
    return "tile"


def fused_supported(spec: FlowSpec) -> bool:
    """The per-frame kernels' envelope: GRU + affine + invconv flows whose
    product widths in the kernel spec's lanes are multiples of 4 (16-byte
    loads), whose blocks hold at most 16 steps of a cluster of min(K, 8),
    and whose gates and chain fit a block (the chain's weights read from
    global memory where a cluster cannot hold them). It holds wherever
    ``jax_envelope`` does."""
    ks = kernel_spec(spec)
    widths = (ks.hidden_channels, ks.cond.cond_dim, ks.coupling_out_dim,
              ks.channels)
    return (ks.rnn_type == "gru" and ks.coupling == "affine"
            and ks.permutation == "invconv"
            and all(n % 4 == 0 for n in widths)
            and _round_up(ks.z1_dim, _CHAIN_SLICES[0]) <= ks.channels
            and _chain_held(ks) <= _CHAIN_MAX_HELD
            and chain_smem_bytes(ks, resident=False) <= MAX_SMEM_BYTES
            and gates_smem_bytes(ks) <= MAX_SMEM_BYTES)


def sampling_seq_supported(spec: FlowSpec) -> bool:
    """The whole-sequence launcher's envelope: the per-frame one, plus an
    own-face conditioning that is absent or the 'none' encoder (a flat window
    of whole frames that the chain shifts into the next history)."""
    ks = kernel_spec(spec)
    p1 = ks.cond.p1_face
    p1_ok = p1.out_dim == 0 or (p1.enc == "none" and p1.out_dim >= ks.channels)
    return fused_supported(spec) and p1_ok


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _mm(x, w, mode: int):
    """A product at matmul precision ``mode``: x rounded here, the weight
    operand ``w`` rounded by the caller (``round_sampling_weights``)."""
    return round_operand(x, mode) @ w


def _step_tail_ref(spec: FlowSpec, w: SamplingWeights, k: int, z, gi, gh, h,
                   mode: int = 0):
    """A reversed step given its GRU pre-activations gi and gh: the GRU
    update, the coupling, the 1x1 inverse and the actnorm -> (z, new state)."""
    z1d = spec.z1_dim
    half = spec.coupling_out_dim // 2
    hd = spec.hidden_channels
    z1, z2 = z[:, :z1d], z[:, z1d:]
    r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
    zz = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = torch.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
    h_new = (1.0 - zz) * n + zz * h
    hout = _mm(h_new, w.out_w_t[k], mode) + w.out_b[k]
    scale = torch.clamp(torch.sigmoid(hout[:, half:] + 2.0), min=spec.scale_eps)
    z = _mm(torch.cat([z1, z2 / scale - hout[:, :half]], dim=-1), w.w_inv[k],
            mode)
    return z * w.an_neg_logs_exp[k] - w.an_bias[k], h_new


def _reverse_step_ref(spec: FlowSpec, w: SamplingWeights, k: int, z, proj, h,
                      mode: int = 0):
    """One reversed step on folded weights: -> (z, new GRU state)."""
    rnn_in = torch.cat([z[:, :spec.z1_dim], ops.leaky_relu(proj)], dim=-1)
    gi = _mm(rnn_in, w.w_ih_t[k], mode) + w.b_ih[k]
    gh = _mm(h, w.w_hh_t[k], mode) + w.b_hh[k]
    return _step_tail_ref(spec, w, k, z, gi, gh, h, mode)


def frame_rev_fused_ref(spec: FlowSpec, weights: SamplingWeights, z,
                        cond_projs, states, mode: int = 0):
    """Plain version of ``frame_rev_fused``: a Python loop over k, at matmul
    precision ``mode``."""
    weights = round_sampling_weights(spec, weights, mode)
    new_states = states.clone()
    for k in reversed(range(spec.n_steps)):
        z, new_states[k] = _reverse_step_ref(spec, weights, k, z,
                                             cond_projs[k], states[k], mode)
    return z, new_states


def sequence_rev_fused_ref(spec: FlowSpec, weights: SamplingWeights, w_p1_t,
                           zs, fixed_projs, hist0, states0, mode: int = 0):
    """Plain version of ``sequence_rev_fused``: loops over t and k, at
    matmul precision ``mode``."""
    c = spec.channels
    p1_dim = hist0.shape[-1]
    weights = round_sampling_weights(spec, weights, mode)
    w_p1_t = round_operand(w_p1_t, mode)
    states = states0.clone()
    hist = hist0
    xs = []
    for t in range(zs.shape[0]):
        z = zs[t]
        for k in reversed(range(spec.n_steps)):
            proj = fixed_projs[t, k]
            if p1_dim:
                proj = proj + _mm(hist, w_p1_t[k], mode)
            z, states[k] = _reverse_step_ref(spec, weights, k, z, proj,
                                             states[k], mode)
        xs.append(z)
        if p1_dim:
            hist = torch.cat([hist[:, c:], z], dim=-1)
    return torch.stack(xs)


def sample_gates_ref(spec: FlowSpec, weights: SamplingWeights, w_p1_t, fixed,
                     hist, states, mode: int = 0):
    """Plain version of ``sample_gates``: the products of one frame that do
    not depend on the chain -> (proj [K, B, cond], gc [K, B, 3H],
    gh [K, B, 3H]); proj is ``fixed`` itself when P1 = 0."""
    weights = round_sampling_weights(spec, weights, mode)
    proj = fixed
    if hist.shape[-1]:
        proj = fixed + torch.einsum("bp,kpc->kbc", round_operand(hist, mode),
                                    round_operand(w_p1_t, mode))
    gc = (_mm(ops.leaky_relu(proj), weights.w_ih_t[:, spec.z1_dim:], mode)
          + weights.b_ih[:, None])
    gh = _mm(states, weights.w_hh_t, mode) + weights.b_hh[:, None]
    return proj, gc, gh


def sample_chain_ref(spec: FlowSpec, weights: SamplingWeights, z, gc, gh,
                     states, hist=None, mode: int = 0):
    """Plain version of ``sample_chain``: the K reversed steps of one frame
    given its gates -> (x [B, C], new_states [K, B, H], the next own-face
    history [B, P1], or None without one)."""
    z1d = spec.z1_dim
    weights = round_sampling_weights(spec, weights, mode)
    x = z
    new_states = states.clone()
    for k in reversed(range(spec.n_steps)):
        gi = gc[k] + _mm(x[:, :z1d], weights.w_ih_t[k, :z1d], mode)
        x, new_states[k] = _step_tail_ref(spec, weights, k, x, gi, gh[k],
                                          states[k], mode)
    new_hist = None
    if hist is not None and hist.shape[-1]:
        new_hist = torch.cat([hist[:, spec.channels:], x], dim=-1)
    return x, new_states, new_hist


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _frame_fn():
    fn = cuda_build.load("frame_rev").frame_rev_launch
    fn.argtypes = [_P] * 12 + [_I] * 7 + [ctypes.c_float, _I, _P, _P]
    fn.restype = _I
    return fn


@functools.cache
def _frame_rows_fn():
    fn = cuda_build.load("frame_rev").frame_rev_max_rows
    fn.argtypes = [_I] * 5 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def frame_max_rows(spec: FlowSpec, device_index: int) -> int:
    """The most rows one ``frame_rev`` launch plans for on the CUDA device
    ``device_index`` (``csrc/frame_rev.cu::frame_rev_max_rows``: the
    chain's plan)."""
    rows = ctypes.c_int(0)
    k, c, z1, _, h, cout = _spec_ints(spec)
    with torch.cuda.device(device_index):
        err = _frame_rows_fn()(k, c, z1, h, cout, ctypes.addressof(rows))
    _raise_on(err, "frame_rev's plan")
    return rows.value


@functools.cache
def _seq_fn():
    fn = cuda_build.load("seq_rev").seq_rev_launch
    fn.argtypes = [_P] * 17 + [_I] * 9 + [ctypes.c_float, _I, _P, _P]
    fn.restype = _I
    return fn


@functools.cache
def _gates_fn():
    fn = cuda_build.load("sample_gates").sample_gates_launch
    fn.argtypes = [_P] * 11 + [_I] * 10 + [_P, _P]
    fn.restype = _I
    return fn


@functools.cache
def _chain_fn():
    fn = cuda_build.load("sample_chain").sample_chain_launch
    fn.argtypes = ([_P] * 9 + [_I] * 7 + [ctypes.c_float] + [_I] * 4 + [_P, _I]
                   + [_P] * 2)
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
    spec = kernel_spec(spec)
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    cout, ind = spec.coupling_out_dim, spec.z1_dim + spec.cond.cond_dim
    shapes = {"w_ih_t": (k, ind, 3 * h), "w_hh_t": (k, h, 3 * h),
              "b_ih": (k, 3 * h), "b_hh": (k, 3 * h), "out_w_t": (k, h, cout),
              "out_b": (k, cout), "w_inv": (k, c, c), "an_bias": (k, c),
              "an_neg_logs_exp": (k, c), "chain": (k, chain_step_bytes(spec) // 4)}
    for name, shape in shapes.items():
        _check(name, getattr(w, name), shape, device)


def _spec_ints(spec: FlowSpec):
    return (spec.n_steps, spec.channels, spec.z1_dim, spec.cond.cond_dim,
            spec.hidden_channels, spec.coupling_out_dim)


# csrc/flow_step.cuh: the launchers' own refusals
_REFUSALS = {10001: "widths or shapes the kernel does not take",
             10002: "no launch plan fits the device"}


# CUDA's allocation failure (cudaErrorMemoryAllocation), named so that a
# caller can tell it from the others (train/tuning.py::is_out_of_memory)
_REFUSALS[2] = "CUDA error 2: out of memory"


def _raise_on(err: int, what: str):
    if err != 0:
        why = _REFUSALS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"{what} kernel launch failed: {why} "
                           f"({torch.cuda.get_device_name()})")


def _launcher_weight_ptrs(w: SamplingWeights):
    """The weights the launchers read: the gates' and the chain's."""
    return tuple(t.data_ptr() for t in (w.w_ih_t, w.w_hh_t, w.b_ih, w.b_hh,
                                       w.chain))


def _count_launches(call):
    """Run ``call(launches)`` with a fresh int[3] to which the launcher
    adds the gates and the chain launches it enqueued, and the gates
    launches of the tile plan; add them to the counters -> the launcher's
    return code."""
    launches = (ctypes.c_int * 3)()
    err = call(ctypes.addressof(launches))
    sample_gates.launches += launches[0]
    sample_gates.plans["vector"] += launches[0] - launches[2]
    sample_gates.plans["tile"] += launches[2]
    sample_chain.launches += launches[1]
    return err


def frame_rev_fused(spec: FlowSpec, weights: SamplingWeights, z, cond_projs,
                    states, *, precision: str | None = None):
    """Inverse of one frame through all K steps: z [B, C], cond_projs
    [K, B, cond] (pre-activation), states [K, B, H] -> (x [B, C],
    new_states [K, B, H]). On the card: one ``sample_gates`` launch (gc, gh)
    and one ``sample_chain`` launch, in equal segments of the batch where it
    has more rows than one launch plans for (``frame_max_rows``), a launch
    each. ``precision``: a name of ``MODES``, or None for the ambient one.
    ``weights`` in the kernel spec's lanes, z and x in the logical ones."""
    mode = precision_mode(precision)
    if not fused_supported(spec):
        raise ValueError("spec is outside the per-frame kernel's envelope")
    ks = kernel_spec(spec)
    if ks is not spec:
        x, new_states = frame_rev_fused(ks, weights, pad_lanes(spec, z),
                                        cond_projs, states, precision=precision)
        return unpad_lanes(spec, x), new_states
    if z.device.type == "cpu":
        return frame_rev_fused_ref(spec, weights, z, cond_projs, states, mode)
    if z.device.type != "cuda":
        raise ValueError(f"no sampling kernel for device {z.device}")
    b = z.shape[0]
    k, c, _, cond, h, _ = _spec_ints(spec)
    _check("z", z, (b, c), z.device)
    _check("cond_projs", cond_projs, (k, b, cond), z.device)
    _check("states", states, (k, b, h), z.device)
    _check_weights(spec, weights, z.device)
    rows = frame_max_rows(spec, z.device.index)
    if b > rows > 0:
        # the rows of z, cond_projs and states are independent
        segments = -(-b // rows)
        seg = -(-b // segments)
        outs = [frame_rev_fused(spec, weights, z[i:i + seg],
                                cond_projs[:, i:i + seg].contiguous(),
                                states[:, i:i + seg].contiguous(),
                                precision=precision)
                for i in range(0, b, seg)]
        return (torch.cat([x for x, _ in outs]),
                torch.cat([st for _, st in outs], dim=1))
    weights = round_sampling_weights(spec, weights, mode)
    x = torch.empty_like(z)
    new_states = torch.empty_like(states)
    gc = z.new_empty((k, b, 3 * h))
    gh = torch.empty_like(gc)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _count_launches(lambda launches: _frame_fn()(
        z.data_ptr(), cond_projs.data_ptr(), states.data_ptr(), x.data_ptr(),
        new_states.data_ptr(), *_launcher_weight_ptrs(weights), gc.data_ptr(),
        gh.data_ptr(), b, *_spec_ints(spec), float(spec.scale_eps), mode,
        stream, launches))
    _raise_on(err, "frame_rev")
    frame_rev_fused.launches += 1
    return x, new_states


frame_rev_fused.launches = 0


def sequence_rev_fused(spec: FlowSpec, weights: SamplingWeights, w_p1_t, zs,
                       fixed_projs, hist0, states0, *,
                       precision: str | None = None):
    """Generate a whole sequence: zs [N, B, C] latents, fixed_projs
    [N, K, B, cond] (the non-autoregressive part of every projection, bias
    included), hist0 [B, P1] flattened own-face history (oldest frame first),
    w_p1_t [K, P1, cond] own-face projection slice, states0 [K, B, H]
    -> xs [N, B, C]. P1 = 0 turns the own-face path off. On the card: per
    frame the ``sample_gates`` launches and one ``sample_chain`` launch, all
    from one call into ``csrc/seq_rev.cu``. ``precision`` and the lanes as
    in ``frame_rev_fused``: zs, xs, hist0 and w_p1_t in the logical ones."""
    mode = precision_mode(precision)
    if not sampling_seq_supported(spec):
        raise ValueError("spec is outside the sequence kernel's envelope")
    ks = kernel_spec(spec)
    if ks is not spec:
        return unpad_lanes(spec, sequence_rev_fused(
            ks, weights, pad_history(spec, w_p1_t, 1), pad_lanes(spec, zs),
            fixed_projs, pad_history(spec, hist0, 1), states0,
            precision=precision))
    if zs.device.type == "cpu":
        return sequence_rev_fused_ref(spec, weights, w_p1_t, zs, fixed_projs,
                                      hist0, states0, mode)
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
    weights = round_sampling_weights(spec, weights, mode)
    xs = torch.empty_like(zs)
    # scratch of the frame loop: the gates, two histories, the running states
    proj = zs.new_empty((k, b, cond) if p1 else (0,))
    gc = zs.new_empty((k, b, 3 * h))
    gh = torch.empty_like(gc)
    hist_a, hist_b = torch.empty_like(hist0), torch.empty_like(hist0)
    states = torch.empty_like(states0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _count_launches(lambda launches: _seq_fn()(
        zs.data_ptr(), fixed_projs.data_ptr(), hist0.data_ptr(),
        w_p1_t.data_ptr(), states0.data_ptr(), xs.data_ptr(),
        *_launcher_weight_ptrs(weights), proj.data_ptr(), gc.data_ptr(),
        gh.data_ptr(), hist_a.data_ptr(), hist_b.data_ptr(), states.data_ptr(),
        b, n, p1, *_spec_ints(spec), float(spec.scale_eps), mode, stream,
        launches))
    _raise_on(err, "seq_rev")
    sequence_rev_fused.launches += 1
    return xs


sequence_rev_fused.launches = 0


def _gates_plan_arg(plan: str | None, tile: int | None, rows: int,
                    groups: int) -> int:
    """csrc/sample_gates.cuh's ``plan`` for a wrapper's request."""
    if plan is None and tile is None:
        return 0
    if plan == "vector" and tile is None:
        return 1
    if plan in ("tile", None) and not (rows or groups):
        tile = GATES_TILE_DEFAULT if tile is None else tile
        if 0 <= tile < len(GATES_TILES):
            return 2 + tile
    raise ValueError(f"sample_gates: no plan {plan!r} with tile {tile!r}, "
                     f"rows {rows}, groups {groups}")


def sample_gates(spec: FlowSpec, weights: SamplingWeights, w_p1_t, fixed,
                 hist, states, *, precision: str | None = None, rows: int = 0,
                 groups: int = 0, plan: str | None = None,
                 tile: int | None = None):
    """The products of one frame that do not depend on the chain: fixed
    [K, B, cond] (the frame's non-autoregressive projections, or its whole
    cond_projs when P1 = 0), hist [B, P1], w_p1_t [K, P1, cond], states
    [K, B, H] -> (proj [K, B, cond], gc [K, B, 3H], gh [K, B, 3H]); proj is
    ``fixed`` itself when P1 = 0. ``plan``: "vector" or "tile", None for the
    launcher's (``gates_plan``); ``rows`` (batch rows per block) and
    ``groups`` (column groups of four per block, 8 or 32) tile the vector
    plan, 0 for its defaults; ``tile`` indexes ``GATES_TILES`` for the tile
    plan. ``precision`` as in ``frame_rev_fused``; all in the kernel spec's
    lanes."""
    mode = precision_mode(precision)
    plan_arg = _gates_plan_arg(plan, tile, rows, groups)
    if not fused_supported(spec):
        raise ValueError("spec is outside the per-frame kernel's envelope")
    spec = kernel_spec(spec)
    if fixed.device.type == "cpu":
        return sample_gates_ref(spec, weights, w_p1_t, fixed, hist, states,
                                mode)
    if fixed.device.type != "cuda":
        raise ValueError(f"no sampling kernel for device {fixed.device}")
    k, _, z1, cond, h, _ = _spec_ints(spec)
    b, p1 = hist.shape
    dev = fixed.device
    _check("fixed", fixed, (k, b, cond), dev)
    _check("hist", hist, (b, p1), dev)
    _check("w_p1_t", w_p1_t, (k, p1, cond), dev)
    _check("states", states, (k, b, h), dev)
    _check_weights(spec, weights, dev)
    weights = round_sampling_weights(spec, weights, mode)
    proj = torch.empty_like(fixed) if p1 else fixed
    gc = fixed.new_empty((k, b, 3 * h))
    gh = torch.empty_like(gc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _count_launches(lambda launches: _gates_fn()(
        fixed.data_ptr(), hist.data_ptr(), w_p1_t.data_ptr(), states.data_ptr(),
        weights.w_ih_t.data_ptr(), weights.w_hh_t.data_ptr(),
        weights.b_ih.data_ptr(), weights.b_hh.data_ptr(), proj.data_ptr(),
        gc.data_ptr(), gh.data_ptr(), b, p1, k, z1, cond, h, rows, groups,
        plan_arg, mode, stream, launches))
    _raise_on(err, "sample_gates")
    return proj, gc, gh


sample_gates.launches = 0
sample_gates.plans = {"vector": 0, "tile": 0}


def sample_chain(spec: FlowSpec, weights: SamplingWeights, z, gc, gh, states,
                 hist=None, *, precision: str | None = None, tile=(0, 0, 0),
                 resident: bool | None = None, trace=None):
    """The K reversed steps of one frame given its gates: z [B, C], gc and
    gh [K, B, 3H], states [K, B, H], hist [B, P1] or None -> (x [B, C],
    new_states [K, B, H], the next history [B, P1] or None). ``tile`` =
    (rows per tile, blocks per cluster, tiles per cluster), 0 for the
    launcher's plan. ``resident``: the weights in shared memory (True) or
    read from global memory (False), None for the plan's choice
    (``chain_resident``). ``trace``: None, or an int64 CUDA tensor [blocks,
    CHAIN_TRACE_SLOTS] that receives each block's device times (ns) of the
    first tile: start, cluster synchronised, z in hand, the end of each
    held step, the hand-off sent (``csrc/sample_chain.cuh``; "highest" and
    resident only). ``precision`` as in ``frame_rev_fused``; all in the
    kernel spec's lanes."""
    mode = precision_mode(precision)
    if not fused_supported(spec):
        raise ValueError("spec is outside the per-frame kernel's envelope")
    spec = kernel_spec(spec)
    if z.device.type == "cpu":
        return sample_chain_ref(spec, weights, z, gc, gh, states, hist, mode)
    if z.device.type != "cuda":
        raise ValueError(f"no sampling kernel for device {z.device}")
    b = z.shape[0]
    k, c, _, _, h, _ = _spec_ints(spec)
    dev = z.device
    _check("z", z, (b, c), dev)
    _check("gc", gc, (k, b, 3 * h), dev)
    _check("gh", gh, (k, b, 3 * h), dev)
    _check("states", states, (k, b, h), dev)
    p1 = 0 if hist is None else hist.shape[-1]
    if p1:
        _check("hist", hist, (b, p1), dev)
    _check_weights(spec, weights, dev)
    weights = round_sampling_weights(spec, weights, mode)
    x = torch.empty_like(z)
    new_states = torch.empty_like(states)
    new_hist = torch.empty_like(hist) if p1 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _count_launches(lambda launches: _chain_fn()(
        z.data_ptr(), gc.data_ptr(), gh.data_ptr(), states.data_ptr(),
        new_states.data_ptr(), x.data_ptr(), hist.data_ptr() if p1 else None,
        new_hist.data_ptr() if p1 else None, weights.chain.data_ptr(), b, p1,
        k, c, spec.z1_dim, h, spec.coupling_out_dim, float(spec.scale_eps),
        *tile, _place(resident), None if trace is None else trace.data_ptr(),
        mode, stream, launches))
    _raise_on(err, "sample_chain")
    return x, new_states, new_hist


sample_chain.launches = 0

CHAIN_TRACE_SLOTS = 32   # csrc/sample_chain.cuh
CHAIN_PLAN_KEYS = ("rows_per_tile", "cluster", "tiles_per_cluster", "clusters",
                   "blocks", "smem_bytes", "max_active_clusters", "resident")


def _place(resident: bool | None) -> int:
    """csrc/sample_chain.cuh::ChainWeights of a ``resident`` request."""
    return 0 if resident is None else (1 if resident else 2)


def chain_plan(spec: FlowSpec, b: int, tile=(0, 0, 0),
               resident: bool | None = None) -> dict:
    """The launch plan of ``sample_chain`` for B=b rows on the current CUDA
    device, with the clusters the device holds at once
    (``cudaOccupancyMaxActiveClusters``); ``tile`` and ``resident`` as in
    ``sample_chain``."""
    fn = cuda_build.load("sample_chain").sample_chain_plan
    fn.argtypes = [_I] * 10 + [_P]
    fn.restype = _I
    k, c, z1, _, h, cout = _spec_ints(kernel_spec(spec))
    out = (ctypes.c_int * len(CHAIN_PLAN_KEYS))()
    _raise_on(fn(b, k, c, z1, h, cout, *tile, _place(resident),
                 ctypes.addressof(out)), "sample_chain plan")
    return dict(zip(CHAIN_PLAN_KEYS, out))
