"""Normalizing-flow primitive ops as plain functions on tensors.

The port of ``lets_face_it_tpu/core/ops.py``; semantics match the reference
glow_pytorch flow modules (``modules.py``, ``thops.py``):

* actnorm / invconv log-determinants are multiplied by the channel count C
  (the reference's "per-pixel" convention applied to channels,
  modules.py:62,171);
* the affine-coupling scale is ``clamp(sigmoid(s + 2), min=scale_eps)``
  (models.py:335);
* the coupling halves are contiguous ("split"), while shift/scale come from
  the even/odd interleave ("cross") of the transform-net output
  (thops.py:36-44);
* the inverse of the LU 1x1 transform is taken with triangular solves, as in
  the JAX package (the sampling kernels get an explicit float64 inverse from
  ``ops/flow_kernels.py::prepare_sampling_weights``).

All flow ops take and return ``(z, logdet)`` with a per-sample ``[B]`` logdet.
Parameters are mappings of tensors (``dict`` or ``nn.ParameterDict``).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F

LOG2PI = math.log(2.0 * math.pi)
LN2 = math.log(2.0)


def _seed_from(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=generator))


def uniform_init(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


# ---------------------------------------------------------------------------
# ActNorm
# ---------------------------------------------------------------------------

def init_actnorm(num_features: int) -> dict:
    """Zeros until a data-dependent init sets them (imported checkpoints are
    always treated as initialised)."""
    return {"bias": torch.zeros(num_features), "logs": torch.zeros(num_features)}


def actnorm_data_init(x, scale: float = 1.0) -> dict:
    """Data-dependent init from a batch [B, C]: output has ~zero mean, unit
    variance (modules.py:32-43): bias = -mean(x), logs = log(scale/(std+1e-6))."""
    bias = -x.mean(dim=0)
    var = ((x + bias) ** 2).mean(dim=0)
    return {"bias": bias, "logs": torch.log(scale / (torch.sqrt(var) + 1e-6))}


def actnorm_fwd(params, x, logdet):
    """(x + bias) * exp(logs); dlogdet = sum(logs) * C."""
    z = (x + params["bias"]) * torch.exp(params["logs"])
    return z, logdet + params["logs"].sum() * x.shape[-1]


def actnorm_rev(params, z, logdet):
    x = z * torch.exp(-params["logs"]) - params["bias"]
    return x, logdet - params["logs"].sum() * z.shape[-1]


# ---------------------------------------------------------------------------
# Invertible 1x1 "conv" (dense CxC mix), LU-decomposed
# ---------------------------------------------------------------------------

def init_invconv_lu(generator: torch.Generator, num_channels: int) -> dict:
    """Random orthogonal W = P L U (numpy QR then scipy LU in float64, as
    core/ops.py:75-90 of the JAX package); P and sign(s) are frozen buffers,
    strictly-lower L, log|s| and strictly-upper U are trained."""
    rng = np.random.default_rng(_seed_from(generator))
    w = np.linalg.qr(rng.standard_normal((num_channels, num_channels)))[0]
    p, l, u = scipy.linalg.lu(w.astype(np.float64))
    s = np.diag(u)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)

    return {
        "p": f32(p),
        "sign_s": f32(np.sign(s)),
        "l": f32(np.tril(l, -1)),
        "log_s": f32(np.log(np.abs(s))),
        "u": f32(np.triu(u, 1)),
    }


def lu_factors(params):
    """(L, U) with the masks and the signed diagonal applied."""
    l_raw = params["l"]
    c = params["log_s"].shape[-1]
    eye = torch.eye(c, dtype=l_raw.dtype, device=l_raw.device)
    l_mask = torch.tril(torch.ones(c, c, dtype=l_raw.dtype,
                                   device=l_raw.device), -1)
    l = l_raw * l_mask + eye
    u = (params["u"] * l_mask.T
         + torch.diag_embed(params["sign_s"] * torch.exp(params["log_s"])))
    return l, u


def invconv_weight(params):
    """W = P L U."""
    l, u = lu_factors(params)
    return params["p"] @ l @ u


def invconv_fwd(params, x, logdet):
    """z = x @ (P L U); dlogdet = sum(log|s|) * C."""
    z = x @ invconv_weight(params)
    return z, logdet + params["log_s"].sum() * x.shape[-1]


def invconv_rev(params, z, logdet):
    """x = z @ (P L U)^-1 via two triangular solves and a P^T rotation:
    solve y U = z (upper, from the right), then b L = y (unit lower)."""
    l, u = lu_factors(params)
    a = torch.linalg.solve_triangular(u, z, upper=True, left=False)
    b = torch.linalg.solve_triangular(l, a, upper=False, left=False,
                                      unitriangular=True)
    x = b @ params["p"].T
    return x, logdet - params["log_s"].sum() * z.shape[-1]


# ---------------------------------------------------------------------------
# Fixed permutations (shuffle / reverse)
# ---------------------------------------------------------------------------

def init_permute(generator: torch.Generator, num_channels: int,
                 shuffle: bool) -> dict:
    if shuffle:
        perm = torch.randperm(num_channels, generator=generator)
    else:
        perm = torch.arange(num_channels - 1, -1, -1)
    return {"perm": perm, "inv": torch.argsort(perm)}


def permute_fwd(params, x, logdet):
    return x[..., params["perm"]], logdet


def permute_rev(params, z, logdet):
    return z[..., params["inv"]], logdet


# ---------------------------------------------------------------------------
# Linear layers
# ---------------------------------------------------------------------------

def init_linear(generator: torch.Generator, in_features: int,
                out_features: int) -> dict:
    """torch.nn.Linear default init: U(-k, k), k = 1/sqrt(fan_in)."""
    k = 1.0 / math.sqrt(in_features)
    return {"w": uniform_init(generator, (out_features, in_features), k),
            "b": uniform_init(generator, (out_features,), k)}


def linear(params, x):
    return x @ params["w"].T + params["b"]


def init_linear_zeros(in_features: int, out_features: int) -> dict:
    """Zero-init linear with a learned log-scale (modules.py:83-95)."""
    return {"w": torch.zeros(out_features, in_features),
            "b": torch.zeros(out_features),
            "logs": torch.zeros(out_features)}


def linear_zeros(params, x, logscale_factor: float = 3.0):
    """(x W^T + b) * exp(logs * 3)."""
    return ((x @ params["w"].T + params["b"])
            * torch.exp(params["logs"] * logscale_factor))


# ---------------------------------------------------------------------------
# Coupling-half helpers (thops.py:36-48)
# ---------------------------------------------------------------------------

def split_half(z):
    """Contiguous halves along channels: (z[:, :C//2], z[:, C//2:])."""
    c = z.shape[-1]
    return z[..., : c // 2], z[..., c // 2:]


def split_cross(h):
    """Even/odd interleave -> (shift, scale_raw)."""
    return h[..., 0::2], h[..., 1::2]


def cat_half(z1, z2):
    return torch.cat([z1, z2], dim=-1)


def affine_scale(scale_raw, scale_eps: float):
    """clamp(sigmoid(s + 2), min=scale_eps) — models.py:335."""
    return torch.clamp(torch.sigmoid(scale_raw + 2.0), min=scale_eps)


def leaky_relu(x):
    return F.leaky_relu(x, 0.01)


# ---------------------------------------------------------------------------
# Standard-normal base density (modules.py:197-235)
# ---------------------------------------------------------------------------

def gaussian_logp(z):
    """Per-sample sum over channels of log N(z; 0, 1)."""
    return torch.sum(-0.5 * (z ** 2 + LOG2PI), dim=-1)
