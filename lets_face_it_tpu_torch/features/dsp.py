"""Core DSP primitives in PyTorch (the port of
``lets_face_it_tpu/features/dsp.py``): FFT resampling, framing, RMS energy,
dB conversion and Savitzky-Golay filtering, on the device of their input.

* ``resample_fourier`` == ``scipy.signal.resample`` (FFT method, including the
  optional spectral window and Nyquist-bin handling)
* ``savgol_filter`` == ``scipy.signal.savgol_filter(..., mode='interp')``:
  interior correlation plus exact polynomial edge fits, from coefficient
  matrices built on the host
* ``rms_frames`` / ``amplitude_to_db`` == librosa.feature.rms +
  librosa.amplitude_to_db defaults

Every function takes and returns float32 tensors; the host-side tables
(windows, savgol coefficients) are built in float64 with numpy/scipy and
rounded to float32 once, as the JAX package builds them.
"""

from __future__ import annotations

import numpy as np
import torch

from lets_face_it_tpu_torch.utils.device import resolve_device


def as_signal(x, device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a float32 tensor on ``device``."""
    device = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ---------------------------------------------------------------------------
# Fourier resampling (scipy.signal.resample semantics)
# ---------------------------------------------------------------------------

def resample_fourier(x: torch.Tensor, num: int, window: str | None = None):
    """Resample real input along dim 0 to ``num`` samples via the FFT method.

    Matches scipy.signal.resample's rfft path: optional spectral window
    (fftshifted symmetric window, folded onto the half spectrum), truncate
    to min(num, nx) bins, double/halve the unpaired Nyquist bin (only when
    that count is even and ``num != nx``), and inverse-FFT scaled by num/nx.
    """
    nx = x.shape[0]
    m = min(num, nx)
    m2 = m // 2 + 1
    X = torch.fft.rfft(x, dim=0)
    n_half = X.shape[0]

    if window is not None:
        w = np.fft.fftshift(_get_window(window, nx))
        # fold the two-sided window onto the one-sided spectrum (float32,
        # as the JAX package folds it)
        w[1:n_half] = (w[1:n_half] + w[:-n_half:-1]) / np.float32(2.0)
        w = torch.as_tensor(w[:n_half], device=x.device)
        X = X * w.reshape((-1,) + (1,) * (x.dim() - 1))

    X = X[:m2]
    if m % 2 == 0 and num != nx:
        scale = torch.ones(X.shape[0], dtype=torch.float32, device=x.device)
        scale[m // 2] = 2.0 if num < nx else 0.5
        X = X * scale.reshape((-1,) + (1,) * (x.dim() - 1))

    return torch.fft.irfft(X * (float(num) / float(nx)), n=num, dim=0)


def _get_window(name: str, n: int) -> np.ndarray:
    """Symmetric window (host, float64 rounded to float32)."""
    import scipy.signal

    return scipy.signal.get_window(name, n, fftbins=False).astype(np.float32)


# ---------------------------------------------------------------------------
# Framing / energy
# ---------------------------------------------------------------------------

def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int, *,
                 center: bool = True) -> torch.Tensor:
    """[T] -> [n_frames, frame_length]; librosa-style centered framing with
    zero padding (a strided view of the padded signal)."""
    if center:
        pad = frame_length // 2
        x = torch.nn.functional.pad(x, (pad, pad))
    return x.unfold(0, frame_length, hop_length)


def rms_frames(x: torch.Tensor, frame_length: int, hop_length: int):
    """librosa.feature.rms defaults: centered frames, constant padding."""
    frames = frame_signal(x, frame_length, hop_length)
    return torch.sqrt(torch.mean(frames ** 2, dim=1))


def amplitude_to_db(s: torch.Tensor, *, ref: float = 1.0, amin: float = 1e-5,
                    top_db: float | None = 80.0):
    """librosa.amplitude_to_db: 20*log10(max(amin,|s|)) - 20*log10(ref),
    floored at (max - top_db)."""
    power_db = 20.0 * torch.log10(torch.clamp_min(torch.abs(s), amin))
    power_db = power_db - 20.0 * float(np.log10(np.float32(max(amin, ref))))
    if top_db is not None:
        power_db = torch.maximum(power_db, power_db.max() - top_db)
    return power_db


# ---------------------------------------------------------------------------
# Savitzky-Golay
# ---------------------------------------------------------------------------

def _savgol_matrices(window_length: int, polyorder: int):
    """Host-side float32: (conv coefficients [win], edge fit matrix
    [win, win]).

    The edge matrix maps the first ``win`` samples to the polynomial-fit
    values at positions 0..win-1 (scipy mode='interp' evaluates the LSQ poly
    fitted to the edge window)."""
    import scipy.signal

    # deriv=0 savgol smoothing kernels are symmetric, so correlation and
    # convolution coincide
    coeffs = scipy.signal.savgol_coeffs(window_length, polyorder)
    # LSQ poly fit: x_fit = V (V^T V)^-1 V^T x over the window
    t = np.arange(window_length, dtype=np.float64)
    V = np.vander(t, polyorder + 1, increasing=True)
    proj = V @ np.linalg.pinv(V)
    return coeffs.astype(np.float32), proj.astype(np.float32)


def savgol_filter(x: torch.Tensor, window_length: int, polyorder: int):
    """scipy.signal.savgol_filter(..., mode='interp') along dim 0.

    x: [T] or [T, D]; T must be >= window_length. The interior is the
    correlation of every window with the coefficients, one product over a
    [T - win + 1, D, win] view (no convolution routine, so no TF32).
    """
    coeffs, edge_proj = (torch.as_tensor(a, device=x.device)
                         for a in _savgol_matrices(window_length, polyorder))
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    half = window_length // 2

    # interior: value at each window's centre
    interior = torch.einsum("w,tdw->td", coeffs, x.unfold(0, window_length, 1))
    head = edge_proj[:half] @ x[:window_length]
    tail = edge_proj[window_length - half:] @ x[-window_length:]
    out = torch.cat([head, interior, tail], dim=0)
    return out[:, 0] if squeeze else out
