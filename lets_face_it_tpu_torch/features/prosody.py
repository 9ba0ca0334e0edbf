"""Prosodic features (pitch + intensity) in PyTorch (the port of
``lets_face_it_tpu/features/prosody.py``), replacing the reference's
Praat/parselmouth dependency (audio_utils.py:20-99).

Pitch follows Boersma (1993), the algorithm behind Praat's ``to_pitch``:
per frame, subtract the local mean, apply a Hanning window, estimate the
normalized autocorrelation r_x = r_xw / r_w (dividing out the window's own
autocorrelation), refine each local maximum by band-limited (sinc)
interpolation on a fine lag grid, pick the strongest candidates against a
voicing threshold, then Viterbi path-smooth across frames with octave/jump
costs. Intensity is Praat's ``To Intensity``: dB SPL re 2e-5 of the
mean-square pressure under a Kaiser-20 window of physical duration
6.4/min_pitch (effective 3.2/min_pitch).

Frame layout matches Praat: a comb of ``window_dur``-long frames at
``time_step`` spacing, centered as a whole in the sound; tracks are then
sampled at the reference's query times by linear interpolation (Praat's
``Get value at time``), voiced-aware for pitch. The layout arithmetic runs on
the host; the per-frame analysis is one batched ``[n_frames, window]`` FFT
autocorrelation on the device, and the Viterbi smoothing a loop over frames
there (one max-reduction of a [C, C] table a frame).

The derivative/stacking/resampling driver matches audio_utils.py:49-99.
"""

from __future__ import annotations

import numpy as np
import torch

from lets_face_it_tpu_torch.features.dsp import as_signal, resample_fourier

# Praat-like defaults
PITCH_FLOOR = 75.0
PITCH_CEILING = 600.0
VOICING_THRESHOLD = 0.45
SILENCE_THRESHOLD = 0.03
OCTAVE_COST = 0.01
OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14
N_CANDIDATES = 15

_SINC_HALF_WIDTH = 8    # autocorrelation samples each side of a peak
_SINC_UPSAMPLE = 16     # fine-grid points per lag sample


def praat_frame_layout(n_samples: int, fs: float, window_dur: float,
                       time_step: float):
    """Praat's centered frame layout: as many ``window_dur`` frames as fit at
    ``time_step`` spacing, the whole comb centered in the sound. Returns
    (frame start indices [N] np.int32, frame center times [N] np.float64,
    frame_len), computed on the host."""
    duration = n_samples / fs
    frame_len = int(round(window_dur * fs))
    if n_samples < frame_len:
        # Praat likewise reports "sound too short" for the AC method when
        # less than one analysis window fits.
        raise ValueError(
            f"sound too short for the analysis window: {n_samples} samples "
            f"< {frame_len} ({window_dur:.4f}s at fs={fs})")
    n_frames = int(np.floor((duration - window_dur) / time_step)) + 1
    n_frames = max(n_frames, 1)
    t_mid_first = 0.5 * (duration - (n_frames - 1) * time_step)
    centers = t_mid_first + np.arange(n_frames) * time_step
    starts = np.round(centers * fs - frame_len / 2).astype(np.int64)
    starts = np.clip(starts, 0, max(n_samples - frame_len, 0))
    return starts.astype(np.int32), centers, frame_len


def _frames(x: torch.Tensor, starts: np.ndarray, frame_len: int) -> torch.Tensor:
    """[N, frame_len] windows of ``x`` at ``starts``, each minus its mean."""
    idx = (torch.as_tensor(starts.astype(np.int64), device=x.device)[:, None]
           + torch.arange(frame_len, device=x.device)[None, :])
    frames = x[idx]
    return frames - torch.mean(frames, dim=1, keepdim=True)


def pitch_candidates(x, *, fs: int, time_step: float = 0.05,
                     floor: float = PITCH_FLOOR, ceiling: float = PITCH_CEILING,
                     device="cuda"):
    """Per-frame pitch candidates via windowed autocorrelation with sinc
    peak refinement, computed on ``device``.

    Returns (freqs [N, C], strengths [N, C], local_peak [N]) where candidate
    0 is "unvoiced". Window = 3 periods of the pitch floor (Boersma's choice
    for the AC method), frames Praat-centered (``pitch_frame_centers`` gives
    their times).
    """
    x = as_signal(x, device)
    dev = x.device
    starts, _, frame_len = praat_frame_layout(
        x.shape[0], fs, 3.0 / floor, time_step)
    n_frames = len(starts)
    nfft = int(2 ** np.ceil(np.log2(frame_len * 2)))

    frames = _frames(x, starts, frame_len)             # [N, L]

    # local (frame) peak amplitude relative to global, for the silence test
    global_peak = torch.max(torch.abs(x - torch.mean(x))) + 1e-12
    local_peak = torch.amax(torch.abs(frames), dim=1)
    local_intensity = local_peak / global_peak

    win = torch.as_tensor(np.hanning(frame_len).astype(np.float32), device=dev)
    xw = frames * win

    # normalized autocorrelation r_x(t) = r_xw(t) / r_w(t)
    spec = torch.fft.rfft(xw, n=nfft, dim=1)
    r_xw = torch.fft.irfft(spec * torch.conj(spec), n=nfft, dim=1)[:, :frame_len]
    r_xw = r_xw / (r_xw[:, :1] + 1e-12)
    wspec = torch.fft.rfft(win, n=nfft)
    r_w = torch.fft.irfft(wspec * torch.conj(wspec), n=nfft)[:frame_len]
    r_w = r_w / r_w[0]
    r = r_xw / (r_w[None, :] + 1e-12)                  # [N, L]

    min_lag = int(np.floor(fs / ceiling))
    max_lag = int(np.ceil(fs / floor))
    max_lag = min(max_lag, frame_len - 1)
    lags = torch.arange(frame_len, device=dev)

    # local maxima of r within [min_lag, max_lag]
    is_peak = ((r > torch.roll(r, 1, dims=1)) & (r >= torch.roll(r, -1, dims=1))
               & (lags[None, :] >= min_lag) & (lags[None, :] <= max_lag))
    peak_strength = torch.where(is_peak, r, -torch.inf)

    # top C-1 voiced candidates per frame (by unrefined peak height). Where a
    # frame has fewer peaks, the -inf entries' indices are arbitrary: the
    # mask pins them to lag 0 before any use, and every output of theirs is
    # masked below.
    top_vals, top_idx = torch.topk(peak_strength, N_CANDIDATES - 1, dim=1)
    found = torch.isfinite(top_vals)                   # [N, C-1]
    lag_int = torch.where(found, top_idx, 0)           # [N, C-1] integer lags

    # band-limited (sinc) refinement: evaluate r on a fine grid spanning
    # lag +- 1 sample from the +-HALF_WIDTH integer-lag neighbourhood. The
    # sinc weight matrix depends only on (fine offset - support offset), so
    # it is one constant [F, S] product for every candidate of every frame.
    offsets = np.arange(-_SINC_HALF_WIDTH, _SINC_HALF_WIDTH + 1)
    rel = np.linspace(-1.0, 1.0, 2 * _SINC_UPSAMPLE + 1)
    weights = torch.as_tensor(
        np.sinc(rel[:, None] - offsets[None, :]).astype(np.float32),
        device=dev)                                    # [F, S]
    support = torch.clamp(
        lag_int[..., None] + torch.as_tensor(offsets, device=dev),
        0, frame_len - 1)                              # [N, C-1, S]
    # one gather along the lag axis of r, for all candidates at once (no
    # [N, C-1, L] copy of r)
    sup_vals = torch.gather(r, 1, support.reshape(n_frames, -1)).reshape(
        support.shape)                                 # [N, C-1, S]
    fine = torch.einsum("fs,ncs->ncf", weights, sup_vals)  # [N, C-1, F]
    k_best = torch.argmax(fine, dim=-1)
    rel_t = torch.as_tensor(rel.astype(np.float32), device=dev)
    lag_ref = lag_int + rel_t[k_best]
    str_ref = torch.gather(fine, -1, k_best[..., None])[..., 0]

    cand_freq = torch.where(found, fs / torch.clamp_min(lag_ref, 1e-6), 0.0)
    in_range = (cand_freq >= floor) & (cand_freq <= ceiling) & (str_ref > 0)
    keep = found & in_range
    cand_str = torch.where(
        keep,
        torch.clamp_max(str_ref, 1.0) - OCTAVE_COST * torch.log2(
            torch.clamp_min(ceiling / torch.clamp_min(cand_freq, 1e-6), 1e-6)),
        -1e30)
    cand_freq = torch.where(keep, cand_freq, 0.0)

    # unvoiced candidate strength (Boersma eq. 23): the silence term compares
    # local/global peak against silence_threshold / (1 + voicing_threshold)
    unvoiced = (VOICING_THRESHOLD
                + torch.clamp_min(2.0 - local_intensity
                                  * (1.0 + VOICING_THRESHOLD)
                                  / SILENCE_THRESHOLD, 0.0))
    freqs = torch.cat([torch.zeros((n_frames, 1), device=dev), cand_freq], dim=1)
    strengths = torch.cat([unvoiced[:, None], cand_str], dim=1)
    return freqs, strengths, local_peak


def pitch_frame_centers(n_samples: int, fs: float, time_step: float = 0.05,
                        floor: float = PITCH_FLOOR) -> np.ndarray:
    """Center times of ``pitch_candidates``' frames."""
    _, centers, _ = praat_frame_layout(n_samples, fs, 3.0 / floor, time_step)
    return centers


def _transition_cost(f_prev: torch.Tensor, f_next: torch.Tensor) -> torch.Tensor:
    both_voiced = (f_prev > 0) & (f_next > 0)
    switch = (f_prev > 0) != (f_next > 0)
    jump = torch.where(
        both_voiced,
        OCTAVE_JUMP_COST * torch.abs(torch.log2(
            torch.clamp_min(f_prev, 1e-6) / torch.clamp_min(f_next, 1e-6))),
        0.0)
    return jump + torch.where(switch, VOICED_UNVOICED_COST, 0.0)


def viterbi_pitch(freqs: torch.Tensor, strengths: torch.Tensor) -> torch.Tensor:
    """Path-smoothed pitch track: maximize sum of strengths minus transition
    costs (octave jumps, voiced/unvoiced switches). Returns f0 [N] (0 where
    unvoiced) on the inputs' device.

    The transition costs of all frame pairs are one batched [N-1, C, C]
    operation; the forward pass is a loop over frames on the device (the
    best predecessor of each candidate is the FIRST maximum, as
    ``jnp.argmax`` takes it); the backtrack chases the [N-1, C] pointers on
    the host, one copy, then gathers the track on the device."""
    n = freqs.shape[0]
    trans = _transition_cost(freqs[:-1, :, None], freqs[1:, None, :])  # [N-1, C, C]
    score = strengths[0].clone()
    backptr = torch.empty((n - 1, freqs.shape[1]), dtype=torch.long,
                          device=freqs.device)
    for t in range(1, n):
        total = (score[:, None] - trans[t - 1]) + strengths[t][None, :]
        torch.max(total, dim=0, out=(score, backptr[t - 1]))

    # backtrack: backptr[t][j] = best candidate at frame t given candidate j
    # at frame t+1
    bp = backptr.cpu().numpy()
    path = np.empty(n, np.int64)
    path[-1] = int(torch.argmax(score))
    for t in range(n - 2, -1, -1):
        path[t] = bp[t, path[t + 1]]
    path_t = torch.as_tensor(path, device=freqs.device)
    return torch.gather(freqs, 1, path_t[:, None])[:, 0]


def intensity_db(x, *, fs: int, time_step: float = 0.05,
                 min_pitch: float = 100.0, device="cuda") -> torch.Tensor:
    """Praat's ``To Intensity``: dB re 2e-5 of mean-square amplitude under a
    Kaiser-20 window (beta = 2*pi^2 + 0.5, sidelobes < -190 dB) of physical
    duration 6.4/min_pitch (effective duration 3.2/min_pitch) on
    Praat-centered frames (``intensity_frame_centers``), on ``device``."""
    x = as_signal(x, device)
    starts, _, frame_len = praat_frame_layout(
        x.shape[0], fs, 6.4 / min_pitch, time_step)
    frames = _frames(x, starts, frame_len)
    win = torch.as_tensor(
        np.kaiser(frame_len, 2.0 * np.pi * np.pi + 0.5).astype(np.float32),
        device=x.device)
    power = torch.sum(frames ** 2 * win, dim=1) / torch.sum(win)
    return 10.0 * torch.log10(torch.clamp_min(power, 1e-30) / (2e-5 ** 2))


def intensity_frame_centers(n_samples: int, fs: float,
                            time_step: float = 0.05,
                            min_pitch: float = 100.0) -> np.ndarray:
    """Center times of ``intensity_db``'s frames."""
    _, centers, _ = praat_frame_layout(n_samples, fs, 6.4 / min_pitch,
                                       time_step)
    return centers


def _sample_track(centers, values, query, voiced_aware: bool):
    """Praat ``Get value at time``: linear interpolation between frame
    centers, 0 outside the track. For pitch, a query strictly between a
    voiced and an unvoiced frame is unvoiced (interpolating across the
    boundary is meaningless), but a query ON a frame center (0.1 ms
    tolerance, edges included) takes that frame's own value — Praat
    reports the frame, neighbours regardless. The reference then
    nan_to_num's Praat's NaNs to 0 (audio_utils.py:29-35).

    Runs on the HOST in float64: the time grids of an hour-long session
    cannot be represented in float32 at sub-tolerance precision (one f32
    ulp at t = 2000 s is 0.24 ms), and this is trivial [N]-length work —
    only the per-frame analysis above belongs on the accelerator."""
    centers = np.asarray(centers, np.float64)
    values = np.asarray(values, np.float64)
    query = np.asarray(query, np.float64)
    out = np.interp(query, centers, values)
    idx = np.clip(np.searchsorted(centers, query), 1, len(centers) - 1)
    on_left = np.abs(query - centers[idx - 1]) < 1e-4
    on_right = np.abs(query - centers[idx]) < 1e-4
    if voiced_aware:
        either_unvoiced = (values[idx - 1] <= 0) | (values[idx] <= 0)
        out = np.where(
            on_left, values[idx - 1],
            np.where(on_right, values[idx],
                     np.where(either_unvoiced, 0.0, out)))
    else:
        out = np.where(on_left, values[idx - 1],
                       np.where(on_right, values[idx], out))
    inside = ((query >= centers[0]) & (query <= centers[-1])) | on_left | on_right
    return np.where(inside, out, 0.0)


def compute_prosody(x, fs: int, time_step: float = 0.05, device="cuda"):
    """Pitch + intensity tracks sampled like the reference's
    ``compute_prosody`` (audio_utils.py:20-46): query times
    arange(0, duration - time_step, time_step), linear interpolation from the
    Praat-centered analysis frames, Chiu'11 log-normalization. Returns two
    float32 tensors on ``device``."""
    x = as_signal(x, device)
    n_samples = int(x.shape[0])
    duration = n_samples / fs
    query = np.arange(0, duration - time_step, time_step)

    freqs, strengths, _ = pitch_candidates(x, fs=fs, time_step=time_step,
                                           device=x.device)
    f0 = viterbi_pitch(freqs, strengths)
    inten = intensity_db(x, fs=fs, time_step=time_step, device=x.device)

    pitch_values = _sample_track(
        pitch_frame_centers(n_samples, fs, time_step), f0.cpu().numpy(), query,
        voiced_aware=True)
    intensity_values = _sample_track(
        intensity_frame_centers(n_samples, fs, time_step), inten.cpu().numpy(),
        query, voiced_aware=False)

    intensity_values = np.clip(intensity_values, np.finfo(np.float32).eps,
                               None)
    pitch_norm = np.clip(np.log(pitch_values + 1.0) - 4.0, 0.0, None)
    intensity_norm = np.clip(np.log(intensity_values) - 3.0, 0.0, None)
    return (torch.as_tensor(pitch_norm.astype(np.float32), device=x.device),
            torch.as_tensor(intensity_norm.astype(np.float32), device=x.device))


def _derivative(f: torch.Tensor, dx_ms: float) -> torch.Tensor:
    """Finite difference as the reference computes it (audio_utils.py:49-69):
    convolve with [1, -1]/dx, first element zeroed."""
    zero = torch.zeros(1, dtype=f.dtype, device=f.device)
    cf = (torch.cat([f, zero]) - torch.cat([zero, f])) / dx_ms
    return torch.cat([zero, cf[1:-1]])


def extract_prosodic_features(x, fs: int, nb_frames: int,
                              time_step: float = 0.02, device="cuda"):
    """4-D prosody stacked and resampled to the video frame count
    (audio_utils.py:72-99): [energy, energy', pitch, pitch'] -> [nb_frames, 4],
    on ``device``."""
    pitch, energy = compute_prosody(x, fs, time_step, device=device)
    dx_ms = time_step * 1000.0
    energy_der = _derivative(energy, dx_ms)
    pitch_der = _derivative(pitch, dx_ms)
    feats = torch.stack([energy, energy_der, pitch, pitch_der], dim=1)
    return resample_fourier(feats, nb_frames)
