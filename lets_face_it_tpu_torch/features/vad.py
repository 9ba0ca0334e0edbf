"""Crosstalk voice-activity detection (the port of
``lets_face_it_tpu/features/vad.py``; reference audio_utils.py:144-188):
per-channel 100 Hz RMS energy in dB; a channel is "active alone" when it is
above an absolute threshold AND above the other channel by a margin; the
boolean track is savgol-smoothed, Fourier-resampled (hamming spectral window)
to the video frame count, and binarized at 0.1."""

from __future__ import annotations

import torch

from lets_face_it_tpu_torch.features.dsp import (
    amplitude_to_db,
    as_signal,
    resample_fourier,
    rms_frames,
    savgol_filter,
)


def crosstalk_tracks(x1, x2, fs: int, frame_count: int, *, tha: float = 30.0,
                     thb: float = 5.0, savgol_win: int = 301,
                     savgol_poly_order: int = 1, sample_scale: float = 32768.0,
                     device="cuda"):
    """The two activity tracks of ``crosstalk_vad`` before binarization:
    smoothed, resampled to ``frame_count`` and clipped to [0, 1]."""
    x1 = as_signal(x1, device) * sample_scale
    x2 = as_signal(x2, device) * sample_scale

    frame_length = int(fs * 0.02)
    hop_length = int(fs * 0.01)
    e1 = amplitude_to_db(rms_frames(x1, frame_length, hop_length))
    e2 = amplitude_to_db(rms_frames(x2, frame_length, hop_length))

    s1 = ((e1 > tha) & (e1 > e2 + thb)).float()
    s2 = ((e2 > tha) & (e2 > e1 + thb)).float()

    return tuple(
        torch.clamp(resample_fourier(savgol_filter(s, savgol_win,
                                                   savgol_poly_order),
                                     frame_count, window="hamming"), 0.0, 1.0)
        for s in (s1, s2))


def crosstalk_vad(x1, x2, fs: int, frame_count: int, *, tha: float = 30.0,
                  thb: float = 5.0, savgol_win: int = 301,
                  savgol_poly_order: int = 1, sample_scale: float = 32768.0,
                  device="cuda"):
    """Returns (s1 [frame_count], s2 [frame_count]) binary activity tracks
    on ``device``.

    tha: absolute dB level for channel activity; thb: minimum dB difference
    between channels to attribute speech to one speaker only. The reference's
    30 dB threshold assumes int16-scale samples (it feeds ``wav.read`` output
    straight to librosa, audio_utils.py:158-170); ``sample_scale`` restores
    that scale for callers passing [-1, 1]-normalized audio.
    """
    s1x, s2x = crosstalk_tracks(
        x1, x2, fs, frame_count, tha=tha, thb=thb, savgol_win=savgol_win,
        savgol_poly_order=savgol_poly_order, sample_scale=sample_scale,
        device=device)
    return (s1x >= 0.1).float(), (s2x >= 0.1).float()
