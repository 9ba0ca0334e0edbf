"""MFCC extraction in PyTorch (the port of ``lets_face_it_tpu/features/mfcc.py``),
formula-compatible with ``python_speech_features`` as the reference uses it
(audio_utils.py:209-235: 26 cepstra, 20 ms window, 10 ms step, NFFT 1024,
then Fourier-resampled to the video frame count).

python_speech_features defaults replicated: preemphasis 0.97, rectangular
window, power spectrum |FFT|^2/NFFT, 26 triangular mel filters over
[0, fs/2] (HTK mel formula 2595*log10(1+f/700)), log filterbank energies
(eps-floored), orthonormal DCT-II, ceplifter 22, first coefficient replaced
with log total frame energy (appendEnergy=True).

The whole utterance is one ``[n_frames, nfft]`` FFT batch on the device; the
filterbank, DCT and lifter tables are built on the host in float64 and
rounded to float32 once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lets_face_it_tpu_torch.features.dsp import as_signal, resample_fourier


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank(nfilt: int, nfft: int, samplerate: float,
                   lowfreq: float = 0.0, highfreq: float | None = None):
    """[nfilt, nfft//2+1] triangular filters (python_speech_features.get_filterbanks)."""
    highfreq = highfreq or samplerate / 2.0
    mels = np.linspace(hz_to_mel(lowfreq), hz_to_mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel_to_hz(mels) / samplerate).astype(int)

    fbank = np.zeros((nfilt, nfft // 2 + 1), np.float64)
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


def _lifter_coeffs(numcep: int, ceplifter: int = 22):
    n = np.arange(numcep)
    return 1.0 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter)


def _dct2_ortho_matrix(n_in: int, n_out: int):
    """Orthonormal DCT-II matrix [n_out, n_in] (scipy.fftpack.dct norm='ortho')."""
    k = np.arange(n_out)[:, None]
    i = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2.0 * n_in))
    m *= np.sqrt(2.0 / n_in)
    m[0] *= 1.0 / math.sqrt(2.0)
    return m


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def mfcc(signal, *, samplerate: int, winlen: float = 0.02,
         winstep: float = 0.01, numcep: int = 26, nfilt: int = 26,
         nfft: int = 1024, preemph: float = 0.97, ceplifter: int = 22,
         append_energy: bool = True, device="cuda") -> torch.Tensor:
    """[T] samples -> [n_frames, numcep] MFCCs, computed on ``device``."""
    signal = as_signal(signal, device)
    dev = signal.device

    # preemphasis: y[0]=x[0], y[t]=x[t]-a*x[t-1]
    emph = torch.cat([signal[:1], signal[1:] - preemph * signal[:-1]])

    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    slen = emph.shape[0]
    if slen <= frame_len:
        n_frames = 1
    else:
        n_frames = 1 + int(math.ceil((slen - frame_len) / frame_step))
    pad_len = (n_frames - 1) * frame_step + frame_len
    padded = torch.nn.functional.pad(emph, (0, pad_len - slen))
    frames = padded.unfold(0, frame_len, frame_step)       # [N, frame_len]

    spec = torch.abs(torch.fft.rfft(frames, n=nfft, dim=1))  # [N, nfft//2+1]
    pspec = (1.0 / nfft) * spec ** 2

    eps = float(np.finfo(np.float32).eps)
    energy = torch.sum(pspec, dim=1)
    energy = torch.where(energy == 0, eps, energy)

    fb = _f32(mel_filterbank(nfilt, nfft, samplerate), dev)
    feat = pspec @ fb.T
    feat = torch.where(feat == 0, eps, feat)
    logfeat = torch.log(feat)

    dct_m = _f32(_dct2_ortho_matrix(nfilt, nfilt), dev)
    ceps = (logfeat @ dct_m.T)[:, :numcep]
    ceps = ceps * _f32(_lifter_coeffs(numcep, ceplifter), dev)

    if append_energy:
        ceps = torch.cat([torch.log(energy)[:, None], ceps[:, 1:]], dim=1)
    return ceps


# the JAX package's name for ``mfcc``
mfcc_jax = mfcc


def extract_mfcc_to_frames(signal, samplerate: int, nb_frames: int,
                           num_cep: int = 26, window_length: float = 0.02,
                           window_step: float = 0.01, nfft: int = 1024,
                           device="cuda") -> torch.Tensor:
    """The reference's extract_mfcc unit (audio_utils.py:209-235): MFCC at
    10 ms hop, then Fourier-resampled to the video frame count."""
    feats = mfcc(signal, samplerate=samplerate, winlen=window_length,
                 winstep=window_step, numcep=num_cep, nfft=nfft, device=device)
    return resample_fourier(feats, nb_frames)
