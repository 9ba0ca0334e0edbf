"""Host-side audio IO and segmentation: wav read/write, stereo session
splitting, and silence-based chunking (reference audio_utils.py:102-141);
the port's copy of ``lets_face_it_tpu/features/audio_io.py``.

Pure-numpy/scipy host utilities — IO, not compute — with the librosa
dependency removed: ``split_silences`` reimplements ``librosa.effects.split``
(frame RMS in dB relative to the signal's peak, threshold top_db below the
max, contiguous active runs)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.io.wavfile as wavfile


def read_wav(path) -> tuple[int, np.ndarray]:
    """Returns (fs, float array in [-1, 1])."""
    fs, data = wavfile.read(Path(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return fs, data


def write_wav(path, data: np.ndarray, fs: int):
    """PCM_16 output, as the reference writes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    clipped = np.clip(np.asarray(data), -1.0, 1.0)
    wavfile.write(path, fs, (clipped * 32767.0).astype(np.int16))


def split_audio_channels(session_wav, out_dir, participants=("P1", "P2")):
    """Split a stereo session recording into per-participant mono wavs
    (audio_utils.py:102-119). Idempotent: skips existing outputs."""
    out_dir = Path(out_dir)
    fs, data = None, None
    written = []
    for i, participant in enumerate(participants):
        target = out_dir / participant / "audio.wav"
        if target.exists():
            continue
        if data is None:
            fs, data = read_wav(session_wav)
            assert data.ndim == 2 and data.shape[1] >= len(participants), (
                f"expected stereo session audio, got shape {data.shape}")
        write_wav(target, data[:, i], fs)
        written.append(target)
    return written


def frame_rms_db(y: np.ndarray, frame_length: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    """Centered frame RMS in dB (librosa conventions)."""
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad))
    n_frames = 1 + (yp.shape[0] - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    rms = np.sqrt(np.mean(yp[idx] ** 2, axis=1))
    return 20.0 * np.log10(np.maximum(rms, 1e-10))


def split_silences(y: np.ndarray, top_db: float = 3.0, frame_length: int = 2048,
                   hop_length: int = 512) -> np.ndarray:
    """Non-silent intervals [[start, end], ...] in samples, like
    ``librosa.effects.split``: active where frame dB > max_dB - top_db."""
    db = frame_rms_db(y, frame_length, hop_length)
    active = db > (db.max() - top_db)
    edges = np.diff(active.astype(np.int8), prepend=0, append=0)
    starts = np.flatnonzero(edges == 1)
    ends = np.flatnonzero(edges == -1)
    intervals = np.stack([starts, ends], axis=1) * hop_length
    return np.minimum(intervals, y.shape[0])


def chunk_audio_file(wav_path, out_dir, top_db: float = 3.0):
    """Write silence-separated chunks ``00001.wav ...`` (audio_utils.py:122-141):
    chunk i spans from the previous segment start to this segment's start, plus
    a final tail chunk. Idempotent on the chunk directory."""
    out_dir = Path(out_dir)
    if out_dir.exists():
        return out_dir
    fs, y = read_wav(wav_path)
    segments = split_silences(y, top_db=top_db)

    tmp = out_dir.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    prev_start = 0
    i = 0
    for i, (seg_start, _seg_end) in enumerate(segments, 1):
        write_wav(tmp / f"{i:05}.wav", y[prev_start:seg_start], fs)
        prev_start = seg_start
    write_wav(tmp / f"{i + 1:05}.wav", y[prev_start:], fs)
    tmp.rename(out_dir)
    return out_dir
