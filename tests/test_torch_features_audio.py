"""The port's audio features (``lets_face_it_tpu_torch/features/{dsp,mfcc,
prosody,vad}.py``) against the JAX package's on the CPU.

Inputs are made with numpy from a seed (or read from the prosody goldens)
and handed to both sides as float32 arrays. Tolerances, each beside the
largest difference read on these inputs (float32 in another summation
order, pocketfft against XLA's FFT):

- ``resample_fourier`` atol 1e-5 (read 9.5e-07); ``savgol_filter`` atol
  2e-6 (read 2.1e-07); ``rms_frames`` and ``amplitude_to_db`` rtol 1e-6;
- ``mfcc`` atol 1e-4 on cepstra up to |30| (read 1.3e-05);
  ``extract_mfcc_to_frames`` atol 2e-4 (read 2.2e-05);
- pitch candidates: the same voiced candidates, frequencies rtol 5e-3 (one
  step of the 1/16-sample sinc grid at 600 Hz and 8 kHz is 4.7e-3 of the
  frequency: where two grid points are equal to rounding, either side may
  take either; read 0.059 Hz at 123 Hz), strengths atol 1e-4 (read
  6.9e-06); the Viterbi track: voicing equal on every frame, f0 within 1e-2
  cents (read 2.1e-04); ``intensity_db`` atol 1e-4 dB (read 1.5e-05);
  ``extract_prosodic_features`` atol 1e-5 (read 1.2e-06);
- ``crosstalk_vad``: the smoothed, resampled tracks atol 1e-5 before the
  0.1 threshold, the binary tracks equal wherever the track is more than
  1e-3 from 0.1.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from lets_face_it_tpu.features import dsp as jdsp
from lets_face_it_tpu.features import mfcc as jmfcc
from lets_face_it_tpu.features import prosody as jpros
from lets_face_it_tpu.features import vad as jvad
from lets_face_it_tpu_torch.features import dsp, mfcc, prosody, vad

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIXTURES = Path(__file__).parent / "fixtures"
BATTERY_NAMES = ["creaky_low", "high_ramp", "low_ramp", "noisy_snr0",
                 "noisy_snr10", "octave_trap", "period_doubled",
                 "silence_fade"]


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# dsp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,num,window", [
    (1000, 250, None), (999, 250, None), (250, 1000, None), (1000, 999, None),
    (640, 640, None), (1200, 300, "hamming"), (1201, 300, "hamming")])
def test_resample_fourier_matches_jax(nx, num, window):
    rng = np.random.default_rng(nx + num)
    x = rng.standard_normal((nx, 3) if window is None else nx).astype(np.float32)
    ref = np.asarray(jdsp.resample_fourier(x, num, window=window))
    got = dsp.resample_fourier(_t(x), num, window=window).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # and both against scipy, as the JAX package's tests hold it
    np.testing.assert_allclose(got, scipy.signal.resample(x, num, axis=0,
                                                          window=window), atol=2e-4)


@pytest.mark.parametrize("win,poly,dims", [(9, 3, 4), (301, 1, 4), (5, 2, 4),
                                           (9, 3, None)])
def test_savgol_filter_matches_jax(win, poly, dims):
    rng = np.random.default_rng(win)
    t = max(win + 10, 400)
    x = rng.standard_normal((t, dims) if dims else t).astype(np.float32)
    ref = np.asarray(jdsp.savgol_filter(jnp.asarray(x), win, poly))
    got = dsp.savgol_filter(_t(x), win, poly).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_rms_frames_and_amplitude_to_db_match_jax():
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    x[2000:3000] = 0.0                      # silence: the amin floor
    ref = np.asarray(jdsp.rms_frames(jnp.asarray(x), 160, 80))
    got = dsp.rms_frames(_t(x), 160, 80).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)
    for top_db in (80.0, None, 10.0):
        ref_db = np.asarray(jdsp.amplitude_to_db(jnp.asarray(ref) * 100.0,
                                                 top_db=top_db))
        got_db = dsp.amplitude_to_db(_t(ref) * 100.0, top_db=top_db).numpy()
        np.testing.assert_allclose(got_db, ref_db, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# mfcc
# ---------------------------------------------------------------------------

def _voiced(fs, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    return (0.5 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.parametrize("fs", [16000, 44100])
def test_mfcc_matches_jax(fs):
    x = _voiced(fs, 1.0, fs)
    x[: fs // 10] = 0.0                     # silent frames: the eps floors
    ref = np.asarray(jmfcc.mfcc_jax(x * 32768.0, samplerate=fs))
    got = mfcc.mfcc(x * 32768.0, samplerate=fs, device="cpu").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert mfcc.mfcc_jax is mfcc.mfcc


def test_extract_mfcc_to_frames_matches_jax():
    fs = 16000
    x = _voiced(fs, 2.0, 5) * 32768.0
    ref = np.asarray(jmfcc.extract_mfcc_to_frames(x, fs, nb_frames=50))
    got = mfcc.extract_mfcc_to_frames(x, fs, 50, device="cpu").numpy()
    assert got.shape == ref.shape == (50, 26)
    np.testing.assert_allclose(got, ref, atol=2e-4)


# ---------------------------------------------------------------------------
# prosody
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURES / "prosody_golden.npz")


@pytest.fixture(scope="module")
def battery():
    return np.load(FIXTURES / "prosody_battery.npz")


def _check_pitch(x, fs, step):
    fj, sj, lj = map(np.asarray, jpros.pitch_candidates(x, fs=fs, time_step=step))
    fp, sp, lp = (t.numpy() for t in prosody.pitch_candidates(
        x, fs=fs, time_step=step, device="cpu"))
    assert fp.shape == fj.shape
    np.testing.assert_array_equal(fp > 0, fj > 0)
    np.testing.assert_allclose(fp, fj, rtol=5e-3)
    kept = sj > -1e29
    np.testing.assert_array_equal(sp > -1e29, kept)
    np.testing.assert_allclose(sp[kept], sj[kept], atol=1e-4)
    np.testing.assert_allclose(lp, lj, rtol=1e-6, atol=1e-9)

    f0_j = np.asarray(jpros.viterbi_pitch(jnp.asarray(fj), jnp.asarray(sj)))
    f0_p = prosody.viterbi_pitch(torch.as_tensor(fp), torch.as_tensor(sp)).numpy()
    voiced = f0_j > 0
    np.testing.assert_array_equal(f0_p > 0, voiced)
    if voiced.any():
        cents = 1200 * np.abs(np.log2(f0_p[voiced] / f0_j[voiced]))
        assert cents.max() < 1e-2, cents.max()
    # on the same candidates, the same track bit for bit
    same = prosody.viterbi_pitch(torch.as_tensor(fj), torch.as_tensor(sj)).numpy()
    np.testing.assert_array_equal(same, f0_j)

    ref_i = np.asarray(jpros.intensity_db(x, fs=fs, time_step=step))
    got_i = prosody.intensity_db(x, fs=fs, time_step=step, device="cpu").numpy()
    np.testing.assert_allclose(got_i, ref_i, atol=1e-4)
    return voiced


def test_pitch_and_intensity_match_jax_on_golden(golden):
    voiced = _check_pitch(golden["wav"], int(golden["fs"]),
                          float(golden["time_step"]))
    assert voiced.sum() > 100


@pytest.mark.parametrize("name", BATTERY_NAMES)
def test_pitch_and_intensity_match_jax_on_battery(battery, name):
    assert sorted(battery["names"]) == BATTERY_NAMES
    _check_pitch(battery[f"{name}/wav"], int(battery["fs"]),
                 float(battery["time_step"]))


def test_viterbi_takes_the_first_of_tied_maxima():
    """Two candidates with equal strength and equal cost from every
    predecessor: ``jnp.argmax`` takes the first, and so must the port, in
    the forward pass and in the final choice."""
    freqs = np.array([[0.0, 200.0, 200.0, 100.0],
                      [0.0, 150.0, 150.0, 300.0],
                      [0.0, 120.0, 120.0, 240.0]], np.float32)
    strengths = np.array([[0.1, 0.9, 0.9, 0.2],
                          [0.1, 0.8, 0.8, 0.1],
                          [0.1, 0.7, 0.7, 0.1]], np.float32)
    ref = np.asarray(jpros.viterbi_pitch(jnp.asarray(freqs), jnp.asarray(strengths)))
    got = prosody.viterbi_pitch(_t(freqs), _t(strengths)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [200.0, 150.0, 120.0])
    # the backpointers: candidate 1 (not 2) is the tied best predecessor
    n, c = freqs.shape
    trans = prosody._transition_cost(_t(freqs)[:-1, :, None], _t(freqs)[1:, None, :])
    total = (_t(strengths)[0][:, None] - trans[0]) + _t(strengths)[1][None, :]
    assert torch.max(total, dim=0).indices[1].item() == 1


def test_extract_prosodic_features_matches_jax(golden):
    x, fs = golden["wav"], int(golden["fs"])
    for step, nb in ((0.02, 77), (float(golden["time_step"]), 40)):
        ref = np.asarray(jpros.extract_prosodic_features(x, fs, nb, time_step=step))
        got = prosody.extract_prosodic_features(x, fs, nb, time_step=step,
                                                device="cpu").numpy()
        assert got.shape == ref.shape == (nb, 4)
        np.testing.assert_allclose(got, ref, atol=1e-5)


# ---------------------------------------------------------------------------
# vad
# ---------------------------------------------------------------------------

def _jax_tracks(x1, x2, fs, frame_count):
    """The JAX package's crosstalk_vad up to its 0.1 threshold
    (vad.py:33-47), from its own dsp functions."""
    e = [jdsp.amplitude_to_db(jdsp.rms_frames(jnp.asarray(x * 32768.0),
                                              int(fs * 0.02), int(fs * 0.01)))
         for x in (x1, x2)]
    s = [((e[0] > 30.0) & (e[0] > e[1] + 5.0)).astype(jnp.float32),
         ((e[1] > 30.0) & (e[1] > e[0] + 5.0)).astype(jnp.float32)]
    return [np.asarray(jnp.clip(jdsp.resample_fourier(
        jdsp.savgol_filter(si, 301, 1), frame_count, window="hamming"), 0.0, 1.0))
        for si in s]


def test_crosstalk_vad_matches_jax():
    rng = np.random.default_rng(4)
    fs, dur = 8000, 40.0
    n = int(fs * dur)
    t = np.arange(n) / fs
    tone = np.sin(2 * np.pi * 300 * t).astype(np.float32)
    turns = (np.sin(2 * np.pi * t / 13.0) > 0).astype(np.float32)
    x1 = tone * turns + 1e-3 * rng.standard_normal(n).astype(np.float32)
    x2 = (0.5 * tone * (1 - turns) + 0.05 * tone
          + 1e-3 * rng.standard_normal(n).astype(np.float32))
    frames = 1000
    ref_tracks = _jax_tracks(x1, x2, fs, frames)
    got_tracks = [v.numpy() for v in vad.crosstalk_tracks(x1, x2, fs, frames,
                                                          device="cpu")]
    ref_bin = [np.asarray(v) for v in jvad.crosstalk_vad(x1, x2, fs, frames)]
    got_bin = [v.numpy() for v in vad.crosstalk_vad(x1, x2, fs, frames,
                                                    device="cpu")]
    for rt, gt, rb, gb in zip(ref_tracks, got_tracks, ref_bin, got_bin):
        np.testing.assert_allclose(gt, rt, atol=1e-5)
        np.testing.assert_array_equal(rb, (rt >= 0.1).astype(np.float32))
        clear = np.abs(rt - 0.1) > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(gb[clear], rb[clear])
        assert 0.1 < gb.mean() < 0.9          # both states occur
