"""The port's host-side extraction modules against the JAX package's on the
CPU: wav IO and chunking (``features/audio_io.py``), the dataset combiner
(``features/combine.py``, whose file the port's
``WindowDataset.from_file`` reads), the legacy packed-frame dataset
(``features/legacy_dataset.py``) and the splits check
(``data/validate_jsons.py``), after ``tests/test_features_dsp.py``,
``test_combine.py``, ``test_legacy_dataset.py`` and
``test_validate_data_jsons.py``.

These are the same numpy/scipy/h5py code on both sides, so every file and
array is held equal bit for bit.
"""

import csv
import json
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from lets_face_it_tpu.features import audio_io as jaudio
from lets_face_it_tpu.features import combine as jcombine
from lets_face_it_tpu.features import legacy_dataset as jlegacy
from lets_face_it_tpu_torch.data.validate_jsons import validate_data_dir
from lets_face_it_tpu_torch.data.windows import WindowDataset
from lets_face_it_tpu_torch.features import audio_io, combine, legacy_dataset

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from validate_data_jsons import validate_data_dir as jax_validate  # noqa: E402

FPS, N_FRAMES = 25, 200


def _h5_items(path):
    out = {}
    with h5py.File(path) as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_h5(a, b):
    da, db = _h5_items(a), _h5_items(b)
    assert sorted(da) == sorted(db)
    for k in db:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


# ---------------------------------------------------------------------------
# audio_io
# ---------------------------------------------------------------------------

def test_wav_io_split_and_chunking_match_jax(tmp_path):
    fs = 8000
    t = np.arange(2 * fs) / fs
    stereo = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                       0.5 * np.sin(2 * np.pi * 220 * t)], axis=1).astype(np.float32)
    for side, mod in (("jax", jaudio), ("port", audio_io)):
        d = tmp_path / side
        mod.write_wav(d / "sess_c1_c2.wav", stereo, fs)
        assert len(mod.split_audio_channels(d / "sess_c1_c2.wav", d)) == 2
        assert mod.split_audio_channels(d / "sess_c1_c2.wav", d) == []   # idempotent
        y = np.concatenate([stereo[:fs, 0], np.zeros(fs // 2, np.float32),
                            stereo[:fs, 0]])
        mod.write_wav(d / "mono.wav", y, fs)
        mod.chunk_audio_file(d / "mono.wav", d / "chunks")
    for rel in ("sess_c1_c2.wav", "P1/audio.wav", "P2/audio.wav", "mono.wav"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    chunks = sorted(p.name for p in (tmp_path / "port" / "chunks").glob("*.wav"))
    assert len(chunks) >= 2
    assert chunks == sorted(p.name for p in (tmp_path / "jax" / "chunks").glob("*.wav"))
    for name in chunks:
        fs_p, a = audio_io.read_wav(tmp_path / "port" / "chunks" / name)
        fs_j, b = jaudio.read_wav(tmp_path / "jax" / "chunks" / name)
        assert fs_p == fs_j and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    y = stereo[:, 0]
    np.testing.assert_array_equal(audio_io.split_silences(y, top_db=3.0),
                                  jaudio.split_silences(y, top_db=3.0))


# ---------------------------------------------------------------------------
# combine
# ---------------------------------------------------------------------------

def _write_session(session_dir, rng, fail_frames=()):
    for part in ("P1", "P2"):
        d = session_dir / part
        d.mkdir(parents=True)
        with open(d / f"openface_{FPS}fps.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([f"c{i}" for i in range(440)])
            for t in range(N_FRAMES):
                conf = 0.5 if (t in fail_frames and part == "P1") else 0.99
                w.writerow([0, t, t / FPS, conf, 1]
                           + list(rng.standard_normal(435).round(4)))
        with h5py.File(d / f"flame_{FPS}fps.h5", "w") as f:
            f["tf_exp"] = rng.standard_normal((N_FRAMES, 50))
            f["tf_pose"] = rng.standard_normal((N_FRAMES, 6))
            f["tf_rot"] = rng.standard_normal((N_FRAMES, 3))
        np.save(d / f"mfcc_{FPS}fps.npy", rng.standard_normal((N_FRAMES, 26)))
        np.save(d / f"prosodic_features_{FPS}fps.npy",
                rng.standard_normal((N_FRAMES, 4)))


@pytest.fixture
def dataset_dir(tmp_path):
    rng = np.random.default_rng(0)
    _write_session(tmp_path / "S1", rng, fail_frames={1, 80, 81, 82, 83, 120})
    _write_session(tmp_path / "S2", rng)
    return tmp_path


def test_combine_writes_the_jax_file_and_the_port_reads_it(dataset_dir, tmp_path):
    spec = {"train": {"S1": [[40, 7000]], "S2": [[500, 6000]]},
            "val": {"S2": [[500, 4000]]}, "test": {}}
    out_p = combine.combine_features(dataset_dir, tmp_path / "port.h5", spec, fps=FPS)
    out_j = jcombine.combine_features(dataset_dir, tmp_path / "jax.h5", spec, fps=FPS)
    _assert_same_h5(out_p, out_j)
    with h5py.File(out_p) as f:
        # the failure gap splits S1: 2 roles x (2 chunks + 1 from S2)
        assert len(f["train"]["prosody"]) == 6
    hp_data = {"expression_dim": 50, "jaw_dim": 3, "neck_dim": 3, "speech_dim": 30}
    hp_cond = {"p1_speech": {"history": 2}, "p2_speech": {"history": 3},
               "p2_face": {"history": 4}}
    ds = WindowDataset.from_file(out_p, "train", hp_data, hp_cond, 40)
    batch = ds.get_batch(np.arange(4))
    assert batch["p1_face"].shape == (4, 40, 56)
    assert batch["p1_speech"].shape == (4, 40, 30)
    assert np.isfinite(batch["p1_face"]).all()


def test_gap_repair_and_bins_match_jax():
    rng = np.random.default_rng(3)
    success = rng.uniform(size=300) > 0.3
    success[0] = True          # frame 0 as a past neighbour: the reference's quirk
    data = rng.standard_normal((300, 5))
    for frame in range(300):
        plan_p, plan_j = combine.repair_plan(frame, success), jcombine.repair_plan(frame, success)
        assert plan_p == plan_j, frame
        if plan_p is not None:
            np.testing.assert_array_equal(combine.resolve_frame(plan_p, data),
                                          jcombine.resolve_frame(plan_j, data))
    session = {p: {"success": success} for p in ("P1", "P2")}
    assert combine.create_bins(session, 0, 300, "P1", "P2") == \
        jcombine.create_bins(session, 0, 300, "P1", "P2")
    assert combine.ms2frames(1234, 25) == jcombine.ms2frames(1234, 25)


def test_zero_variance_channel_is_guarded_as_in_jax(tmp_path):
    rng = np.random.default_rng(3)
    _write_session(tmp_path / "S1", rng)
    for part in ("P1", "P2"):
        p = tmp_path / "S1" / part / f"flame_{FPS}fps.h5"
        with h5py.File(p, "r+") as f:
            exp = f["tf_exp"][...]
            exp[:, 7] = 3.25
            del f["tf_exp"]
            f["tf_exp"] = exp
    spec = {"train": {"S1": [[1000, 7000]]}, "val": {}, "test": {}}
    with pytest.warns(UserWarning, match="zero-variance"):
        out_p = combine.combine_features(tmp_path, tmp_path / "p.h5", spec, fps=FPS)
    with pytest.warns(UserWarning, match="zero-variance"):
        out_j = jcombine.combine_features(tmp_path, tmp_path / "j.h5", spec, fps=FPS)
    _assert_same_h5(out_p, out_j)


def test_load_split_spec_matches_jax(tmp_path):
    spec = {"train": {"S1": [[0, 1000]]}, "val": {}, "test": {"S2": [[5, 9]]}}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(spec))
    assert combine.load_split_spec(path) == jcombine.load_split_spec(path) == spec


# ---------------------------------------------------------------------------
# legacy packed-frame dataset
# ---------------------------------------------------------------------------

def _chunk(rng, n):
    p1 = legacy_dataset.flame2glow(rng.standard_normal((n, 100)),
                                   rng.standard_normal((n, 12)),
                                   rng.standard_normal((n, 3)))
    p2 = legacy_dataset.flame2glow(rng.standard_normal((n, 100)),
                                   rng.standard_normal((n, 12)),
                                   rng.standard_normal((n, 3)))
    return legacy_dataset.pack_rows(p1, rng.standard_normal((n, 30)),
                                    p2, rng.standard_normal((n, 30)),
                                    np.arange(1, 2 * n, 2))


def test_legacy_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    splits = {"train": [_chunk(rng, 40), _chunk(rng, 25)],
              "val": [_chunk(rng, 30)], "test": [_chunk(rng, 20)]}
    exp, pose, neck = (rng.standard_normal((5, d)) for d in (100, 12, 3))
    np.testing.assert_array_equal(legacy_dataset.flame2glow(exp, pose, neck),
                                  jlegacy.flame2glow(exp, pose, neck))
    paths_p = legacy_dataset.write_packed_dataset(splits, tmp_path / "port")
    paths_j = jlegacy.write_packed_dataset(splits, tmp_path / "jax")
    assert sorted(paths_p) == sorted(paths_j)
    for split in paths_j:
        _assert_same_h5(paths_p[split], paths_j[split])
    store_p = legacy_dataset.PackedFrameStore(paths_p["train"])
    store_j = jlegacy.PackedFrameStore(paths_j["train"])
    np.testing.assert_array_equal(store_p.chunk_lengths, [40, 25])
    for args in ((0, 2, 12), (1,), (1, 5, None)):
        np.testing.assert_array_equal(store_p.get_frames(*args),
                                      store_j.get_frames(*args))


# ---------------------------------------------------------------------------
# the splits check
# ---------------------------------------------------------------------------

def _write_good(d: Path):
    (d / "train_val_test.json").write_text(json.dumps(
        {"train": {"S1": [[0, 60000], [70000, 90000]]},
         "val": {"S2": [[0, 30000]]}, "test": {"S3": [[0, 20000]]},
         "heldout_interaction": "S4"}))
    (d / "annotations.json").write_text(json.dumps(
        {"S1": {"smile": [[100, 900, 1]], "head_yaw": [[1000, 2000, None]]}}))
    (d / "meta_data.json").write_text(json.dumps(
        {"sessions": {"S1": {"P1": "u1", "P2": "u2"}, "S2": {"P1": "u1", "P2": "u3"},
                      "S3": {"P1": "u2", "P2": "u3"}, "S4": {"P1": "u1", "P2": "u2"}},
         "subjects": {"u1": {"gender": "female"}, "u2": {"gender": "male"},
                      "u3": {"gender": "female"}}}))


@pytest.mark.parametrize("case", ["good", "bad", "missing", "example"])
def test_validate_data_dir_matches_jax(tmp_path, case):
    d = tmp_path
    if case == "good":
        _write_good(d)
    elif case == "bad":
        (d / "train_val_test.json").write_text(json.dumps(
            {"train": {"S1": [[5000, 1000]]}, "wat": {"S9": [[0, 1000], [500, 2000]]}}))
        (d / "annotations.json").write_text(json.dumps({"S1": {"smile": [[0, 100]]}}))
        (d / "meta_data.json").write_text(json.dumps(
            {"sessions": {"S1": {"P1": "zz"}}, "subjects": {"u1": {}}}))
    elif case == "example":
        d = REPO / "data" / "example"
    got, want = validate_data_dir(d), jax_validate(d)
    assert got == want
    errors = got[0]
    assert bool(errors) == (case in ("bad", "missing"))


def test_combine_gate_blocks_on_splits_errors_only(tmp_path):
    """The CLI's pre-combine gate exits on an error in the splits file and
    only warns on errors in its sibling JSONs, as the JAX CLI's does."""
    from lets_face_it_tpu_torch.extract_features import validate_splits_dir

    _write_good(tmp_path)
    splits = tmp_path / "train_val_test.json"
    (tmp_path / "annotations.json").write_text(json.dumps({"S1": "wat"}))
    validate_splits_dir(splits)
    splits.write_text(json.dumps(
        {"train": {"S1": [[5000, 1000]]}, "val": {"S2": [[0, 30000]]},
         "test": {"S3": [[0, 20000]]}}))
    with pytest.raises(SystemExit):
        validate_splits_dir(splits)
