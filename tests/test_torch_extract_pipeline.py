"""The port's extraction CLI end to end on the CPU
(``python -m lets_face_it_tpu_torch.extract_features --device cpu``), held
against the JAX package's drivers on the same inputs, then the port's
trainer on the file it wrote.

Two synthetic dyadic sessions of 100 frames at 25 fps (4 s: the VAD's
smoothing window is 3 s): a stereo wav whose channels glide in f0 and take
turns, ``frames_25fps.txt``, and OpenFace CSVs whose
landmarks are projected from known FLAME parameters of the synthetic head
(written as the ``.npz`` and embedding ``.pkl`` the CLI's asset loader
reads), as ``tests/test_integration_pipeline.py`` writes them.

Held: the audio ``.npy`` files against the JAX package's ``stage_audio`` at
the limits of ``tests/test_torch_features_audio.py`` (prosody atol 1e-5,
MFCC atol 2e-4, the VAD tracks equal where the JAX track is clear of the
threshold); the FLAME files by their fit (the fit itself is held against
JAX in ``tests/test_torch_flame_fit.py``): every reprojected landmark
within 5 % of the frame's spread (read 2.8 %: the targets carry random
expressions the regularised fit does not reproduce exactly); the RingNet-lite files' layout; ``lets_face_it.h5``
against the JAX package's combiner on the same per-frame files (face kinds
bit for bit, audio kinds at the audio limits); the fit and the combiner in
memory (``fit_participant``, ``combine_corpus``) equal to the files bit for
bit; a second run rewrites nothing; the trainer takes 2 steps from the file.
"""

import csv
import importlib.util
import json
import pickle
import shutil
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.features import audio_io as jaudio
from lets_face_it_tpu.features import combine as jcombine
from lets_face_it_tpu.features import flame_fit as jfit
from lets_face_it_tpu.render import flame as jflame
from lets_face_it_tpu_torch import extract_features as cli
from lets_face_it_tpu_torch.features import combine
from lets_face_it_tpu_torch.features import flame_fit as fit
from lets_face_it_tpu_torch.render import flame as pflame
from lets_face_it_tpu_torch.train.loop import train

from test_torch_port_common import port_hp, train_hp

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The fits are thousands of small operations, which threads do not
    speed up; beside other test workers on the same cores they slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = Path(__file__).resolve().parent.parent
FPS, N_FRAMES, FS = 25, 100, 8000
JM = jflame.synthetic_flame_model(128, seed=3)
EMB_SEED = 4
JE = jfit.synthetic_landmark_embedding(JM, seed=EMB_SEED)
SPLITS = {"train": {"S1": [[40, 3960]], "S2": [[40, 3960]]},
          "val": {"S2": [[40, 3960]]}, "test": {"S1": [[40, 2000]]}}


def _session_audio(rng, n, f_base):
    t = np.arange(n) / FS
    f0 = f_base + 40 * np.sin(2 * np.pi * 0.2 * t)
    return (0.3 * np.sin(2 * np.pi * np.cumsum(f0) / FS)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _write_raw_session(session_dir, rng):
    n = int(FS * N_FRAMES / FPS)
    stereo = np.stack([_session_audio(rng, n, 140), _session_audio(rng, n, 210)], 1)
    stereo[: n // 2, 1] *= 0.02          # the channels take turns
    stereo[n // 2:, 0] *= 0.02
    jaudio.write_wav(session_dir / "audio_c1_c2.wav", stereo, FS)
    for part in ("P1", "P2"):
        d = session_dir / part
        d.mkdir(parents=True, exist_ok=True)
        (d / f"frames_{FPS}fps.txt").write_text(str(N_FRAMES))
        gt = {"trans": rng.uniform(-0.03, 0.03, (N_FRAMES, 3)),
              "rot": rng.uniform(-0.1, 0.1, (N_FRAMES, 3)),
              "pose": np.zeros((N_FRAMES, 12)), "shape": np.zeros((N_FRAMES, 300)),
              "exp": 0.3 * rng.standard_normal((N_FRAMES, 100))}
        gt = {k: jnp.asarray(v, jnp.float32) for k, v in gt.items()}
        proj = np.asarray(jax.vmap(
            lambda p: 700.0 * jfit.model_landmarks(JM, JE, p)[:, :2])(gt))
        with open(d / f"openface_{FPS}fps.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([f"c{i}" for i in range(436)])
            for ts in range(N_FRAMES):
                full = np.zeros((68, 2), np.float32)
                full[17:] = proj[ts]
                full[17:, 1] = 1024.0 - full[17:, 1]
                w.writerow(["0", str(ts), str(ts / FPS), "0.99", "1"] + ["0"] * 294
                           + [str(v) for v in full[:, 0]]
                           + [str(v) for v in full[:, 1]] + ["0"])


def _write_assets(d: Path):
    """The synthetic head as the ``.npz`` ``load_flame`` reads, and its
    embedding as the official pickle's fields."""
    np.savez(d / "flame.npz", v_template=np.asarray(JM.v_template),
             shapedirs=np.asarray(JM.shapedirs), posedirs=np.asarray(JM.posedirs),
             J_regressor=np.asarray(JM.j_regressor),
             weights=np.asarray(JM.lbs_weights), f=JM.faces)
    rng = np.random.default_rng(EMB_SEED)   # synthetic_landmark_embedding's draws
    face_idx = rng.integers(0, JM.faces.shape[0], 51)
    bary = rng.dirichlet(np.ones(3), 51)
    np.testing.assert_array_equal(JM.faces[face_idx], JE.vertex_ids)
    with open(d / "emb.pkl", "wb") as f:
        pickle.dump({"lmk_face_idx": face_idx, "lmk_b_coords": bary}, f)
    return d / "flame.npz", d / "emb.pkl"


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_extract_features",
                                                  REPO / "extract_features.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mtimes(root: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract")
    raw = root / "raw"
    rng = np.random.default_rng(0)
    for name in ("S1", "S2"):
        _write_raw_session(raw / name, rng)
    (root / "splits").mkdir()
    splits = root / "splits" / "train_val_test.json"
    splits.write_text(json.dumps(SPLITS))
    assets = _write_assets(root)
    port, ref = root / "port", root / "jax"
    shutil.copytree(raw, port)
    shutil.copytree(raw, ref)

    saved = cli._flame_paths
    cli._flame_paths = lambda: tuple(str(p) for p in assets)
    try:
        argv = ["--dataset_dir", str(port), "--splits", str(splits), "--device", "cpu"]
        cli.main(argv)
        before = _mtimes(port)
        cli.main(argv)                       # idempotent: rewrites nothing
        rerun = _mtimes(port) == before
    finally:
        cli._flame_paths = saved

    jcli = _jax_cli()
    sessions = sorted(p for p in ref.iterdir() if p.is_dir())
    jcli.stage_audio(sessions, FPS)
    for name in ("S1", "S2"):             # the same fits, so combine sees equal inputs
        for part in ("P1", "P2"):
            shutil.copy(port / name / part / f"flame_{FPS}fps.h5",
                        ref / name / part / f"flame_{FPS}fps.h5")
    jcombine.combine_features(ref, ref / "lets_face_it.h5", SPLITS, fps=FPS)
    return port, ref, rerun


def _parts():
    return [(s, p) for s in ("S1", "S2") for p in ("P1", "P2")]


def test_cli_audio_files_match_jax(extracted):
    port, ref, _ = extracted
    for s, p in _parts():
        for name, atol in ((f"prosodic_features_{FPS}fps.npy", 1e-5),
                           (f"mfcc_{FPS}fps.npy", 2e-4)):
            got, want = np.load(port / s / p / name), np.load(ref / s / p / name)
            assert got.shape == want.shape == (N_FRAMES, want.shape[1])
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=atol, err_msg=f"{s}/{p}/{name}")
        vad = f"crosstalk_vad_{FPS}fps.npy"
        np.testing.assert_array_equal(np.load(port / s / p / vad),
                                      np.load(ref / s / p / vad))
        for rel in ("audio.wav", "audio_chunks"):
            assert (port / s / p / rel).exists()


def test_cli_flame_files_fit_the_landmarks(extracted):
    port, _, _ = extracted
    model = pflame.flame_model_from_arrays(
        {k: np.asarray(v) for k, v in JM._asdict().items()}, device="cpu")
    emb = fit.landmark_embedding_from_arrays(JE.vertex_ids, np.asarray(JE.bary),
                                             device="cpu")
    for s, p in _parts():
        d = port / s / p
        with h5py.File(d / f"ringnet_{FPS}fps.h5") as f:
            assert {k: f["flame_params"][k].shape for k in f["flame_params"]} == {
                "cam": (N_FRAMES, 3), "pose": (N_FRAMES, 6),
                "shape": (N_FRAMES, 100), "expression": (N_FRAMES, 50)}
        with h5py.File(d / f"flame_{FPS}fps.h5") as f:
            params = {k[3:]: torch.as_tensor(f[k][()]) for k in f}
        assert {k: tuple(v.shape) for k, v in params.items()} == {
            "trans": (N_FRAMES, 3), "rot": (N_FRAMES, 3), "pose": (N_FRAMES, 12),
            "shape": (N_FRAMES, 300), "exp": (N_FRAMES, 100)}
        targets = fit.read_openface_targets(d, FPS)
        # the file keeps no scale: refit it in closed form per frame
        with torch.no_grad():
            xy = fit.model_landmarks(model, emb, params)[..., :2].numpy()
        scale = (xy * targets).sum((1, 2)) / (xy * xy).sum((1, 2))
        err = np.abs(scale[:, None, None] * xy - targets).max((1, 2))
        assert (err / np.ptp(targets, axis=(1, 2))).max() < 0.05


def test_cli_dataset_matches_jax_combine(extracted):
    port, ref, _ = extracted
    got, want = {}, {}
    for path, out in ((port / "lets_face_it.h5", got), (ref / "lets_face_it.h5", want)):
        with h5py.File(path) as f:
            f.visititems(lambda n, o: out.__setitem__(n, o[()])
                         if isinstance(o, h5py.Dataset) else None)
    assert sorted(got) == sorted(want) and len(got) > 20
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if "mfcc" in key:
            np.testing.assert_allclose(g, w, atol=2e-4, err_msg=key)
        elif "prosody" in key:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_fit_participant_returns_the_flame_file(extracted):
    """The fit in memory (as a trainer without ``h5py`` takes it) is the
    file the CLI's flame stage wrote, bit for bit."""
    port, _, _ = extracted
    model = pflame.load_flame(port.parent / "flame.npz", "cpu")
    emb = fit.load_landmark_embedding(port.parent / "emb.pkl", model.faces, "cpu")
    d = port / "S1" / "P1"
    got = fit.fit_participant(d, FPS, model, emb)
    with h5py.File(d / f"flame_{FPS}fps.h5") as f:
        assert sorted(got) == sorted(f)
        for key, arr in got.items():
            np.testing.assert_array_equal(arr, f[key][()], err_msg=key)


def test_combine_corpus_from_fitted_arrays_matches_the_file(extracted):
    """``combine_corpus`` given the fitted arrays in place of the flame
    files builds the store the CLI wrote, bit for bit."""
    port, _, _ = extracted
    flame = {}
    for s, p in _parts():
        with h5py.File(port / s / p / f"flame_{FPS}fps.h5") as f:
            flame.setdefault(s, {})[p] = {k: f[k][()] for k in f}
    corpus = combine.combine_corpus(port, SPLITS, FPS, flame=flame)
    with h5py.File(port / "lets_face_it.h5") as f:
        assert sorted(corpus.means) == sorted(f["means"]) == sorted(f["stds"])
        for kind in corpus.means:
            np.testing.assert_array_equal(corpus.means[kind], f["means"][kind][()])
            np.testing.assert_array_equal(corpus.stds[kind], f["stds"][kind][()])
        for split, chunks in corpus.splits.items():
            assert len(chunks) == len(f[split]["prosody"]) > 0
            for i, chunk in enumerate(chunks):
                assert sorted(chunk) == sorted(f[split])
                for kind, roles in chunk.items():
                    for role, arr in roles.items():
                        want = f[split][kind][str(i)][role]
                        assert arr.dtype == want.dtype
                        np.testing.assert_array_equal(arr, want[()])


def test_cli_rerun_is_idempotent(extracted):
    assert extracted[2]


def test_trainer_takes_steps_from_the_extracted_file(extracted):
    port, _, _ = extracted
    hp = port_hp(train_hp())
    hp.Data["speech_dim"] = 30
    hp.dataset_root = str(port)
    hp.Data["file_name"] = "lets_face_it.h5"
    hp.batch_size = 8
    losses = []
    state, best_val = train(hp, seed=0, max_steps=2, device="cpu", verbose=False,
                            step_hook=lambda s, m: losses.append(float(m["loss"])))
    assert state.step == 2 and len(losses) == 2
    assert np.isfinite(losses).all() and np.isfinite(best_val)

