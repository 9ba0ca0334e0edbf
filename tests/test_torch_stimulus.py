"""The port's study-stimulus path against the JAX package's on the CPU:
segment selection (``data_segments``), the study sets, the VAD-scaled VOCA
lipsync (``get_vocas``), ``generate_videos`` and, as a whole slice,
``render_segment`` on the port's ``Generator`` (the ``seq_rev`` path on the
card). The render call is caught in both packages, so the vertices handed
to the renderer are compared: atol 1e-5 where the faces are given, and the
generated side at atol 2e-4 / rtol 1e-4 (the generator's tolerance) on the
faces, 1e-5 on the vertices of the ground-truth side. Meta JSONs and
segment lists must be equal."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lets_face_it_tpu import stimulus as jstim
from lets_face_it_tpu.data_segments import segments as jseg
from lets_face_it_tpu.data_segments import study_sets as jsets
from lets_face_it_tpu.render import flame as jflame
from lets_face_it_tpu.sample.generate import Generator as JaxGenerator
from lets_face_it_tpu.utils import misc as jmisc
from lets_face_it_tpu_torch import stimulus as pstim
from lets_face_it_tpu_torch.data_segments import segments as pseg
from lets_face_it_tpu_torch.data_segments import study_sets as psets
from lets_face_it_tpu_torch.render import flame as pflame
from lets_face_it_tpu_torch.sample.generate import Generator
from lets_face_it_tpu_torch.utils import misc as pmisc

from test_segments_stimulus import data_files  # noqa: F401  (fixture)
from test_torch_port_common import (assert_close, jax_params, port_hp,
                                    port_model, specs, tiny_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VERT_ATOL = 1e-5


# ---------------------------------------------------------------------------
# utils/misc, segments, study sets
# ---------------------------------------------------------------------------

def test_misc_helpers_match_jax(tmp_path):
    meta = {"sessions": {"S1": {"P1": "sub3"}}, "subjects": {"sub3": {"gender": "female"}}}
    (tmp_path / "meta_data.json").write_text(json.dumps(meta))
    assert (pmisc.get_gender(tmp_path / "meta_data.json", "S1", "P1")
            == jmisc.get_gender(tmp_path / "meta_data.json", "S1", "P1") == "female")
    path = "/data/Sessions/12/1_Actor_FaceNear.avi"
    assert pmisc.get_participant(path) == jmisc.get_participant(path) == "Actor"
    p = Path("/a/Sessions_50fps/b/Sessions_50fps.h5")
    assert (pmisc.replace_part(p, "50fps", "25fps")
            == jmisc.replace_part(p, "50fps", "25fps"))
    for ms in (0, 19, 20, 1000, 1234.5, 60000):
        assert pmisc.ms2frames(ms) == jmisc.ms2frames(ms)
        assert pmisc.ms2frames(ms, fps=25) == jmisc.ms2frames(ms, fps=25)
    for f in (1, 2, 51, 3001):
        assert pmisc.frames2ms(f) == jmisc.frames2ms(f)
        assert pmisc.frames2s(f, fps=25) == jmisc.frames2s(f, fps=25)
    assert pmisc.get_face_indicies(50, 3, 3, 136) == jmisc.get_face_indicies(50, 3, 3, 136)
    name = pmisc.get_training_name()
    assert name.count("_") == 1 and name.count("-") == 3


def _segment_rows(segs):
    return [(type(s).__name__, repr(s), s.session, s.start_frames, s.stop_frames,
             s.duration_frames, s.duration_s, s.frame_bounds(),
             s.clamped_frames(60, 10 ** 6)) for s in segs]


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_segments_match_jax(data_files, split):  # noqa: F811
    splits, annotations = (data_files / "train_val_test.json",
                           data_files / "annotations.json")
    assert pseg.get_segments_v2(splits) == jseg.get_segments_v2(splits)
    got = pseg.get_segments(splits, annotations, split)
    want = jseg.get_segments(splits, annotations, split)
    assert _segment_rows(got) == _segment_rows(want)
    assert [s.mimicry_type for s in got] == [s.mimicry_type for s in want]


def test_study_sets_match_jax(data_files):  # noqa: F811
    splits, annotations = (data_files / "train_val_test.json",
                           data_files / "annotations.json")
    for kw in ({"min_duration_ms": 500}, {"min_duration_ms": 500, "seed": 7,
                                          "block_list": ("mimicry_S1_2000_3000.mp4",)},
               {}):
        assert (psets.build_study_sets(splits, annotations, **kw)
                == jsets.build_study_sets(splits, annotations, **kw))
    assert (psets.non_mimicry(splits, annotations, min_duration_ms=100, max_count=2)
            == jsets.non_mimicry(splits, annotations, min_duration_ms=100, max_count=2))


def test_flame_params_and_merge_match_jax(tmp_path):
    import h5py

    rng = np.random.default_rng(0)
    n = 24
    with h5py.File(tmp_path / "flame_25fps.h5", "w") as f:
        for key, dim in (("tf_shape", 300), ("tf_exp", 100), ("tf_pose", 12),
                         ("tf_rot", 3), ("tf_trans", 3)):
            f[key] = rng.standard_normal((n, dim))
    for start, stop in ((None, None), (3, 20)):
        got = pseg.flame_params_from_h5(tmp_path / "flame_25fps.h5", start, stop)
        want = jseg.flame_params_from_h5(tmp_path / "flame_25fps.h5", start, stop)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    params = pseg.flame_params_from_h5(tmp_path / "flame_25fps.h5")
    voca = {"pose": rng.standard_normal((n, 6)), "expression": rng.standard_normal((n, 100))}
    vad = rng.uniform(size=(n, 1))
    got = pseg.merge_flame_params_and_voca(params, voca, vad, rng=np.random.default_rng(3))
    want = jseg.merge_flame_params_and_voca(params, voca, vad, rng=np.random.default_rng(3))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# VAD tracks and VOCA lipsync
# ---------------------------------------------------------------------------

T_FACE = 8
FRAME_NBS = [str(f) for f in range(101, 101 + 2 * T_FACE, 2)]


@pytest.fixture
def lipsync_dir(tmp_path):
    """Sessions_vad/S1/P{1,2}.npy (50 fps) and
    Sessions_50fps_voca/S1/1_P{1,2}_FaceNear/flame_params/<frame>.npy."""
    rng = np.random.default_rng(11)
    root = tmp_path / "data"
    for participant in ("P1", "P2"):
        vad_dir = root / "Sessions_vad" / "S1"
        vad_dir.mkdir(parents=True, exist_ok=True)
        np.save(vad_dir / f"{participant}.npy", rng.uniform(size=400))
        params_dir = (root / "Sessions_50fps_voca" / "S1" /
                      f"1_{participant}_FaceNear" / "flame_params")
        params_dir.mkdir(parents=True)
        for frame in range(99, 101 + 2 * T_FACE + 2):
            np.save(params_dir / f"{frame}.npy", {
                "tf_pose": 0.1 * rng.standard_normal((1, 6)),
                "tf_exp": 0.2 * rng.standard_normal((1, 50))}, allow_pickle=True)
    return root


def test_vad_weights_and_vocas_match_jax(lipsync_dir):
    for participant in ("P1", "P2"):
        np.testing.assert_array_equal(
            pstim.get_vad_weights(lipsync_dir, participant, "S1", 101, 131),
            jstim.get_vad_weights(lipsync_dir, participant, "S1", 101, 131))
        got = pstim.get_vocas(lipsync_dir, participant, "S1", FRAME_NBS, 2.0)
        want = jstim.get_vocas(lipsync_dir, participant, "S1", FRAME_NBS, 2.0)
        assert got["pose"].shape == (T_FACE, 6)
        for key in ("pose", "expression"):
            np.testing.assert_array_equal(got[key], want[key])
    seg = pseg.DataSegment("S1", "train", 2000, 2600)
    np.testing.assert_array_equal(
        seg.vad_weights(lipsync_dir, "P2", only_odd=True),
        jseg.DataSegment("S1", "train", 2000, 2600).vad_weights(
            lipsync_dir, "P2", only_odd=True))


# ---------------------------------------------------------------------------
# generate_videos and render_segment, the render call caught in both
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for ``render_double_face_video``: keeps the vertices and
    options and leaves an empty file where the mp4 would be."""

    def __init__(self):
        self.calls = []

    def __call__(self, file_name, vertices, vertices2, faces, **kwargs):
        def host(v):
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

        self.calls.append((Path(file_name).name, host(vertices), host(vertices2),
                           np.asarray(faces), kwargs))
        Path(file_name).write_bytes(b"")
        return file_name


@pytest.fixture
def recorders(monkeypatch):
    import lets_face_it_tpu.render.video as jvideo

    port, jax_side = _Recorder(), _Recorder()
    monkeypatch.setattr(pstim, "render_double_face_video", port)
    monkeypatch.setattr(jvideo, "render_double_face_video", jax_side)
    return port, jax_side


def _assert_same_calls(port, jax_side, atol=VERT_ATOL):
    assert len(port.calls) == len(jax_side.calls) > 0
    for (name, v1, v2, faces, kw), (jname, jv1, jv2, jfaces, jkw) in zip(
            port.calls, jax_side.calls):
        assert name == jname and kw == jkw
        np.testing.assert_array_equal(faces, jfaces)
        np.testing.assert_allclose(v1, jv1, atol=atol, rtol=0)
        np.testing.assert_allclose(v2, jv2, atol=atol, rtol=0)


def _face(rng, n):
    return {"expression": rng.standard_normal((n, 50)) * 0.1,
            "jaw": rng.standard_normal((n, 3)) * 0.05,
            "neck": rng.standard_normal((n, 3)) * 0.05}


def _info(rng):
    return {"left_gender": "male", "right_gender": "female",
            "left_shape": rng.standard_normal(300).tolist(),
            "right_shape": rng.standard_normal(300).tolist(),
            "left_skin_color": "white", "right_skin_color": "black",
            "left_start": 136, "right_start": 0}


@pytest.mark.parametrize("case", ["drawn", "drawn_lipsync", "info_lipsync"])
def test_generate_videos_matches_jax(case, tmp_path, lipsync_dir, recorders):
    """Genders, shapes, skins and placements drawn from random.Random(1234)
    in both (or given in ``info``), VOCA lipsync from ``data_dir``: the
    meta JSON has the same text, and the renderer gets the same options
    and vertices."""
    port, jax_side = recorders
    rng = np.random.default_rng(5)
    jm = jflame.synthetic_flame_model(64)
    pm = pflame.synthetic_flame_model(64, device="cpu")
    left, right = _face(rng, T_FACE), _face(rng, T_FACE)
    info = _info(rng) if case.startswith("info") else None
    data_dir = lipsync_dir if case.endswith("lipsync") else None
    seqs = [("stim.mp4", "S1", left, right, info, FRAME_NBS),
            ("stim2.mp4", "S1", right, left, info, FRAME_NBS)]
    pstim.generate_videos(pm, seqs, tmp_path / "port", data_dir=data_dir,
                          vad_scaling_factor=1.5)
    jstim.generate_videos(jm, seqs, tmp_path / "jax", data_dir=data_dir,
                          vad_scaling_factor=1.5)
    _assert_same_calls(port, jax_side)
    for name in ("stim", "stim2"):
        meta = Path("meta") / f"{name}.txt"
        assert (tmp_path / "port" / f"{name}.mp4").exists()
        assert (tmp_path / "port" / meta).exists() == (info is None)
        if info is None:
            assert ((tmp_path / "port" / meta).read_text()
                    == (tmp_path / "jax" / meta).read_text())
    # an existing video is kept unless overwrite is asked for
    pstim.generate_videos(pm, seqs[:1], tmp_path / "port", data_dir=data_dir)
    assert len(port.calls) == 2


def test_rerender_from_meta_matches_jax(tmp_path, recorders):
    """Ground truth re-rendered from the meta JSONs written by
    ``generate_videos``."""
    port, jax_side = recorders
    rng = np.random.default_rng(6)
    pm = pflame.synthetic_flame_model(64, device="cpu")
    jm = jflame.synthetic_flame_model(64)
    frames = rng.standard_normal((T_FACE, 273)).astype(np.float32) * 0.1
    pstim.generate_videos(pm, [("clip.mp4", "S1", _face(rng, T_FACE),
                                _face(rng, T_FACE), None, [])], tmp_path / "first")
    port.calls.clear()

    def lookup(name):
        return (frames, None, "S1") if name == "clip.mp4" else None

    pstim.rerender_from_meta(pm, tmp_path / "first" / "meta", lookup,
                             tmp_path / "port", overwrite=True)
    jstim.rerender_from_meta(jm, tmp_path / "first" / "meta", lookup,
                             tmp_path / "jax", overwrite=True)
    _assert_same_calls(port, jax_side)
    for start in (0, 136):
        block, jblock = pstim.face_block(frames, start), jstim.face_block(frames, start)
        assert all(np.array_equal(block[k], jblock[k]) for k in jblock)


def test_render_segment_matches_jax(tmp_path, recorders, monkeypatch):
    """The slice as a whole: the agent's side generated by the port's
    ``Generator`` on the JAX package's weights, with the JAX stream's
    latents injected (as in test_generator_generate_matches_jax), then both
    faces decoded and handed to the renderer."""
    port, jax_side = recorders
    hp = tiny_hp()
    hp.dataset_root = str(tmp_path)
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=4)
    rng = np.random.default_rng(7)
    padded = (0.5 * rng.standard_normal((20, 273))).astype(np.float32)
    frames = padded[-12:]
    n_gen = padded.shape[0] - spec.cond.longest_history
    z = np.array(jax.random.normal(jax.random.PRNGKey(0), (n_gen, 1, spec.channels))
                   * hp.Infer["eps"])

    gen = Generator(port_hp(hp), port_model(params, pspec), device="cpu")
    generated = []
    generate = gen.generate

    def with_latents(packed):
        generated.append(generate(packed, z=torch.as_tensor(z)))
        return generated[-1]

    monkeypatch.setattr(gen, "generate", with_latents)
    jgen = JaxGenerator(hp, params)
    jgenerated = []
    jgenerate = jgen.generate
    monkeypatch.setattr(jgen, "generate", lambda packed: (
        jgenerated.append(jgenerate(packed)), jgenerated[-1])[1])

    info = {k: v for k, v in _info(rng).items() if not k.endswith("_start")}
    pm = pflame.synthetic_flame_model(96, device="cpu")
    jm = jflame.synthetic_flame_model(96)
    for p1_vad, p2_vad in ((3.0, 1.0), (1.0, 3.0)):
        args = (frames, padded, "S1", "seg.mp4")
        pstim.render_segment(gen, pm, *args, tmp_path / "port", info, p1_vad, p2_vad)
        jstim.render_segment(jgen, jm, *args, tmp_path / "jax", info, p1_vad, p2_vad)
        assert_close(generated[-1], jgenerated[-1])
        assert generated[-1].shape == (1, n_gen, 106)
    assert len(port.calls) == len(jax_side.calls) == 2
    for (name, v1, v2, _, kw), (_, jv1, jv2, _, jkw) in zip(port.calls, jax_side.calls):
        assert name == "seg.mp4" and kw == jkw and kw["fps"] == 25
        assert v1.shape == v2.shape == (12, 96, 3)
        np.testing.assert_allclose(v1, jv1, atol=VERT_ATOL, rtol=0)   # ground truth
        np.testing.assert_allclose(v2, jv2, atol=2e-4, rtol=1e-4)     # generated
