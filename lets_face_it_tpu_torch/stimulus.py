"""Stimulus generation: dyadic avatar videos for user studies (the port of
``lets_face_it_tpu/stimulus.py``; reference
code/rendering/{render_seq,generate_test_sequences,rerender}.py, whose
imports are bit-rotted upstream, see SURVEY.md), on the port's ``Generator``
(``sample/generate.py``, the ``seq_rev`` kernel on the card), its FLAME
decoder (``render/flame.py``, on the model's device) and the native renderer.

Genders, shapes, skins and placements are drawn from ``random.Random(1234)``
unless given, as in the JAX package: Python's stream is the same in both, so
their meta JSONs agree.

Data layout consumed (under ``data_dir``):
    Sessions_vad/<session>/<P1|P2>.npy          crosstalk VAD tracks (50 fps)
    Sessions_50fps_voca/<session>/*<P>*/flame_params/<frame>.npy
                                                VOCA lipsync FLAME params
"""

from __future__ import annotations

import json
import random
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.render.flame import flame_vertices
from lets_face_it_tpu_torch.render.video import render_double_face_video
from lets_face_it_tpu_torch.utils.device import resolve_device

SHAPE_DIM = 300
PADDING = 24 * 2   # model warm-up frames x2 (every second frame is used)


# Provenance note: the next two helpers closely follow the structure of
# generate_test_sequences.py:20-48 (the `assert start_frames > 1`, the
# `[start-1:stop:2]` downsampling slice, the glob pattern and dict keys)
# because the on-disk Sessions_vad / Sessions_50fps_voca protocol and its
# 50->25 fps indexing quirk ARE the spec being replicated — the edge
# semantics are pinned by tests/test_segments_stimulus.py and, for this
# copy, tests/test_torch_stimulus.py.
def get_vad_weights(data_dir, participant: str, session: str,
                    start_frames: int, stop_frames: int) -> np.ndarray:
    vad = np.load((Path(data_dir) / "Sessions_vad" / session /
                   participant).with_suffix(".npy"))
    assert start_frames > 1
    return np.expand_dims(vad[start_frames - 1:stop_frames:2], 1)


def get_vocas(data_dir, participant: str, session: str, frame_nbs,
              vad_scaling_factor: float = 1.0) -> dict:
    """VAD-scaled VOCA lipsync params for the given 50-fps frame numbers
    (generate_test_sequences.py:27-48)."""
    int_frame_nbs = list(map(int, frame_nbs))
    vad = get_vad_weights(data_dir, participant, session, min(int_frame_nbs),
                          max(int_frame_nbs)) * vad_scaling_factor

    voca_dir = Path(data_dir) / "Sessions_50fps_voca" / session
    poses, expressions = [], []
    for f in sorted(voca_dir.glob(f"*{participant}*/flame_params/*")):
        if f.stem in frame_nbs:
            d = np.load(f, allow_pickle=True).item()
            poses.append(d["tf_pose"])
            expressions.append(d["tf_exp"])
    return {
        "pose": np.vstack(poses) * vad,
        "expression": np.vstack(expressions) * vad,
    }


def face_vertices(flame_model, face: dict, lipsync: dict | None,
                  shape) -> torch.Tensor:
    """FLAME vertices [T, V, 3], on the model's device, for a {expression,
    jaw, neck} sequence plus optional lipsync deltas (the reference's
    visualize.faces.render_face role)."""
    expression = np.asarray(face["expression"], np.float32)
    jaw = np.asarray(face["jaw"], np.float32)
    neck = np.asarray(face["neck"], np.float32)
    if lipsync is not None:
        expression = expression + lipsync["expression"][:, :expression.shape[1]]
        jaw = jaw + lipsync["pose"][:, 3:6]

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=flame_model.device)

    return flame_vertices(flame_model, dev(shape)[: expression.shape[0]],
                          dev(expression), dev(jaw), dev(neck))


def generate_videos(flame_model, sequences, output_dir, data_dir=None,
                    vad_scaling_factor: float = 1.0, overwrite: bool = False,
                    rng=None):
    """Render (name, session, left_face, right_face, info, frame_nbs) tuples
    to side-by-side mp4s with meta JSON (generate_test_sequences.py:51-139)."""
    rng = rng or random.Random(1234)
    output_dir = Path(output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)

    for file_name, session, left_face, right_face, info, frame_nbs in sequences:
        output_file = output_dir / file_name
        if output_file.exists() and not overwrite:
            continue
        seq_len = np.asarray(left_face["expression"]).shape[0]

        if info:
            left_gender, right_gender = info["left_gender"], info["right_gender"]
            left_shape = np.repeat(np.asarray(info["left_shape"])[None],
                                   seq_len, 0)
            right_shape = np.repeat(np.asarray(info["right_shape"])[None],
                                    seq_len, 0)
            left_skin, right_skin = (info["left_skin_color"],
                                     info["right_skin_color"])
            start = [info["left_start"], info["right_start"]]
        else:
            left_gender = rng.choice(["male", "female"])
            right_gender = rng.choice(["male", "female"])
            left_shape = np.repeat(
                np.asarray([rng.gauss(0, 1) for _ in range(SHAPE_DIM)])[None],
                seq_len, 0)
            right_shape = np.repeat(
                np.asarray([rng.gauss(0, 1) for _ in range(SHAPE_DIM)])[None],
                seq_len, 0)
            left_skin = rng.choice(["white", "black"])
            right_skin = rng.choice(["white", "black"])
            start = rng.sample([0, 136], 2)

        left_participant = "P1" if start[0] == 0 else "P2"
        right_participant = "P1" if start[0] == 136 else "P2"

        left_lipsync = right_lipsync = None
        if data_dir is not None:
            left_lipsync = get_vocas(data_dir, left_participant, session,
                                     frame_nbs, vad_scaling_factor)
            right_lipsync = get_vocas(data_dir, right_participant, session,
                                      frame_nbs, vad_scaling_factor)

        verts_l = face_vertices(flame_model, left_face, left_lipsync, left_shape)
        verts_r = face_vertices(flame_model, right_face, right_lipsync,
                                right_shape)

        if not info:
            meta_dir = output_file.parent / "meta"
            meta_dir.mkdir(exist_ok=True, parents=True)
            (meta_dir / output_file.stem).with_suffix(".txt").write_text(
                json.dumps({
                    "file_name": file_name,
                    "left_start": start[0], "right_start": start[1],
                    "left_gender": left_gender, "right_gender": right_gender,
                    "left_shape": left_shape[0].tolist(),
                    "right_shape": right_shape[0].tolist(),
                    "left_skin_color": left_skin,
                    "right_skin_color": right_skin,
                }))

        with tempfile.TemporaryDirectory() as tmpd:
            f_name = Path(tmpd) / file_name
            # user-study stimuli render textured, like the reference's
            # skin-texture OBJs (render_tools.py:117-165)
            render_double_face_video(str(f_name), verts_l, verts_r,
                                     flame_model.faces, fps=25,
                                     skin_color_v1=left_skin,
                                     skin_color_v2=right_skin,
                                     textured=True)
            shutil.move(str(f_name), output_file)


def rerender_from_meta(flame_model, meta_dir, frames_lookup, output_dir, *,
                       generator=None, data_dir=None, overwrite=False):
    """Re-render previously generated study videos from their meta JSONs
    (the reference's rerender.py flow): each ``meta/<name>.txt`` records the
    left/right placement, genders, shapes and skin colors; ``frames_lookup``
    maps a video name to its packed [T, 273] frame matrix (and optional
    50-fps frame numbers). When ``generator`` is given the right side is
    regenerated by the model, otherwise ground truth is re-rendered."""
    meta_dir = Path(meta_dir)
    for meta_file in sorted(meta_dir.glob("*.txt")):
        info = json.loads(meta_file.read_text())
        name = info["file_name"]
        lookup = frames_lookup(name)
        if lookup is None:
            continue
        frames, frame_nbs, session = lookup
        left_face = face_block(frames, info["left_start"])
        if generator is not None:
            predicted = generator.generate(frames)
            right_face = {
                "expression": predicted[0, :, :50],
                "jaw": predicted[0, :, 100:103],
                "neck": predicted[0, :, 103:106],
            }
            n = min(left_face["expression"].shape[0],
                    right_face["expression"].shape[0])
            left_face = {k: v[-n:] for k, v in left_face.items()}
            right_face = {k: v[-n:] for k, v in right_face.items()}
        else:
            right_face = face_block(frames, info["right_start"])
        generate_videos(flame_model,
                        [(name, session, left_face, right_face, info,
                          frame_nbs or [])],
                        output_dir, data_dir=data_dir, overwrite=overwrite)


def face_block(frames: np.ndarray, start: int) -> dict:
    """Slice a packed 273-D frame matrix into an expression/jaw/neck dict at
    a 0/136 offset (render_seq.py:31-36)."""
    return {
        "expression": frames[:, start:start + 50],
        "jaw": frames[:, start + 100:start + 103],
        "neck": frames[:, start + 103:start + 106],
    }


def render_segment(generator, flame_model, frames: np.ndarray,
                   frames_padded: np.ndarray, session: str, name: str,
                   output_dir, info: dict, p1_vad_sum: float,
                   p2_vad_sum: float, data_dir=None, frame_nbs=None):
    """The render_seq.py flow: the more-talkative participant goes on the
    left (GT), the model generates the right ("self") side from the padded
    history, both rendered side by side. ``generator`` is the port's
    ``Generator``; ``flame_model`` must be on its device."""
    device = resolve_device(generator.device)
    if flame_model.device.type != device.type:
        raise ValueError(f"the FLAME model is on {flame_model.device}, the "
                         f"generator on {device}")
    info = dict(info)
    if p1_vad_sum > p2_vad_sum:
        info["left_start"], info["right_start"] = 0, 136
    else:
        info["left_start"], info["right_start"] = 136, 0

    left_video = face_block(frames, info["left_start"])

    p1_idx = list(range(info["right_start"], info["right_start"] + 136))
    p2_idx = list(range(info["left_start"], info["left_start"] + 136))
    packed = np.concatenate([frames_padded[:, p1_idx],
                             frames_padded[:, p2_idx]], axis=1)
    # pad to the full 273-D layout expected by the generator
    if packed.shape[1] < 273:
        packed = np.concatenate(
            [packed, np.zeros((packed.shape[0], 273 - packed.shape[1]),
                              packed.dtype)], axis=1)

    predicted = generator.generate(packed)
    right_video = {
        "expression": predicted[0, :, :50],
        "jaw": predicted[0, :, 100:103],
        "neck": predicted[0, :, 103:106],
    }
    n = min(left_video["expression"].shape[0], right_video["expression"].shape[0])
    left_video = {k: v[-n:] for k, v in left_video.items()}
    right_video = {k: v[-n:] for k, v in right_video.items()}

    generate_videos(flame_model,
                    [(name, session, left_video, right_video, info,
                      frame_nbs or [])],
                    output_dir, data_dir=data_dir, vad_scaling_factor=2,
                    overwrite=True)
