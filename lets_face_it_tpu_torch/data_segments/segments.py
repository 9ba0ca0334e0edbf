"""Annotation-driven segment selection over the MAHNOB Mimicry splits (the
port of ``lets_face_it_tpu/data_segments/segments.py``; numpy only).

Same interval semantics as the reference tooling
(code/data_segments/get_data_segments.py) on the dataset-definition JSONs it
ships (not bundled here — point ``data_dir`` at a directory containing
``train_val_test.json`` and ``annotations.json``):

  train_val_test.json   {split: {session: [[start_ms, stop_ms], ...]}}
  annotations.json      {session: {mimicry_type: [[start, stop, value], ...]}}

Design differs from the reference on purpose: segments are frozen
dataclasses over millisecond intervals with *explicit* second/frame view
properties (the reference resolves ``*_s``/``*_frames`` suffixes dynamically
in ``__getattr__``), and the mimicry segmentation is a per-session generator
threading a gap cursor rather than one nested accumulator loop.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np

from lets_face_it_tpu_torch.utils.misc import ms2frames

#: The annotation/VAD frame rate of the raw MAHNOB recordings (the model
#: pipeline runs at 25 fps; segment bookkeeping stays at the native 50).
NATIVE_FPS = 50

#: Split key in train_val_test.json reserved for the user-study heldout
#: session — never enumerated as training/eval material.
HELDOUT_SPLIT = "heldout_interaction"


class _MsInterval:
    """Explicit unit views over a [start_ms, stop_ms] interval.

    ``*_frames`` values are 1-based 50 fps frame indices (frame 1 covers
    t = 0), matching ``ms2frames`` and the reference's indexing convention.
    """

    start_ms: int
    stop_ms: int

    @property
    def duration_ms(self) -> int:
        return self.stop_ms - self.start_ms

    @property
    def start_s(self) -> float:
        return self.start_ms / 1000.0

    @property
    def stop_s(self) -> float:
        return self.stop_ms / 1000.0

    @property
    def duration_s(self) -> float:
        return self.duration_ms / 1000.0

    @property
    def start_frames(self) -> int:
        return ms2frames(self.start_ms, fps=NATIVE_FPS)

    @property
    def stop_frames(self) -> int:
        return ms2frames(self.stop_ms, fps=NATIVE_FPS)

    @property
    def duration_frames(self) -> int:
        return ms2frames(self.duration_ms, fps=NATIVE_FPS)

    def frame_bounds(self) -> tuple[int, int]:
        """(start, stop) as native-fps frame indices, clamped to the
        enclosing valid data range (identity for a DataSegment)."""
        return self.start_frames, self.stop_frames

    def clamped_frames(self, start_frames: int | None = None,
                       stop_frames: int | None = None) -> tuple[int, int]:
        """Resolve an optional frame-range override against this segment's
        own bounds, never exceeding the enclosing valid data range."""
        lo, hi = self.frame_bounds()
        start = self.start_frames if not start_frames else start_frames
        stop = self.stop_frames if not stop_frames else stop_frames
        return max(lo, start), min(hi, stop)

    def vad_weights(self, data_dir, participant: str, *, only_odd=False,
                    start_frames=None, stop_frames=None) -> np.ndarray:
        """[T, 1] crosstalk-VAD weights over this segment, loaded from the
        per-participant ``Sessions_vad/<session>/<participant>.npy`` track
        (``only_odd`` keeps every other 50 fps frame → 25 fps)."""
        start, stop = self.clamped_frames(start_frames, stop_frames)
        path = (Path(data_dir) / "Sessions_vad" / self.session /
                participant).with_suffix(".npy")
        track = np.load(path)
        step = 2 if only_odd else 1
        return track[start - 1:stop - 1:step, np.newaxis]


@dataclass(frozen=True)
class DataSegment(_MsInterval):
    """One valid recording range of a session within a dataset split."""

    session: str
    data_type: str
    start_ms: int
    stop_ms: int

    def __repr__(self):
        return (f"DataSegment(start_ms={self.start_ms}, stop_ms={self.stop_ms},"
                f" session={self.session}, data_type={self.data_type})")


@dataclass(frozen=True)
class MimicrySegment(_MsInterval):
    """An annotated (or gap, ``mimicry_type=None``) interval inside a
    DataSegment."""

    mimicry_type: str | None
    start_ms: int
    stop_ms: int
    data_segment: DataSegment
    session: str = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "session", self.data_segment.session)

    def frame_bounds(self) -> tuple[int, int]:
        return (self.data_segment.start_frames, self.data_segment.stop_frames)

    def __repr__(self):
        return (f"MimicrySegment(mimicry_type={self.mimicry_type}, "
                f"start_ms={self.start_ms}, stop_ms={self.stop_ms}, "
                f"data_segment={self.data_segment})")


# Keep the old name importable: the shared interval behavior used to live on
# a ``Segment`` base class.
Segment = _MsInterval


def get_segments_v2(splits_file) -> list[tuple]:
    """Flatten train_val_test.json into (session, split, start_ms, stop_ms)
    tuples, skipping the heldout interaction."""
    with open(splits_file) as fh:
        splits = json.load(fh)
    return [
        (session, split, int(start), int(stop))
        for split, sessions in splits.items()
        if split != HELDOUT_SPLIT
        for session, ranges in sessions.items()
        for start, stop in ranges
    ]


def _session_mimicry_segments(
        session: str, split: str,
        valid_ranges: list[list[int]],
        annotations: dict[str, list[list[int]]],
) -> Iterator[MimicrySegment]:
    """Yield annotated + gap segments for one session.

    The gap cursor starts at 0 and threads across valid ranges, and
    annotation intervals are consumed grouped by type (each type's intervals
    time-sorted) — both properties of the reference's segmentation that
    downstream study-set construction was built around.
    """
    cursor = 0
    for valid_start, valid_stop in sorted(map(tuple, valid_ranges)):
        parent = DataSegment(session, split, valid_start, valid_stop)
        for mimicry_type, intervals in annotations.items():
            for start, stop, _value in sorted(map(tuple, intervals)):
                if start < valid_start or stop > valid_stop:
                    continue
                yield MimicrySegment(None, cursor, start - 1, parent)
                yield MimicrySegment(mimicry_type, start, stop, parent)
                cursor = stop + 1
        yield MimicrySegment(None, cursor, valid_stop, parent)


def get_segments(splits_file, annotations_file, type_="train"
                 ) -> list[MimicrySegment]:
    """Mimicry/non-mimicry interval segmentation of the annotated sessions:
    each annotated interval fully inside a valid split range becomes a
    MimicrySegment, with the stretches between annotations emitted as
    ``mimicry_type=None`` gap segments."""
    with open(splits_file) as fh:
        splits = json.load(fh)
    with open(annotations_file) as fh:
        all_annotations = json.load(fh)

    split_ranges = splits[type_]
    out: list[MimicrySegment] = []
    for session, annotations in all_annotations.items():
        out.extend(_session_mimicry_segments(
            session, type_, split_ranges.get(session, []), annotations))
    return out


def flame_params_from_h5(h5_file, start: int | None = None,
                         stop: int | None = None) -> dict:
    """Unpack a ``flame_{fps}fps.h5`` (our fitter's output) into the segment
    toolkit's param dict {shape, expression, pose, neck, eye, rot}
    (get_data_segments.py:189-215 layout)."""
    import h5py

    with h5py.File(h5_file, "r") as f:
        sl = slice(start, stop)
        tf_pose = f["tf_pose"][sl]
        tf_rot = f["tf_rot"][sl]
        n = tf_pose.shape[0]
        return {
            "shape": f["tf_shape"][sl],
            "expression": f["tf_exp"][sl],
            "pose": np.concatenate([np.zeros((n, 3)), tf_pose[:, 3:6]], axis=1),
            "neck": tf_pose[:, :3] + tf_rot,
            "eye": tf_pose[:, 6:12],
            "rot": tf_rot,
        }


def merge_flame_params_and_voca(flame_params: dict, voca_flame_params: dict,
                                vad_weights: np.ndarray, *, window=11,
                                polyorder=3, rng=None) -> dict:
    """Savgol-smoothed face params + VAD-weighted VOCA lipsync
    (get_data_segments.py:98-137): neck re-centered by the mean x-rotation,
    random 100-D shape held over the sequence, voca pose/expression scaled by
    per-frame VAD activity."""
    from scipy.signal import savgol_filter

    smooth_pose = savgol_filter(flame_params["pose"], window, polyorder, axis=0)
    smooth_expression = savgol_filter(flame_params["expression"], window,
                                      polyorder, axis=0)
    avg_rot = flame_params["rot"].mean(axis=0)
    avg_rot[1:] = 0
    smooth_neck = (savgol_filter(flame_params["neck"], window, polyorder,
                                 axis=0) - avg_rot)

    rng = rng or np.random.default_rng()
    shape = np.zeros((1, 300))
    shape[:, :100] = rng.standard_normal(100)
    shape_params = np.repeat(shape, smooth_pose.shape[0], axis=0)

    voca_pose = voca_flame_params["pose"] * np.repeat(
        vad_weights, voca_flame_params["pose"].shape[1], axis=1)
    voca_expression = voca_flame_params["expression"] * np.repeat(
        vad_weights, voca_flame_params["expression"].shape[1], axis=1)

    return {
        "shape_params": shape_params,
        "pose_params": smooth_pose + voca_pose,
        "expression_params": smooth_expression + voca_expression,
        "neck_params": smooth_neck,
        "eye_params": flame_params["eye"],
    }
