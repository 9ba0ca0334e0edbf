"""Shared helpers (the port's copy of ``lets_face_it_tpu/utils/misc.py``;
reference misc/utils.py): session metadata lookup, ms/frame conversions,
packed-face index layout."""

from __future__ import annotations

import json
import re
from datetime import datetime
from pathlib import Path


def get_gender(meta_data_path, session: str, participant: str) -> str:
    """Gender of a session participant from meta_data.json
    (misc/utils.py:8-11)."""
    with open(meta_data_path) as f:
        meta = json.load(f)
    subject_id = meta["sessions"][session][participant]
    return meta["subjects"][subject_id]["gender"]


def get_participant(path: str) -> str:
    return re.search(r"\d_(.+)_FaceNear", path).group(1)


def replace_part(path: Path, original: str, replacement: str) -> Path:
    return Path(*[x.replace(original, replacement) for x in path.parts])


def ms2frames(ms: float, fps: int = 50) -> int:
    return round((ms / 1000) * fps) + 1


def frames2s(f: float, fps: int = 50) -> float:
    return f / fps


def frames2ms(f: float, fps: int = 50) -> int:
    return int(((f - 1) / fps) * 1000)


def get_training_name() -> str:
    dt = datetime.now()
    return (f"{dt.day}-{dt.month}_{dt.hour}-{dt.minute}-{dt.second}."
            f"{str(dt.microsecond)[:2]}")


def get_face_indicies(exp_dim: int, jaw_dim: int, neck_dim: int,
                      offset: int = 0) -> list[int]:
    """Column indices of expression/jaw/neck inside a packed 106-D face block
    (expression at +0, jaw at +100, neck at +103 — misc/utils.py:36-43)."""
    expression = list(range(offset, offset + exp_dim))
    jaw = list(range(100 + offset, 100 + offset + jaw_dim))
    neck = list(range(103 + offset, 103 + offset + neck_dim))
    return expression + jaw + neck
