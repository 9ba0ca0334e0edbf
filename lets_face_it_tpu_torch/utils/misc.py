"""Packed-face index layout (the port's copy of the one helper it needs from
``lets_face_it_tpu/utils/misc.py``)."""

from __future__ import annotations


def get_face_indicies(exp_dim: int, jaw_dim: int, neck_dim: int,
                      offset: int = 0) -> list[int]:
    """Column indices of expression/jaw/neck inside a packed 106-D face block
    (expression at +0, jaw at +100, neck at +103 — misc/utils.py:36-43)."""
    expression = list(range(offset, offset + exp_dim))
    jaw = list(range(100 + offset, 100 + offset + jaw_dim))
    neck = list(range(103 + offset, 103 + offset + neck_dim))
    return expression + jaw + neck
