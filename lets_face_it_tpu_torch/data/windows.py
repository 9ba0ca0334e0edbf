"""Standardization statistics of the ``lets_face_it.h5`` feature store (the
two helpers the serving path needs from ``lets_face_it_tpu/data/windows.py``;
the windowed training dataset waits for the data-path slice)."""

from __future__ import annotations

import numpy as np


def load_standardization(f) -> tuple[dict, dict]:
    """Read /means and /stds groups (present once training data was combined)
    from an open ``h5py.File``."""
    means, stds = {}, {}
    if "means" in f:
        for k in f["means"]:
            means[k] = f["means"][k][()]
            stds[k] = f["stds"][k][()]
    return means, stds


def face_means_stds(means: dict, stds: dict, expression_dim: int):
    """Concatenated mean/std vectors for the packed face layout
    expression[:exp_dim]‖jaw‖neck (mimicry_logger.py:49-63)."""
    mean = np.concatenate([
        means["flame_expression"][:expression_dim],
        means["flame_jaw"], means["flame_neck"]])
    std = np.concatenate([
        stds["flame_expression"][:expression_dim],
        stds["flame_jaw"], stds["flame_neck"]])
    return mean.astype(np.float32), std.astype(np.float32)
