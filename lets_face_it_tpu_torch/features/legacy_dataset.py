"""Legacy flat packed-frame dataset (the port's copy of
``lets_face_it_tpu/features/legacy_dataset.py``; ``h5py`` is imported by
the functions that read or write HDF5): the reference's 50 fps pipeline,
extract_pytorch_daset.py — upstream the script is bit-rotted: missing
``misc.read_n_write`` import and unbalanced parens; the *format* survives
because ``generate_motion`` consumes it, generate_motion_from_model.py:73-87).

Flat HDF5 schema:
    p1_face [T, 106], p1_speech [T, 30], p2_face [T, 106], p2_speech [T, 30],
    frame_nb [T, 1], chunks [n_chunks] (row counts per contiguous chunk),
    standardization/{face,speech}/{means,stds}

Packed row layout: expression at +0, jaw at +100, neck at +103 within each
106-D face block; P2's block mirrors P1's at offset 136; col 272 = frame_nb.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def flame2glow(expression: np.ndarray, pose: np.ndarray,
               neck: np.ndarray) -> np.ndarray:
    """FLAME params -> packed 106-D face rows (expression/jaw/neck blocks)."""
    n = expression.shape[0]
    out = np.zeros((n, 106), np.float32)
    e = min(expression.shape[1], 100)
    out[:, :e] = expression[:, :e]
    out[:, 100:103] = pose[:, 3:6]
    out[:, 103:106] = neck
    return out


def pack_rows(p1_face_106, p1_speech, p2_face_106, p2_speech,
              frame_nbs) -> np.ndarray:
    """-> [T, 273] packed rows."""
    return np.concatenate([
        p1_face_106, p1_speech, p2_face_106, p2_speech,
        np.asarray(frame_nbs, np.float32).reshape(-1, 1)], axis=1)


def write_packed_dataset(split_chunks: dict[str, list[np.ndarray]],
                         out_dir, *, means=None, stds=None):
    """Write {split: [chunk [T_i, 273]]} to <out_dir>/{split}.hdf5.

    Standardization stats (first 136 cols: face + speech) come from the train
    split unless given; face and speech of BOTH parties standardized by the
    P1-column stats, as the reference does (extract_pytorch_daset.py:254-256).
    """
    import h5py

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if means is None:
        rows = np.concatenate(split_chunks["train"], axis=0)
        means = rows[:, :136].mean(axis=0)
        stds = rows[:, :136].std(axis=0)
    stds = np.where(stds == 0, 1.0, stds)

    paths = {}
    for split, chunks in split_chunks.items():
        path = out_dir / f"{split}.hdf5"
        std_chunks = []
        lengths = []
        for chunk in chunks:
            c = np.asarray(chunk, np.float32).copy()
            c[:, :136] = (c[:, :136] - means) / stds
            c[:, 136:272] = (c[:, 136:272] - means) / stds
            std_chunks.append(c)
            lengths.append(c.shape[0])
        data = (np.concatenate(std_chunks, axis=0) if std_chunks
                else np.zeros((0, 273), np.float32))
        with h5py.File(path, "w") as f:
            f["standardization/face/means"] = means[:106]
            f["standardization/face/stds"] = stds[:106]
            f["standardization/speech/means"] = means[106:136]
            f["standardization/speech/stds"] = stds[106:136]
            f["chunks"] = np.asarray(lengths, np.int64)
            f["p1_face"] = data[:, :106]
            f["p1_speech"] = data[:, 106:136]
            f["p2_face"] = data[:, 136:242]
            f["p2_speech"] = data[:, 242:272]
            f["frame_nb"] = data[:, 272:273]
        paths[split] = path
    return paths


class PackedFrameStore:
    """Random access into a legacy flat hdf5 — provides the ``get_frames``
    capability the reference imports from the missing
    ``data_segments.find_test_segments`` module."""

    def __init__(self, path):
        import h5py

        self.path = Path(path)
        with h5py.File(self.path, "r") as f:
            self.chunk_lengths = f["chunks"][()]
            self.face_means = f["standardization/face/means"][()]
            self.face_stds = f["standardization/face/stds"][()]
            self.speech_means = f["standardization/speech/means"][()]
            self.speech_stds = f["standardization/speech/stds"][()]
        self.chunk_offsets = np.concatenate(
            [[0], np.cumsum(self.chunk_lengths)])

    def get_frames(self, chunk_idx: int, start: int = 0,
                   stop: int | None = None) -> np.ndarray:
        """[T, 273] packed rows for a frame range within one chunk."""
        import h5py

        lo = self.chunk_offsets[chunk_idx]
        hi = self.chunk_offsets[chunk_idx + 1]
        stop = hi - lo if stop is None else stop
        with h5py.File(self.path, "r") as f:
            sl = slice(int(lo + start), int(lo + stop))
            return np.concatenate([
                f["p1_face"][sl], f["p1_speech"][sl], f["p2_face"][sl],
                f["p2_speech"][sl], f["frame_nb"][sl]], axis=1)
