"""Sliding-window dataset over the feature store, and its standardization
statistics (the port of ``lets_face_it_tpu/data/windows.py``).

Store schema (the reference combiner, combine_features.py:172-216):

    /{train,val,test}/{kind}/{chunk_i}/{agent,interlocutor}
    /means/{kind}, /stds/{kind}           (train-agent statistics)

kinds: flame_expression [T,50], flame_jaw [T,3], flame_neck [T,3],
mfcc [T,26], prosody [T,4] (face kinds stored standardized, audio raw).

All chunks of a split are concatenated once into one host array per
modality; a window is ``big[start : start + seq_len]``, and a batch is the
copy of its windows (``data/prefetch.py::NativeGather``). The chunks come
from an HDF5 file (``WindowDataset.from_file``, which imports ``h5py``) or
from a ``Corpus`` in memory (``WindowDataset.from_chunks``: from
``data/synthetic.py`` or ``features/combine.py::combine_corpus``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclass
class Corpus:
    """The store in memory: splits[name] is a list of chunks, each {kind:
    {"agent": [T, d], "interlocutor": [T, d]}} as stored; means/stds are
    the train-agent statistics per kind."""
    splits: dict
    means: dict
    stds: dict


class WindowDataset:
    """All sliding windows of ``seq_len`` (stride 1) over every chunk of a split.

    Batches are shaped like the reference's ``MimicryDataset`` items
    (mimicry_data_module.py:44-78):
      p1_face   [B, T, exp_dim+3+3]   agent  expression‖jaw‖neck
      p2_face   [B, T, ...]           interlocutor (if conditioned on)
      p1_speech [B, T, 30]            agent  mfcc‖prosody (if conditioned on)
      p2_speech [B, T, 30]            interlocutor mfcc‖prosody (if conditioned on)
    """

    def __init__(self, chunks, data_hparams: dict, conditioning_hparams: dict,
                 seq_len: int, means: dict | None = None, stds: dict | None = None):
        """``chunks``: a split's chunks in order, each a mapping
        kind -> {"agent": [T, d], "interlocutor": [T, d]}."""
        self.seq_len = seq_len
        self.means, self.stds = means or {}, stds or {}
        exp_dim = data_hparams["expression_dim"]
        with_p2_face = bool(conditioning_hparams["p2_face"]["history"])
        with_p1_speech = bool(conditioning_hparams["p1_speech"]["history"])
        with_p2_speech = bool(conditioning_hparams["p2_speech"]["history"])

        def face(chunk, who):
            return np.concatenate([chunk["flame_expression"][who][:, :exp_dim],
                                   chunk["flame_jaw"][who][()],
                                   chunk["flame_neck"][who][()]],
                                  axis=1).astype(np.float32)

        def speech(chunk, who):
            return np.concatenate([chunk["mfcc"][who][()],
                                   chunk["prosody"][who][()]],
                                  axis=1).astype(np.float32)

        modalities: dict[str, list[np.ndarray]] = {}
        lengths = []
        for chunk in chunks:
            lengths.append(chunk["prosody"]["agent"].shape[0])
            modalities.setdefault("p1_face", []).append(face(chunk, "agent"))
            if with_p2_face:
                modalities.setdefault("p2_face", []).append(face(chunk, "interlocutor"))
            if with_p1_speech:
                modalities.setdefault("p1_speech", []).append(speech(chunk, "agent"))
            if with_p2_speech:
                modalities.setdefault("p2_speech", []).append(
                    speech(chunk, "interlocutor"))
        self.arrays = {k: np.concatenate(v, axis=0) for k, v in modalities.items()}

        starts = []
        offset = 0
        for n in lengths:
            if n >= seq_len:
                starts.append(offset + np.arange(n - seq_len + 1))
            offset += n
        self.window_starts = (np.concatenate(starts) if starts
                              else np.zeros((0,), np.int64))

    @classmethod
    def from_chunks(cls, corpus: Corpus, split: str, data_hparams: dict,
                    conditioning_hparams: dict, seq_len: int) -> "WindowDataset":
        """A split of a corpus in memory."""
        return cls(corpus.splits[split], data_hparams, conditioning_hparams,
                   seq_len, corpus.means, corpus.stds)

    @classmethod
    def from_file(cls, file_name, split: str, data_hparams: dict,
                  conditioning_hparams: dict, seq_len: int) -> "WindowDataset":
        """A split of an HDF5 feature store (needs ``h5py``)."""
        import h5py

        with h5py.File(Path(file_name), "r") as f:
            grp = f[split]
            keys = sorted(grp["prosody"].keys(), key=int)
            chunks = [{kind: {who: grp[kind][key][who][()]
                              for who in ("agent", "interlocutor")}
                       for kind in ("flame_expression", "flame_jaw",
                                    "flame_neck", "mfcc", "prosody")}
                      for key in keys]
            means, stds = load_standardization(f)
        return cls(chunks, data_hparams, conditioning_hparams, seq_len, means, stds)

    def __len__(self) -> int:
        return len(self.window_starts)

    def get_batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        from lets_face_it_tpu_torch.data.prefetch import NativeGather

        starts = self.window_starts[indices]
        return {name: NativeGather.gather(arr, starts, self.seq_len)
                for name, arr in self.arrays.items()}

    def epoch_index_batches(self, batch_size: int, *,
                            rng: np.random.Generator | None = None,
                            shuffle: bool = True, drop_last: bool = False,
                            ) -> Iterator[np.ndarray]:
        """The epoch's window-index batches: a permutation from ``rng`` when
        shuffling, cut into batches in order."""
        order = np.arange(len(self))
        if shuffle:
            if rng is None:
                raise ValueError("shuffling needs an rng")
            order = rng.permutation(order)
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            if drop_last and len(sel) < batch_size:
                break
            yield sel

    def epoch_batches(self, batch_size: int, *, rng: np.random.Generator | None = None,
                      shuffle: bool = True, drop_last: bool = False,
                      ) -> Iterator[dict[str, np.ndarray]]:
        for sel in self.epoch_index_batches(batch_size, rng=rng, shuffle=shuffle,
                                            drop_last=drop_last):
            yield self.get_batch(sel)

    def num_batches(self, batch_size: int, drop_last: bool = False) -> int:
        if drop_last:
            return len(self) // batch_size
        return -(-len(self) // batch_size)


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
