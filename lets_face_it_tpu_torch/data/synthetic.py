"""Synthetic dyadic feature corpus built in memory from a seed (the port of
``lets_face_it_tpu/data/synthetic.py`` without the HDF5 file).

Smooth, correlated motion so the flow has structure to learn: each chunk is a
sum of low-frequency sinusoids plus noise, the interlocutor's face lags and
mirrors the agent's, and speech features are band-limited noise correlated
with jaw motion. The signals are drawn in the same order from
``np.random.default_rng(seed)`` as the JAX package draws them, so the arrays
equal the ones its ``write_synthetic_dataset`` stores; the sines of a block
of chunks are computed on a thread pool once the block's draws are taken. Face kinds are
standardized with the train-agent statistics, audio kinds are raw, as the
combiner stores them. ``write_synthetic_dataset`` writes the same corpus as
HDF5 where ``h5py`` imports.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from lets_face_it_tpu_torch.data.windows import Corpus

KINDS = ("flame_expression", "flame_jaw", "flame_neck", "mfcc", "prosody", "openface")
DIMS = {"flame_expression": 50, "flame_jaw": 3, "flame_neck": 3,
        "mfcc": 26, "prosody": 4, "openface": 136}
AUDIO_KINDS = ("mfcc", "prosody")


def _draw_signal(rng, n_frames, dim, n_waves=4, noise=0.05):
    """The draws of one signal, in the order the JAX package takes them."""
    freqs = rng.uniform(0.002, 0.08, (n_waves, dim))
    phases = rng.uniform(0, 2 * np.pi, (n_waves, dim))
    amps = rng.uniform(0.2, 1.0, (n_waves, dim))
    return freqs, phases, amps, noise * rng.standard_normal((n_frames, dim))


def _signal(draws):
    freqs, phases, amps, noise = draws
    t = np.arange(len(noise))[:, None]
    sig = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in zip(amps, freqs, phases))
    return (sig + noise).astype(np.float32)


def _draw_chunk(rng, n_frames, dims):
    """A chunk's draws: every agent signal, then every interlocutor one."""
    return ({k: _draw_signal(rng, n_frames, d) for k, d in dims.items()},
            {k: _draw_signal(rng, n_frames, d) for k, d in dims.items()})


def _make_chunk(draws):
    agent_draws, inter_draws = draws
    agent = {k: _signal(v) for k, v in agent_draws.items()}
    inter = {}
    lag = 8
    for k, v in inter_draws.items():
        mirrored = np.roll(agent[k], lag, axis=0) * 0.6
        inter[k] = (mirrored + 0.4 * _signal(v)).astype(np.float32)
    # crude audio/jaw correlation
    agent["mfcc"][:, 0] += 0.5 * agent["flame_jaw"][:, 0]
    inter["mfcc"][:, 0] += 0.5 * inter["flame_jaw"][:, 0]
    return agent, inter


def tiny_dims(expression_dim=6, speech_mfcc=4, prosody=3):
    """Smaller dims for fast unit tests."""
    return {"flame_expression": expression_dim, "flame_jaw": 3, "flame_neck": 3,
            "mfcc": speech_mfcc, "prosody": prosody, "openface": 8}


def dims_for(data_hparams: dict) -> dict:
    """The corpus dims a config reads: the full ``DIMS`` when its face and
    speech widths fit them, else ``tiny_dims`` of its widths."""
    exp, speech = data_hparams["expression_dim"], data_hparams["speech_dim"]
    if exp <= DIMS["flame_expression"] and speech == DIMS["mfcc"] + DIMS["prosody"]:
        return DIMS
    return tiny_dims(exp, speech - 3, 3)


def make_synthetic_corpus(*, n_train_chunks=4, n_val_chunks=2, n_test_chunks=2,
                          frames_per_chunk=160, seed=0,
                          dims: dict | None = None) -> Corpus:
    dims = dims or DIMS
    rng = np.random.default_rng(seed)
    counts = {"train": n_train_chunks, "val": n_val_chunks, "test": n_test_chunks}
    chunks = {s: [] for s in counts}
    workers = min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for split, n in counts.items():
            # the draws in order on this thread, a block of chunks at a time;
            # the sines (numpy releases the GIL) on the pool
            for i in range(0, n, 4 * workers):
                draws = [_draw_chunk(rng, frames_per_chunk, dims)
                         for _ in range(min(4 * workers, n - i))]
                chunks[split].extend(pool.map(_make_chunk, draws))
    # train-agent statistics, as the combiner computes them
    # (combine_features.py:197-204)
    means, stds = {}, {}
    for kind in dims:
        rows = np.concatenate([agent[kind] for agent, _ in chunks["train"]], axis=0)
        means[kind] = rows.mean(axis=0)
        stds[kind] = rows.std(axis=0) + 1e-6

    def stored(kind, arr):
        if kind not in AUDIO_KINDS:     # face kinds are stored standardized
            arr = (arr - means[kind]) / stds[kind]
        return arr.astype(np.float32)

    splits = {s: [{kind: {"agent": stored(kind, agent[kind]),
                          "interlocutor": stored(kind, inter[kind])}
                   for kind in dims}
                  for agent, inter in split_chunks]
              for s, split_chunks in chunks.items()}
    return Corpus(splits, means, stds)


def write_synthetic_dataset(path, **kwargs) -> Path:
    """Write ``make_synthetic_corpus(**kwargs)`` in the reference schema
    (needs ``h5py``); returns the path."""
    import h5py

    corpus = make_synthetic_corpus(**kwargs)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        for kind in corpus.means:
            f.create_dataset(f"/means/{kind}", data=corpus.means[kind])
            f.create_dataset(f"/stds/{kind}", data=corpus.stds[kind])
        for split, chunks in corpus.splits.items():
            for i, chunk in enumerate(chunks):
                for kind, pair in chunk.items():
                    for who, arr in pair.items():
                        f.create_dataset(f"/{split}/{kind}/{i}/{who}", data=arr)
    return path
