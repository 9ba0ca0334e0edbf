"""Another run's start and random draws, replayed: its initial weights, the
draws of each training step and the probe permutations of each validation,
read from one ``.npz`` file, so that ``train(replay=...)`` takes the steps
that run took with its random numbers (the JAX package's, say: torch and
JAX random streams differ, so a run of the port cannot otherwise start
where a run of the JAX package started).

The file (``np.savez``; every entry an array):

``meta``
    A JSON string: ``{"format": 1, "config": name, "seed": int, "steps": S,
    "batch_size": B, "n_frames": N, "masks": {modality: [history,
    dropout]}, "val_steps": [step, ...], "val_batch": Bv, "val_seq_len": T,
    "probes": [metric name, ...]}``. S steps of B sequences of N trained
    frames; V = len(val_steps) validations, whose first val batch holds Bv
    sequences of T frames; ``probes`` the wrong-context probes, in the
    order the ``Mismatch`` groups list them (``mismatched_nll/
    shuffled_batch/p2``, ...).
``param/encoder/<path>``, ``param/flow/<path>``
    The initial weights, one leaf each, under its keys in the JAX
    package's parameter tree joined by "/" (``param/flow/rnn/w_ih``); the
    leaves of ``sample/weights.py::from_jax_params``.
``coin``
    [S] float32: step s trains on the deranged batch when ``coin[s] <
    0.1`` and the gate is open (``train/state.py``).
``perm``
    [S, B] int64: step s's batch permutation.
``mask/<modality>``
    uint8: the frame-dropout keep-masks [S, B, N, history] of each
    modality whose dropout is above 0, ``np.packbits`` of the flat bool
    array (the shape follows from ``meta``).
``probe/<name>/perm``
    [V, Bv] int64: validation v's batch permutation for probe ``<name>``.
``probe/<name>/time_perm``
    [V, T] int64: its time permutation, for the ``shuffled_time`` probes.
``ref/nll``, ``ref/grad_norm``, ``ref/deranged``
    Optional, [S] float64: the recorded run's own step metrics.

Nothing falls back: a step or a validation that the file does not hold, a
seed, a spec or a batch shape that differs from the file's and a missing or
extra leaf raise ``ValueError``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.model.encoders import dropout_mask_shapes
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.sample.weights import from_jax_params
from lets_face_it_tpu_torch.train.metrics import probe_groups
from lets_face_it_tpu_torch.train.state import StepDraws

FORMAT = 1
PARAM_PREFIX = "param/"


def probe_names(mismatch_cfg: dict) -> list:
    """The wrong-context probes' metric names, in the order they are
    computed (``train/metrics.py::probe_groups``)."""
    return [name for name, _, _ in probe_groups(mismatch_cfg)]


def pack_mask(mask) -> np.ndarray:
    """A bool array as ``mask/<modality>`` stores it."""
    return np.packbits(np.asarray(mask, dtype=bool).reshape(-1))


def unpack_mask(packed, shape) -> np.ndarray:
    return np.unpackbits(packed, count=int(np.prod(shape))).reshape(shape).astype(bool)


class Replay:
    """A replay file, read once into host memory."""

    def __init__(self, path):
        self.path = Path(path)
        with np.load(self.path, allow_pickle=False) as f:
            self.arrays = {k: f[k] for k in f.files}
        meta = json.loads(str(self.arrays.pop("meta")))
        if meta.get("format") != FORMAT:
            raise ValueError(f"{self.path.name}: replay format {meta.get('format')}, "
                             f"this reader takes {FORMAT}")
        self.meta = meta
        self.steps = int(meta["steps"])
        self.batch_size, self.n_frames = int(meta["batch_size"]), int(meta["n_frames"])
        self.val_steps = [int(s) for s in meta["val_steps"]]
        self._masks = {}    # unpacked on first use
        shapes = {"coin": (self.steps,), "perm": (self.steps, self.batch_size)}
        for name, shape in shapes.items():
            if self.arrays[name].shape != shape:
                raise ValueError(f"{self.path.name}: {name} {self.arrays[name].shape}, "
                                 f"meta says {shape}")

    @property
    def seed(self) -> int:
        return int(self.meta["seed"])

    def model(self, spec: FlowSpec) -> SeqGlow:
        """The initial weights as a ``SeqGlow`` on the CPU, through
        ``from_jax_params``; every leaf of ``spec``'s tree must be in the
        file at its shape, and nothing else."""
        trees = {"encoder": {}, "flow": {}}
        for key, value in self.arrays.items():
            if not key.startswith(PARAM_PREFIX):
                continue
            tree, *path = key[len(PARAM_PREFIX):].split("/")
            node = trees[tree]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = value
        model = from_jax_params(trees["encoder"], trees["flow"], spec)
        want = _leaf_shapes(SeqGlow.init(spec, torch.Generator().manual_seed(0)))
        got = _leaf_shapes(model)
        if got != want:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
            raise ValueError(f"{self.path.name}: the weights do not fit the spec: "
                             f"missing {missing}, extra {extra}, other shapes {shapes}")
        return model

    def check(self, spec: FlowSpec, hp, batch_size: int, n_frames: int,
              seed: int) -> None:
        """Raise unless the run of ``spec`` and ``hp`` at ``seed``, at
        ``batch_size`` sequences of ``n_frames`` trained frames, takes
        exactly the file's draws, and its validations only the file's
        permutations. The seed still orders each epoch's batches, so it
        must be the file's."""
        if seed != self.seed:
            raise ValueError(f"{self.path.name}: seed {self.seed}, the run has {seed}")
        masks = {name: [shape[2], float(getattr(spec.cond, name).dropout)]
                 for name, shape in dropout_mask_shapes(spec.cond, batch_size,
                                                        n_frames).items()}
        want = {"batch_size": batch_size, "n_frames": n_frames, "masks": masks,
                "probes": probe_names(getattr(hp, "Mismatch", {}))}
        for key, value in want.items():
            if self.meta[key] != value:
                raise ValueError(f"{self.path.name}: {key} {self.meta[key]}, "
                                 f"the run has {value}")
        val = hp.Validation
        if val.get("inference", False) or int(val.get("gap_permutations", 1) or 1) > 1:
            raise ValueError("a replayed run's validation takes no draws of its "
                             "own: set Validation.inference off and "
                             "gap_permutations to 1")
        if int(val["seq_len"]) != int(self.meta["val_seq_len"]):
            raise ValueError(f"{self.path.name}: val_seq_len "
                             f"{self.meta['val_seq_len']}, the run has {val['seq_len']}")

    def draws(self, step: int) -> StepDraws:
        """Step ``step``'s coin, permutation and dropout masks."""
        if not 0 <= step < self.steps:
            raise ValueError(f"{self.path.name} holds steps 0..{self.steps - 1}; "
                             f"the run asked for step {step}")
        masks = {}
        for name, (history, _) in self.meta["masks"].items():
            shape = (self.steps, self.batch_size, self.n_frames, int(history))
            if name not in self._masks:
                self._masks[name] = unpack_mask(self.arrays[f"mask/{name}"], shape)
            masks[name] = torch.from_numpy(self._masks[name][step].copy())
        return StepDraws(float(self.arrays["coin"][step]),
                         torch.from_numpy(self.arrays["perm"][step].astype(np.int64)),
                         masks)

    def probe_permutations(self, step: int, batch_size: int, seq_len: int) -> dict:
        """{probe name: (perm [Bv], time_perm [T] or None)} of the validation
        at ``step`` on a first val batch of ``batch_size`` sequences of
        ``seq_len`` frames."""
        if step not in self.val_steps:
            raise ValueError(f"{self.path.name} holds validations at "
                             f"{self.val_steps}; the run validated at step {step}")
        if (batch_size, seq_len) != (int(self.meta["val_batch"]),
                                     int(self.meta["val_seq_len"])):
            raise ValueError(f"{self.path.name}: a val batch of "
                             f"{self.meta['val_batch']} x {self.meta['val_seq_len']}, "
                             f"the run's is {batch_size} x {seq_len}")
        v = self.val_steps.index(step)
        out = {}
        for name in self.meta["probes"]:
            perm = torch.from_numpy(self.arrays[f"probe/{name}/perm"][v].astype(np.int64))
            tkey = f"probe/{name}/time_perm"
            time_perm = (torch.from_numpy(self.arrays[tkey][v].astype(np.int64))
                         if tkey in self.arrays else None)
            out[name] = (perm, time_perm)
        return out

    def reference(self) -> dict | None:
        """The recorded run's per-step metrics {nll, grad_norm, deranged}
        ([S] float64), where the file holds them."""
        keys = ("nll", "grad_norm", "deranged")
        if not all(f"ref/{k}" in self.arrays for k in keys):
            return None
        return {k: self.arrays[f"ref/{k}"] for k in keys}


def _leaf_shapes(model: SeqGlow) -> dict:
    return {f"{tree}.{name}": tuple(p.shape)
            for tree in ("encoder", "flow")
            for name, p in getattr(model, tree).named_parameters()}


def open_replay(replay) -> Replay:
    """``replay`` as a ``Replay`` (a path, or one already read)."""
    return replay if isinstance(replay, Replay) else Replay(replay)
