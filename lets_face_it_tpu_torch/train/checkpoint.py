"""Training checkpoints: one ``torch.save`` file per save, in a directory
named by the step (the port of ``lets_face_it_tpu/train/checkpoint.py``,
which writes orbax directories).

A file holds the model's ``state_dict`` in the reference's glow_pytorch names
(``sample/weights.py::state_dict_reference``, so that
``Generator.from_checkpoint`` loads it unchanged), the hparams, the
optimizer state, the step generator's state and the meta: ``step``,
``epoch``, ``epoch_step`` (batches of that epoch consumed), ``actnorm_inited``
(resumed models never re-run data-dependent init, reference
models.py:515-518), ``last_mismatched_nll`` and ``val_loss``. Restoring all of
it continues the run exactly.
"""

from __future__ import annotations

from pathlib import Path

import torch

from lets_face_it_tpu_torch.sample.weights import (load_state_dict,
                                                   state_dict_reference)
from lets_face_it_tpu_torch.train.state import TrainState


def save_checkpoint(path, state: TrainState, hp, *, epoch: int, epoch_step: int,
                    actnorm_inited: bool, val_loss: float | None = None) -> Path:
    path = Path(path)
    payload = {
        "state_dict": state_dict_reference(state.model),
        "hparams": {k: v for k, v in vars(hp).items()},
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "meta": {"step": state.step, "epoch": int(epoch),
                 "epoch_step": int(epoch_step),
                 "actnorm_inited": bool(actnorm_inited),
                 "last_mismatched_nll": float(state.last_mismatched_nll),
                 "val_loss": None if val_loss is None else float(val_loss)},
    }
    # written beside the step's directory, then moved in: a step directory
    # never holds a partial file
    tmp = path.parent.parent / f".{path.parent.name}.tmp"
    tmp.parent.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp)
    path.parent.mkdir(exist_ok=True)
    tmp.replace(path)
    return path


def restore_checkpoint(path, state: TrainState) -> dict:
    """Load a checkpoint into ``state`` in place (model on its device,
    optimizer, generator, step, last mismatched NLL); returns the meta."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    load_state_dict(state.model, payload["state_dict"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    meta = payload["meta"]
    state.step = int(meta["step"])
    state.last_mismatched_nll = float(meta["last_mismatched_nll"])
    return meta


class CheckpointManager:
    """One directory per save, ``<directory>/<step>/checkpoint.pt`` (numbered
    directories, as ``tools/supervise_train.py`` looks for them), the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> Path:
        return self.directory / str(step) / "checkpoint.pt"

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.parent.name) for p in self.directory.glob("*/checkpoint.pt")
                      if p.parent.name.isdigit())

    def latest(self) -> Path | None:
        steps = self.all_steps()
        return self.path(steps[-1]) if steps else None

    def save(self, state: TrainState, hp, **meta) -> Path:
        path = save_checkpoint(self.path(state.step), state, hp, **meta)
        for step in self.all_steps()[:-self.max_to_keep]:
            self.path(step).unlink()
            self.path(step).parent.rmdir()
        return path
