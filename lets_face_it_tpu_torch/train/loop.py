"""The training harness: epochs, validation self-checks, JSON metric lines,
checkpoints (the port of ``lets_face_it_tpu/train/loop.py``).

Each epoch shuffles the training windows with ``np.random.default_rng([seed,
epoch])``, so a resumed run consumes the data in the order the uninterrupted
run would; the first batch of a fresh run initialises ActNorm. Validation,
each ``check_val_every_n_epoch`` epochs and at the end, reproduces the
reference's self-checks (mimicry_logger.py): the val NLL, free-run generation
of the first val batch with the jerk triplet (``sequence_sample``, the
``seq_rev`` kernel), and the wrong-context probes (``sequence_nll`` on
deranged batches, the ``seq_fwd`` kernel). Then a checkpoint is written.
Validation draws from generators of its own, seeded from (seed, step), so it
never moves the training trajectory.

Left out, as in ``ROADMAP.md``: TensorBoard and Comet logging (metrics go to
stdout as JSON lines), the render client, the invertibility check (needs
``sequence_invert``), the device data cache, k steps per dispatch and the
stall watchdog.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.data.synthetic import dims_for, make_synthetic_corpus
from lets_face_it_tpu_torch.data.windows import WindowDataset
from lets_face_it_tpu_torch.hparams import HParams
from lets_face_it_tpu_torch.model import seqglow
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.train import metrics as train_metrics
from lets_face_it_tpu_torch.train import state as train_state
from lets_face_it_tpu_torch.train.checkpoint import (CheckpointManager,
                                                     restore_checkpoint)
from lets_face_it_tpu_torch.utils.device import resolve_device


def log_json(step: int, values: dict) -> None:
    """One JSON metrics line on stdout."""
    clean = {k: float(v) for k, v in values.items()}
    print(json.dumps({"step": step, **clean}), file=sys.stdout, flush=True)


def load_datasets(hp: HParams, corpus=None):
    """(train, val) window datasets: from ``corpus`` in memory when given,
    else from the HDF5 store ``dataset_root/Data.file_name``."""
    args = (hp.Data, hp.Conditioning)
    if corpus is not None:
        return (WindowDataset.from_chunks(corpus, "train", *args, hp.Train["seq_len"]),
                WindowDataset.from_chunks(corpus, "val", *args,
                                          hp.Validation["seq_len"]))
    data_file = Path(hp.dataset_root) / hp.Data["file_name"]
    return (WindowDataset.from_file(data_file, "train", *args, hp.Train["seq_len"]),
            WindowDataset.from_file(data_file, "val", *args, hp.Validation["seq_len"]))


def synthetic_corpus(hp: HParams, seed: int, **kwargs):
    """The synthetic corpus at the dims ``hp`` reads (``data/synthetic.py``)."""
    return make_synthetic_corpus(seed=seed, dims=dims_for(hp.Data), **kwargs)


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _seeded(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % 2**63)


@torch.no_grad()
def run_validation(spec: FlowSpec, hp: HParams, model: SeqGlow,
                   val_ds: WindowDataset, device, step: int, seed: int) -> dict:
    """Val NLL over the whole split (batches in order, the last one ragged),
    then on its first batch: generation and jerk, and the wrong-context
    probes. Returns the metrics (floats)."""
    val_cfg = hp.Validation
    total, n_batches, first = 0.0, 0, None
    for b in val_ds.epoch_batches(hp.batch_size, shuffle=False):
        jb = to_device(b, device)
        _, loss, _ = seqglow.sequence_nll(spec, model, jb)
        total += float(loss)
        n_batches += 1
        if first is None:
            first = (jb, loss)
    out = {"val_loss": total / max(n_batches, 1)}
    if first is None:
        return out
    jb, loss = first
    start, seq_len = spec.cond.longest_history, val_cfg["seq_len"]
    if val_cfg.get("inference", False):
        generated = seqglow.sequence_sample(
            spec, model, jb, seq_len, eps_std=float(hp.Infer["eps"]),
            generator=_seeded(seed, step, device))
        gt = jb["p1_face"][:, start:seq_len]
        out.update({k: float(v) for k, v in
                    train_metrics.jerk_metrics(gt, generated).items()})
    if val_cfg.get("wrong_context_test", False) and hasattr(hp, "Mismatch"):
        probes = train_metrics.wrong_context_probes(
            spec, model, jb, loss, hp.Mismatch, _seeded(seed, step + 1, "cpu"))
        out.update({k: float(v) for k, v in probes.items()})
    return out


def train(hp: HParams, *, seed: int = 1234, ckpt_dir=None,
          max_steps: int | None = None, device="cuda", corpus=None,
          resume_from=None, log_every: int = 10, verbose: bool = True,
          step_hook=None, val_hook=None):
    """Full training run on ``device``. The data come from ``corpus`` (in
    memory) when given, else from the HDF5 store under ``hp.dataset_root``.
    ``resume_from``: a checkpoint file, or a directory whose newest
    checkpoint is taken. ``step_hook(step, metrics)`` fires after every
    step and ``val_hook(step, metrics)`` after each validation. Returns
    (final TrainState, best val loss)."""
    device = resolve_device(device)
    train_ds, val_ds = load_datasets(hp, corpus)
    spec = FlowSpec.build(hp)
    steps_per_epoch = max(train_ds.num_batches(hp.batch_size, drop_last=True), 1)
    model = SeqGlow.init(spec, torch.Generator().manual_seed(seed)).to(device)
    state = train_state.TrainState.create(model, hp, steps_per_epoch, seed)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None

    actnorm_inited, start_epoch, skip = False, 0, 0
    if resume_from:
        path = Path(resume_from)
        if path.is_dir():
            path = CheckpointManager(path).latest()
            if path is None:
                raise FileNotFoundError(f"no checkpoint under {resume_from}")
        meta = restore_checkpoint(path, state)
        actnorm_inited = bool(meta["actnorm_inited"])
        start_epoch, skip = int(meta["epoch"]), int(meta["epoch_step"])
        if skip >= steps_per_epoch:
            start_epoch, skip = start_epoch + 1, 0

    best_val = float("inf")
    max_epochs = int(hp.max_epochs or 1)
    val_every = int(getattr(hp, "check_val_every_n_epoch", 1) or 1)
    start_step, t_start = state.step, time.perf_counter()
    done = max_steps is not None and state.step >= max_steps
    for epoch in range(start_epoch, max_epochs):
        if done:
            break
        np_rng = np.random.default_rng([seed, epoch])
        sels = list(train_ds.epoch_index_batches(hp.batch_size, rng=np_rng,
                                                 shuffle=True, drop_last=True))
        epoch_step = skip
        for sel in sels[skip:]:
            jb = to_device(train_ds.get_batch(sel), device)
            if not actnorm_inited:
                train_state.run_actnorm_init(spec, state, jb)
                actnorm_inited = True
            m = train_state.train_step(spec, hp, state, jb)
            epoch_step += 1
            done = max_steps is not None and state.step >= max_steps
            if step_hook is not None:
                step_hook(state.step, m)
            if verbose and (state.step % log_every == 0 or done):
                m = {k: float(v) for k, v in m.items()}
                m["train_loss"] = m.pop("loss")
                m["steps_per_sec"] = ((state.step - start_step)
                                      / (time.perf_counter() - t_start))
                log_json(state.step, m)
            if done:
                break
        skip = 0
        if (epoch + 1) % val_every == 0 or done:
            out = run_validation(spec, hp, state.model, val_ds, device,
                                 state.step, seed)
            best_val = min(best_val, out["val_loss"])
            if verbose:
                log_json(state.step, out)
            if val_hook is not None:
                val_hook(state.step, out)
            if ckpt is not None:
                ckpt.save(state, hp, epoch=epoch, epoch_step=epoch_step,
                          actnorm_inited=actnorm_inited,
                          val_loss=out["val_loss"])
    return state, best_val
