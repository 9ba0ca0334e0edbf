"""Hyperparameter search harness (the port of
``lets_face_it_tpu/train/tuning.py``: the reference's Optuna machinery,
hparams_tuning.py, without the Optuna dependency).

Kept semantics:
  * the same ``trial.suggest_*`` search-space API, so the search-space
    configs of the root ``hparam_tuning_configs`` registry drive it as they
    are;
  * every trial trains in a ``spawn`` subprocess (never a fork of a process
    that has CUDA up); on an out-of-memory error the batch size is halved
    and the trial retried, failing below 2 (hparams_tuning.py:189-209);
  * pruning: train loss > 0 after 20 steps, generated jerk > 10 at a
    validation, val_loss > 0 (hparams_tuning.py:45-98); early stopping on
    val_loss with patience 2;
  * the study (all trials and the best) as a flock-guarded JSON store that
    several workers share, with constant-liar proposals, resumable.

The hooks follow the port's trainer (``train/loop.py::train``):
``step_hook(step, metrics)`` fires every step with device tensors, and the
pruning hook reads ``metrics["loss"]`` on the host only every tenth step
(the JAX loop's logging cadence), so that a trial keeps the step free of a
per-step host sync. ``val_hook(step, metrics)`` gets the floats of
``run_validation``: the jerk rule reads its generation's
``jerk/generated_jerk`` (a trial turns ``Validation.inference`` on), where
the JAX hook generated a window of min(B, 16) sequences of its own.

Each trial's result carries the kernel launches of its run (``launches``,
by the kernels' names) and its seconds.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import multiprocessing
import os
import random
import time
import traceback
from pathlib import Path

from lets_face_it_tpu_torch.train.samplers import make_sampler

# the pruning hook's cadence: the steps whose loss it reads on the host
PRUNE_EVERY = 10


class TrialPruned(Exception):
    pass


class FailedTrial(Exception):
    pass


class Trial:
    """Optuna-compatible suggest API; values come from the study's sampler."""

    def __init__(self, number: int, sampler):
        self.number = number
        self.sampler = sampler
        self.rng = sampler.rng_for_trial(number)
        self.params: dict = {}
        self.user_attrs: dict = {}

    def _suggest(self, name, kind, **meta):
        value = self.sampler.suggest(self.rng, name, kind, meta)
        self.params[name] = value
        return value

    def suggest_categorical(self, name, choices):
        return self._suggest(name, "categorical", choices=list(choices))

    def suggest_uniform(self, name, low, high):
        return self._suggest(name, "uniform", low=low, high=high)

    def suggest_float(self, name, low, high, *, log=False):
        if log:
            return self.suggest_loguniform(name, low, high)
        return self.suggest_uniform(name, low, high)

    def suggest_loguniform(self, name, low, high):
        return self._suggest(name, "loguniform", low=low, high=high)

    def suggest_int(self, name, low, high):
        return self._suggest(name, "int", low=low, high=high)

    def set_user_attr(self, key, value):
        self.user_attrs[key] = value


def pruning_hooks():
    """(step_hook, val_hook) on the trainer's hook contract."""
    state = {"best": float("inf"), "wait": 0}

    def step_hook(step, metrics):
        if step > 20 and step % PRUNE_EVERY == 0:
            loss = float(metrics["loss"])
            if loss > 0:
                raise TrialPruned(f"loss > 0 at step {step}")

    def val_hook(step, metrics):
        jerk = metrics["jerk/generated_jerk"]
        if jerk > 10 and step > 20:
            raise TrialPruned(f"generated jerk {jerk:.2f} > 10")
        val_loss = metrics["val_loss"]
        if val_loss > 0:
            raise TrialPruned(f"val_loss {val_loss:.2f} > 0")
        if val_loss < state["best"]:
            state["best"] = val_loss
            state["wait"] = 0
        else:
            state["wait"] += 1
            if state["wait"] >= 2:
                raise StopIteration("early stop: patience exceeded")

    return step_hook, val_hook


def is_out_of_memory(exc: BaseException) -> bool:
    """An allocation failure on the card: torch's ``OutOfMemoryError``, or a
    kernel launcher's (``ops/flow_kernels.py::_raise_on``) or torch's
    ``RuntimeError`` that says so."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and "out of memory" in str(exc).lower()


def _launch_counts() -> dict:
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk

    return {"frame_rev": fk.frame_rev_fused, "seq_rev": fk.sequence_rev_fused,
            "sample_gates": fk.sample_gates, "sample_chain": fk.sample_chain,
            "cond_gates": tk.cond_gates, "seq_fwd": tk.seq_fwd,
            "seq_bwd": tk.seq_bwd}


def _run_trial(hp_dict, batch_size, max_steps, seed, return_dict, device="cuda",
               corpus=None):
    """Trial body (a subprocess's, or in-process): train with the pruning
    hooks; the outcome, the kernel launches and the seconds into
    ``return_dict``."""
    wrappers = _launch_counts()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        from lets_face_it_tpu_torch.hparams import HParams
        from lets_face_it_tpu_torch.train.loop import train

        hp = HParams(**hp_dict)
        hp.batch_size = batch_size
        hp.Validation = {**hp.Validation, "inference": True}
        step_hook, val_hook = pruning_hooks()
        _state, best_val = train(hp, seed=seed, log_dir=None, ckpt_dir=None,
                                 max_steps=max_steps, device=device,
                                 corpus=corpus, verbose=True,
                                 step_hook=step_hook, val_hook=val_hook)
        return_dict["val_loss"] = float(best_val)
    except TrialPruned as exc:
        return_dict["pruned"] = str(exc)
    except StopIteration as exc:
        return_dict["early_stop"] = str(exc)
    except Exception as exc:  # noqa: BLE001
        if is_out_of_memory(exc):
            return_dict["OOM"] = True
        else:
            return_dict["error"] = f"{type(exc).__name__}: {exc}"
            return_dict["traceback"] = traceback.format_exc()[-3000:]
    return_dict["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    return_dict["seconds"] = time.perf_counter() - t0


class Study:
    """JSON-file-backed study: trials, best value, resumable, and safe for
    N concurrent worker processes (the reference's Optuna-RDB role,
    config.toml:30-31).

    Every read-modify-write of the store happens under an exclusive
    ``flock`` on a sibling ``.lock`` file, and the JSON is replaced
    atomically (``os.replace`` of a per-process temp file). A worker
    snapshots the store under the lock, samples its proposal outside it
    (other workers' running trials entering the sampler as constant-liar
    pseudo-observations), claims its trial number by appending a
    ``running`` record under the lock, trains, then re-reads and fills in
    its record. Before each proposal it feeds every other worker's completed
    values to its sampler. ``optimize(n_trials=N)`` runs N trials in the
    calling worker: launch K workers for K*N in all.
    """

    def __init__(self, name: str, storage_dir="tuning_studies"):
        self.name = name
        self.path = Path(storage_dir) / f"{name}.json"
        self.trials: list[dict] = []
        self._reload()

    @contextlib.contextmanager
    def _locked(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path.with_suffix(".lock"), "w") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    def _reload(self):
        if self.path.exists():
            self.trials = json.loads(self.path.read_text())["trials"]

    def _save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(f".{self.path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(
            {"name": self.name, "trials": self.trials,
             "best": self.best_trial}, indent=2))
        os.replace(tmp, self.path)

    @property
    def best_trial(self):
        done = [t for t in self.trials if t.get("value") is not None]
        return min(done, key=lambda t: t["value"]) if done else None

    def optimize(self, base_hparams, space_fn, *, n_trials: int,
                 max_steps: int | None = None, seed: int = 0,
                 use_subprocess: bool = True, sampler="tpe", device="cuda",
                 corpus=None, worker: int | None = None):
        """space_fn(hparams, trial) -> hparams (mutated), like the reference's
        ``hparam_options`` modules. ``sampler``: "tpe" (default), "random",
        or a sampler instance. Trials train on ``device`` from ``corpus``
        (a ``data/windows.py::Corpus`` in memory) when given, else from the
        HDF5 store under ``hparams.dataset_root``. ``worker`` tells this
        worker's proposals from another's made at the same trial number
        (default: the process id); give it to repeat a study's proposals."""
        from lets_face_it_tpu_torch.hparams import HParams, validate_hparams

        sampler = make_sampler(sampler, seed)
        worker = os.getpid() if worker is None else int(worker)
        observed: set[int] = set()

        def observe_completed():
            """Feed every completed trial not yet seen (resumed, or run by a
            concurrent worker) into this worker's sampler."""
            for t in self.trials:
                if t.get("value") is not None and t["number"] not in observed:
                    sampler.observe(t["params"], t["value"])
                    observed.add(t["number"])

        for local_idx in range(n_trials):
            with self._locked():
                self._reload()
                observe_completed()
                running_params = [t["params"] for t in self.trials
                                  if t.get("state") == "running"]
                provisional = len(self.trials)

            # Propose outside the lock; other workers' running trials enter
            # as pessimistic pseudo-observations (the worst completed value,
            # Optuna's constant_liar convention), dropped after the proposal.
            history = getattr(sampler, "history", None)
            n_real = len(history) if history is not None else 0
            if history is not None and running_params:
                liar = max((v for _, v in history), default=None)
                if liar is not None:
                    for p in running_params:
                        sampler.observe(p, liar)
            trial = Trial(provisional, sampler)
            trial.rng = random.Random(
                hash((sampler.seed, provisional, worker, local_idx)))
            hp = HParams(**json.loads(json.dumps(base_hparams.to_dict(),
                                                 default=str)))
            hp = space_fn(hp, trial)
            if history is not None:
                del history[n_real:]
            invalid = None
            try:
                validate_hparams(hp)
            except AssertionError as exc:
                invalid = str(exc)

            with self._locked():
                self._reload()
                number = len(self.trials)
                record = {"number": number, "params": trial.params,
                          "value": None, "state": "running",
                          "user_attrs": trial.user_attrs}
                if invalid is not None:
                    record.update(state="invalid", note=invalid)
                self.trials.append(record)
                self._save()
            if invalid is not None:
                continue

            batch_size = hp.batch_size
            while batch_size >= 2:
                result = self._execute(hp, batch_size, max_steps,
                                       seed + number, use_subprocess,
                                       device=device, corpus=corpus)
                if result.get("OOM"):
                    batch_size //= 2
                    continue
                break
            else:
                result = None

            with self._locked():
                self._reload()
                record = next(t for t in self.trials
                              if t["number"] == number)
                if result is None:
                    record.update(state="failed",
                                  note="batch size < 2 after OOM")
                else:
                    record["user_attrs"]["batch_size"] = batch_size
                    for key in ("launches", "seconds"):
                        if key in result:
                            record["user_attrs"][key] = result[key]
                    if "val_loss" in result:
                        record.update(value=result["val_loss"],
                                      state="complete")
                    elif "pruned" in result:
                        record.update(state="pruned", note=result["pruned"])
                    elif "early_stop" in result:
                        record.update(state="complete",
                                      note=result["early_stop"])
                    else:
                        record.update(state="failed",
                                      note=result.get("error", "unknown"),
                                      traceback=result.get("traceback"))
                self._save()
            if result and "val_loss" in result:
                sampler.observe(trial.params, result["val_loss"])
                observed.add(number)
        with self._locked():
            self._reload()
        return self.best_trial

    @staticmethod
    def _execute(hp, batch_size, max_steps, seed, use_subprocess, *,
                 device="cuda", corpus=None) -> dict:
        if use_subprocess:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Manager() as manager:
                ret = manager.dict()
                p = ctx.Process(target=_run_trial,
                                args=(hp.to_dict(), batch_size, max_steps, seed,
                                      ret, str(device), corpus))
                p.start()
                p.join()
                out = dict(ret)
            if p.exitcode != 0 and not out:
                return {"error": f"trial subprocess died (exit {p.exitcode})"}
            return out
        ret: dict = {}
        _run_trial(hp.to_dict(), batch_size, max_steps, seed, ret,
                   str(device), corpus)
        return ret
