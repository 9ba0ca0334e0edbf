"""The port's hyperparameter search (``lets_face_it_tpu_torch/train/tuning.py``,
``train/samplers.py``, ``python -m lets_face_it_tpu_torch.tune``): the JAX
package's tuning tests (tests/test_tuning.py) against the port's module; the
samplers suggesting what the JAX package's do from the same seed and
history; the pruning hooks on the port's trainer contract; out-of-memory
halving with torch's ``OutOfMemoryError``; two workers sharing a study; and
whole trials on the CPU at a tiny size, in process, in a spawned subprocess
and through the CLI.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lets_face_it_tpu.train import samplers as jsamplers
from lets_face_it_tpu.train import tuning as jtuning
from lets_face_it_tpu_torch.train import loop as ploop
from lets_face_it_tpu_torch.train import samplers as psamplers
from lets_face_it_tpu_torch.train.tuning import (PRUNE_EVERY, Study, Trial,
                                                 TrialPruned, is_out_of_memory,
                                                 pruning_hooks)

from conftest import tiny_hparams
from test_torch_port_common import port_hp

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def php():
    hp = port_hp(tiny_hparams())
    hp.dataset_root = "/nonexistent"
    return hp


def _objective(params):
    """Seeded synthetic objective with a numeric optimum at x=0.7,
    lr=1e-3 and a preferred category 'b' (tests/test_tuning.py)."""
    return ((params["x"] - 0.7) ** 2
            + 0.1 * (math.log10(params["lr"]) + 3.0) ** 2
            + (0.0 if params["cat"] == "b" else 0.3)
            + 0.05 * (params["k"] - 12) ** 2 / 64.0)


def _suggest_all(trial):
    return {"x": trial.suggest_uniform("x", 0.0, 1.0),
            "lr": trial.suggest_loguniform("lr", 1e-5, 1e-1),
            "cat": trial.suggest_categorical("cat", ["a", "b", "c"]),
            "k": trial.suggest_int("k", 4, 20)}


def _run_sampler(sampler, n_trials=60):
    best = math.inf
    for number in range(n_trials):
        params = _suggest_all(Trial(number, sampler))
        value = _objective(params)
        sampler.observe(params, value)
        best = min(best, value)
    return best


def test_tpe_beats_random_on_synthetic_objective():
    best_tpe = _run_sampler(psamplers.TPESampler(seed=0))
    best_rand = _run_sampler(psamplers.RandomSampler(seed=0))
    assert best_tpe < best_rand, (best_tpe, best_rand)
    assert best_tpe < 0.02, f"TPE failed to localize the optimum: {best_tpe}"


def test_tpe_beats_random_across_seeds():
    tpe = [_run_sampler(psamplers.TPESampler(seed=s)) for s in range(5)]
    rand = [_run_sampler(psamplers.RandomSampler(seed=s)) for s in range(5)]
    assert sum(t < r for t, r in zip(tpe, rand)) >= 4, list(zip(tpe, rand))
    assert sum(tpe) < sum(rand)


@pytest.mark.parametrize("kind, seed", [("tpe", 0), ("tpe", 7), ("random", 0),
                                        ("random", 7)])
def test_samplers_suggest_what_the_jax_package_does(kind, seed):
    """40 trials, each suggested by both packages' samplers from the same
    seed and the same history, then observed by both: equal values."""
    jax_s, port_s = jsamplers.make_sampler(kind, seed), psamplers.make_sampler(kind, seed)
    for number in range(40):
        want = _suggest_all(jtuning.Trial(number, jax_s))
        got = _suggest_all(Trial(number, port_s))
        assert got == want, number
        jax_s.observe(want, _objective(want))
        port_s.observe(got, _objective(got))


def test_suggest_api_records_params_and_respects_bounds():
    trial = Trial(0, psamplers.RandomSampler(seed=1))
    x = trial.suggest_float("x", 2.0, 3.0)
    lr = trial.suggest_float("lr", 1e-4, 1e-2, log=True)
    k = trial.suggest_int("k", 5, 9)
    c = trial.suggest_categorical("c", ("u", "v"))
    assert 2.0 <= x <= 3.0 and 1e-4 <= lr <= 1e-2
    assert 5 <= k <= 9 and isinstance(k, int) and c in ("u", "v")
    assert set(trial.params) == {"x", "lr", "k", "c"}


def test_tpe_int_suggestions_stay_integral_after_startup():
    sampler = psamplers.TPESampler(seed=2, n_startup=4)
    for number in range(20):
        trial = Trial(number, sampler)
        k = trial.suggest_int("k", 4, 20)
        assert isinstance(k, int) and 4 <= k <= 20
        sampler.observe(trial.params, (k - 12) ** 2)


class _CountingLoss:
    """A device scalar stand-in that counts its reads on the host."""

    def __init__(self, value):
        self.value, self.reads = value, 0

    def __float__(self):
        self.reads += 1
        return self.value


def test_step_hook_reads_the_loss_only_every_tenth_step():
    step_hook, _ = pruning_hooks()
    loss = _CountingLoss(-5.0)
    for step in range(1, 61):
        step_hook(step, {"loss": loss})
    # steps 30, 40, 50, 60: after step 20, on the tenth steps only
    assert loss.reads == 4 and PRUNE_EVERY == 10


@pytest.mark.parametrize("step, loss, pruned", [(20, 1.0, False), (25, 1.0, False),
                                                (30, 1.0, True), (30, -1.0, False)])
def test_step_hook_prunes_a_positive_loss_after_step_20(step, loss, pruned):
    step_hook, _ = pruning_hooks()
    metrics = {"loss": torch.tensor(loss)}
    if pruned:
        with pytest.raises(TrialPruned, match=f"loss > 0 at step {step}"):
            step_hook(step, metrics)
    else:
        step_hook(step, metrics)


def _val(loss, jerk=1.0):
    return {"val_loss": loss, "jerk/generated_jerk": jerk, "jerk/gt_jerk": 1.0}


def test_val_hook_prunes_on_jerk_and_positive_val_loss():
    _, val_hook = pruning_hooks()
    val_hook(10, _val(-5.0, jerk=50.0))      # not after step 20: kept
    with pytest.raises(TrialPruned, match="generated jerk 50.00 > 10"):
        val_hook(30, _val(-5.0, jerk=50.0))
    _, val_hook = pruning_hooks()
    with pytest.raises(TrialPruned, match="val_loss 2.00 > 0"):
        val_hook(30, _val(2.0))


def test_val_hook_stops_early_after_two_validations_without_progress():
    _, val_hook = pruning_hooks()
    val_hook(10, _val(-5.0))
    val_hook(20, _val(-6.0))                 # better: patience restarts
    val_hook(30, _val(-5.5))
    with pytest.raises(StopIteration, match="patience"):
        val_hook(40, _val(-5.9))


def test_out_of_memory_is_recognised():
    assert is_out_of_memory(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert is_out_of_memory(RuntimeError(
        "seq_fwd kernel launch failed: CUDA error 2: out of memory (NVIDIA H100)"))
    assert not is_out_of_memory(RuntimeError("CUDA error 700"))
    assert not is_out_of_memory(ValueError("out of memory"))


def test_study_oom_halving_and_persistence(tmp_path, php, monkeypatch):
    """A trial whose training raises torch's ``OutOfMemoryError`` is retried
    at half the batch until it fits (hparams_tuning.py:189-209); completed
    values feed the sampler and persist to JSON."""
    calls = []

    def fake_train(hp, **kwargs):
        calls.append(hp.batch_size)
        assert hp.Validation["inference"]   # the jerk rule needs the generation
        if hp.batch_size > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
        return None, float(hp.lr)

    monkeypatch.setattr(ploop, "train", fake_train)

    def space(h, trial):
        h.lr = trial.suggest_loguniform("lr", 1e-5, 1e-1)
        return h

    php.batch_size = 8
    study = Study("test_study", storage_dir=tmp_path)
    best = study.optimize(php, space, n_trials=3, seed=0, use_subprocess=False,
                          sampler="tpe", device="cpu")
    assert calls[:3] == [8, 4, 2]
    assert best is not None and best["value"] > 0
    assert all(t["user_attrs"]["batch_size"] == 2 for t in study.trials)
    assert all(set(t["user_attrs"]["launches"]) >= {"seq_fwd", "seq_bwd"}
               for t in study.trials)
    study2 = Study("test_study", storage_dir=tmp_path)
    assert len(study2.trials) == 3
    assert study2.best_trial["number"] == best["number"]


def test_study_fails_a_trial_that_never_fits(tmp_path, php, monkeypatch):
    def fake_train(hp, **kwargs):
        raise RuntimeError("cond_gates kernel launch failed: CUDA error 2: out of memory")

    monkeypatch.setattr(ploop, "train", fake_train)
    php.batch_size = 4
    study = Study("never", storage_dir=tmp_path)
    study.optimize(php, lambda h, trial: h, n_trials=1, use_subprocess=False,
                   device="cpu")
    assert study.trials[0]["state"] == "failed"
    assert study.trials[0]["note"] == "batch size < 2 after OOM"


def test_constant_liar_feeds_running_trials(tmp_path, php, monkeypatch):
    """While proposing, other workers' running trials enter the sampler as
    pessimistic pseudo-observations, dropped again after the proposal."""
    seen_hist = []
    monkeypatch.setattr(Study, "_execute",
                        staticmethod(lambda *a, **k: {"val_loss": 1.0}))
    study = Study("liar", storage_dir=tmp_path)
    study.trials = [
        {"number": 0, "params": {"lr": 0.5}, "value": 2.0,
         "state": "complete", "user_attrs": {}},
        {"number": 1, "params": {"lr": 0.9}, "value": None,
         "state": "running", "user_attrs": {}},
    ]
    study._save()
    sampler = psamplers.TPESampler(seed=0)

    def space(h, trial):
        seen_hist.append([v for _, v in trial.sampler.history])
        h.lr = trial.suggest_uniform("lr", 0.0, 1.0)
        return h

    study.optimize(php, space, n_trials=1, seed=0, use_subprocess=False,
                   sampler=sampler)
    assert seen_hist == [[2.0, 2.0]]
    assert [v for _, v in sampler.history] == [2.0, 1.0]


def test_a_given_worker_repeats_its_proposals(tmp_path, php, monkeypatch):
    monkeypatch.setattr(Study, "_execute",
                        staticmethod(lambda hp, *a, **k: {"val_loss": hp.lr}))

    def space(h, trial):
        h.lr = trial.suggest_loguniform("lr", 1e-5, 1e-1)
        return h

    runs = []
    for name in ("a", "b"):
        study = Study(name, storage_dir=tmp_path)
        study.optimize(php, space, n_trials=3, seed=4, use_subprocess=False,
                       worker=0)
        runs.append([t["params"] for t in study.trials])
    assert runs[0] == runs[1]


def test_concurrent_workers_share_study(tmp_path, php):
    """Two worker processes drive the same flock-guarded JSON study: trial
    numbers stay unique, no record is lost, both workers' values land."""
    hp_file = tmp_path / "hp.json"
    hp_file.write_text(json.dumps(php.to_dict(), default=str))
    script = f"""
import json, sys, time
sys.path.insert(0, {str(REPO)!r})
from lets_face_it_tpu_torch.hparams import HParams
from lets_face_it_tpu_torch.train.tuning import Study

idx = int(sys.argv[1])

def fake_execute(hp, batch_size, max_steps, seed, use_subprocess, **kwargs):
    time.sleep(0.1)   # force interleaving between the two workers
    return {{"val_loss": float((hp.lr - 0.003) ** 2)}}

Study._execute = staticmethod(fake_execute)

def space(h, trial):
    h.lr = trial.suggest_uniform("lr", 0.0, 0.01)
    return h

hp = HParams(**json.loads(open({str(hp_file)!r}).read()))
Study("cstudy", {str(tmp_path)!r}).optimize(
    hp, space, n_trials=3, seed=1009 * idx, use_subprocess=False, sampler="tpe")
"""
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)])
             for i in (0, 1)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    study = Study("cstudy", tmp_path)
    assert len(study.trials) == 6
    assert sorted(t["number"] for t in study.trials) == list(range(6))
    assert all(t["state"] == "complete" for t in study.trials)
    assert all(0.0 <= t["params"]["lr"] <= 0.01 for t in study.trials)


def _tiny_space(h, trial):
    """A space at the tiny widths the CPU trains quickly."""
    h.lr = trial.suggest_loguniform("lr", 1e-4, 1e-3)
    h.Train["use_negative_nll_loss"] = trial.suggest_categorical(
        "use_negative_nll_loss", [True, False])
    return h


def _tiny_corpus(php):
    return ploop.synthetic_corpus(php, 0, frames_per_chunk=40)


@pytest.mark.parametrize("use_subprocess", [False, True])
def test_a_whole_trial_on_the_cpu(tmp_path, php, use_subprocess):
    """Trials train the tiny model on the CPU from an in-memory corpus, in
    process and in a spawned subprocess, validate with a generation (the
    jerk rule's input) and end complete, pruned or early-stopped."""
    study = Study("cpu", storage_dir=tmp_path)
    study.optimize(php, _tiny_space, n_trials=1, max_steps=4, seed=1,
                   use_subprocess=use_subprocess, device="cpu",
                   corpus=_tiny_corpus(php))
    (trial,) = study.trials
    assert trial["state"] in ("complete", "pruned"), trial
    assert trial["state"] != "complete" or np.isfinite(trial["value"])
    assert trial["user_attrs"]["seconds"] > 0
    assert set(trial["user_attrs"]["launches"]) == {
        "frame_rev", "seq_rev", "sample_gates", "sample_chain", "cond_gates",
        "seq_fwd", "seq_bwd"}


def test_tune_cli_on_the_cpu(tmp_path, php, monkeypatch, capsys):
    """``python -m lets_face_it_tpu_torch.tune`` with a space registered
    for the config's stem writes the study JSON."""
    import types

    import hparam_tuning_configs
    import yaml

    from lets_face_it_tpu_torch import tune

    cfg = {k: v for k, v in php.to_dict().items() if k != "config_name"}
    (tmp_path / "tiny_tune.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.setitem(hparam_tuning_configs.hparam_configs, "tiny_tune",
                        types.SimpleNamespace(hparam_options=_tiny_space))
    tune.main([str(tmp_path / "tiny_tune.yaml"), "-n", "2", "--max_steps", "2",
               "--synthetic-data", "--device", "cpu", "--no-subprocess",
               "--study_dir", str(tmp_path / "studies")])
    out = capsys.readouterr().out
    assert "finished trials: 2" in out
    stored = json.loads((tmp_path / "studies" / "tiny_tune.json").read_text())
    assert [t["number"] for t in stored["trials"]] == [0, 1]
    assert all(t["state"] in ("complete", "pruned") for t in stored["trials"])
