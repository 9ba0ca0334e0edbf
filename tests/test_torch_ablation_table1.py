"""The port's Table-1 run and its pieces.

``runs/ablation_table1_torch.json`` is written by ``python -m
lets_face_it_tpu_torch.ablation_table1`` on the card (final_model and the
three ablations, 900 steps each at B=64, precision 16, seed 1234, on the
planted-mimicry fixture). Its claims are those tests/test_ablation_table1.py
pins on the JAX package's record, at the same thresholds: the trick drives
the matched - deranged gap strongly negative at the val optimum, several
times the no-trick model's; it runs away after the optimum; and the
no-trick model's matched val NLL is no worse. The file must be present.

On the CPU: the fixture the module builds in memory equals the JAX package's
HDF5 bit for bit; ``run_config`` at tiny widths validates every config at
the same steps with the trick flag of its YAML file and reads the p2 gap the
loop's validation computed on the first val batch; and the p2 probe equals
the JAX package's on the same weights, batch and permutation.
"""

import json
import math
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lets_face_it_tpu.data.synthetic import write_synthetic_dataset
from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu.train import metrics as jmetrics
from lets_face_it_tpu_torch import ablation_table1
from lets_face_it_tpu_torch import device_cache_scale_probe
from lets_face_it_tpu_torch import trick_gate_probe
from lets_face_it_tpu_torch.data.synthetic import dims_for, make_synthetic_corpus
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.train import derange as pderange
from lets_face_it_tpu_torch.train import loop as ploop
from lets_face_it_tpu_torch.train import metrics as pmetrics

from test_torch_port_common import (ATOL, RTOL, jax_params, port_hp, port_model,
                                    specs, train_hp)

REPO = Path(__file__).resolve().parent.parent
ARTIFACT = REPO / "runs" / "ablation_table1_torch.json"
GAP_KEY = ablation_table1.GAP_KEY


@pytest.fixture(scope="module")
def results():
    assert ARTIFACT.exists(), (
        "runs/ablation_table1_torch.json missing: run python -m "
        "lets_face_it_tpu_torch.ablation_table1 on the card and commit it")
    return json.loads(ARTIFACT.read_text())


def _cfg(results, name):
    return results["configs"][name]


def _yaml_flag(name):
    text = (REPO / "hparams" / f"{name}.yaml").read_text()
    return bool(yaml.safe_load(text)["Train"]["use_negative_nll_loss"])


# ---------------------------------------------------------------------------
# The artifact: the claims of tests/test_ablation_table1.py
# ---------------------------------------------------------------------------

def test_extra_seeds_carry_signed_curves(results):
    """Each extra seed's run keeps its whole curve, validated at the pinned
    run's steps, and its extreme gap with the sign the curve gives it."""
    steps = [r["step"] for r in _cfg(results, "final_model")["curve"]]
    for seed in ("1235", "1236"):
        for name, row in results["extra_seeds"][seed].items():
            assert [r["step"] for r in row["curve"]] == steps, (seed, name)
            assert row["extreme_gap_p2"] == ablation_table1.extreme_gap(row["curve"])
            assert row["best_val"] == min(row["curve"], key=lambda r: r["val_loss"])


def test_artifact_is_a_card_run_at_full_settings(results):
    assert "NVIDIA" in results["device"]
    assert results["power_limit_w"] > 0
    assert results["precision"] == 16 and results["seed"] == 1234
    for name in ablation_table1.ALL_CONFIGS:
        cfg = _cfg(results, name)
        assert cfg["max_steps"] == 900 and cfg["seed"] == 1234
        assert all(cfg["launches"][k] > 0 for k in ablation_table1.TRAINED_KERNELS)
    for seed in ("1235", "1236"):
        assert set(results["extra_seeds"][seed]) == set(ablation_table1.PAIR)


def test_all_four_configs_trained_to_plateau(results):
    for name in ("final_model", "no_speech", "no_face", "no_nll_trick"):
        cfg = _cfg(results, name)
        assert len(cfg["curve"]) >= 5, f"{name}: only {len(cfg['curve'])} vals"
        first, best = cfg["curve"][0]["val_loss"], cfg["best_val"]["val_loss"]
        assert math.isfinite(best) and best < first, (name, first, best)
        # plateau reached: the optimum is strictly before the last validation
        assert cfg["best_val"]["step"] < cfg["curve"][-1]["step"], (
            f"{name}: val loss still improving at the end")


def test_trick_flag_matches_configs(results):
    """The recorded trick flags match the hparams files."""
    expected = {"final_model": True, "no_face": True,
                "no_speech": False, "no_nll_trick": False}
    for name, flag in expected.items():
        assert _yaml_flag(name) is flag
        assert _cfg(results, name)["use_negative_nll_loss"] is flag, name


def test_nll_trick_amplifies_the_interlocutor_gap(results):
    """final_model and no_nll_trick differ only in the trick: the trick's
    gap at the val optimum is strongly negative and several times the
    no-trick model's, at its optimum and at final_model's optimum step."""
    final = _cfg(results, "final_model")
    no_trick = _cfg(results, "no_nll_trick")
    g_final = final["best_val"]["gap_p2"]
    g_no_trick = no_trick["best_val"]["gap_p2"]

    assert g_final < -8.0, (
        f"final_model gap {g_final:+.3f}: the model does not measurably "
        "prefer the matched interlocutor")
    assert abs(g_no_trick) < abs(g_final) / 2.5, (
        f"gap amplification not reproduced at best-val: no_trick "
        f"{g_no_trick:+.3f} vs final {g_final:+.3f}")

    step = final["best_val"]["step"]
    g_nt_at = next(r["gap_p2"] for r in no_trick["curve"] if r["step"] == step)
    assert abs(g_nt_at) < abs(g_final) / 4.0, (
        f"at step {step}: no_trick {g_nt_at:+.3f} vs final {g_final:+.3f}")


def test_trick_produces_the_post_optimum_runaway(results):
    """The trick keeps pushing the gap after the val optimum; the natural
    model's dependence saturates."""
    runaway = {name: max(abs(r["gap_p2"]) for r in _cfg(results, name)["curve"])
               for name in ("final_model", "no_nll_trick")}
    assert runaway["final_model"] > 5.0 * runaway["no_nll_trick"], runaway


def test_trick_costs_no_matched_likelihood(results):
    """Removing the trick does not hurt the matched NLL."""
    best = {name: _cfg(results, name)["best_val"]["val_loss"]
            for name in ("final_model", "no_nll_trick")}
    assert (best["no_nll_trick"]
            <= best["final_model"] + 0.05 * abs(best["final_model"])), best


# ---------------------------------------------------------------------------
# The pieces on the CPU
# ---------------------------------------------------------------------------

def test_fixture_equals_the_jax_hdf5_bit_for_bit(tmp_path):
    """The in-memory corpus of seed 1234 is the JAX tool's fixture."""
    corpus = make_synthetic_corpus(seed=1234)
    path = write_synthetic_dataset(tmp_path / "lets_face_it.h5", seed=1234)
    n = 0
    with h5py.File(path, "r") as f:
        for kind in corpus.means:
            np.testing.assert_array_equal(f[f"/means/{kind}"][()], corpus.means[kind])
            np.testing.assert_array_equal(f[f"/stds/{kind}"][()], corpus.stds[kind])
        for split, chunks in corpus.splits.items():
            assert len(f[split]["prosody"]) == len(chunks)
            for i, chunk in enumerate(chunks):
                for kind, pair in chunk.items():
                    for who, arr in pair.items():
                        stored = f[f"/{split}/{kind}/{i}/{who}"][()]
                        assert stored.dtype == arr.dtype
                        np.testing.assert_array_equal(stored, arr)
                        n += 1
    assert n == 8 * 6 * 2


def _tiny(name):
    """The tiny training config with the trick flag of ``name``'s YAML (the
    ablation pair differs only in the trick)."""
    hp = port_hp(train_hp())
    hp.Train["use_negative_nll_loss"] = _yaml_flag(name)
    return hp


def test_run_config_validates_the_pair_alike_and_reads_the_first_batch_gap(
        monkeypatch):
    """Two configs x 10 steps at tiny widths on the CPU (9 steps an epoch,
    a validation every epoch): both validate at steps 9 and 10, carry their
    YAML's trick flag, and each gap_p2 of the curve is
    ``wrong_context_probes`` recomputed on the first val batch of that
    validation's weights (the loop's permutation seed)."""
    recomputed = {}
    validate = ploop.run_validation

    def recording(spec, hp, model, val_ds, device, step, seed, **kw):
        out = validate(spec, hp, model, val_ds, device, step, seed, **kw)
        sel = next(val_ds.epoch_index_batches(hp.batch_size, shuffle=False))
        batch = ploop.to_device(val_ds.get_batch(sel), device)
        with torch.no_grad():
            _, loss, _ = pseqglow.sequence_nll(spec, model, batch)
            probes = pmetrics.wrong_context_probes(
                spec, model, batch, loss, hp.Mismatch,
                ploop._seeded(seed, step + 1, "cpu"))
        recomputed.setdefault(seed, []).append((step, float(probes[GAP_KEY])))
        return out

    monkeypatch.setattr(ploop, "run_validation", recording)
    corpus = ploop.synthetic_corpus(_tiny("final_model"), ablation_table1.SEED)
    records = {}
    for seed, name in enumerate(ablation_table1.PAIR, start=1):
        records[name], state = ablation_table1.run_config(
            name, max_steps=10, device="cpu", seed=seed, corpus=corpus,
            val_every=1, hp=_tiny(name))
        assert state.step == 10
        rec = records[name]
        assert rec["use_negative_nll_loss"] is _yaml_flag(name)
        assert [(r["step"], r["gap_p2"]) for r in rec["curve"]] == recomputed[seed]
        assert rec["best_val"] == min(rec["curve"], key=lambda r: r["val_loss"])
        assert all(math.isfinite(r["val_loss"]) for r in rec["curve"])
    steps = {name: [r["step"] for r in rec["curve"]] for name, rec in records.items()}
    assert steps == {name: [9, 10] for name in ablation_table1.PAIR}


def test_p2_probe_matches_jax_on_the_same_weights_batch_and_permutation(monkeypatch):
    """The p2 probe on the fixture's first val batch (B=64), JAX weights
    carried into the port, the JAX probe's permutation injected: the base
    and deranged NLLs at the forward's tolerance, the gap at the sum of
    theirs. The flow's leaves are perturbed by 0.3 N(0, 1), so that the
    conditioning moves the NLL by bits: the gap of another permutation
    (the control) lies outside that limit."""
    hp = train_hp()
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=1, scale=0.3)
    model = port_model(params, pspec)
    php = port_hp(hp)
    corpus = make_synthetic_corpus(seed=1234, dims=dims_for(php.Data))
    _, val_ds = ploop.load_datasets(php, corpus)
    batch = next(val_ds.epoch_batches(64, shuffle=False))
    assert batch["p1_face"].shape[0] == 64
    cfg = {"shuffle_batch": {"p2": ["p2_face", "p2_speech"]}}

    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jloss, _ = jseqglow.sequence_nll(spec, params, jb)
    jgap = jmetrics.wrong_context_probes(spec, params, jb, jloss, cfg, key)[GAP_KEY]
    _, sub = jax.random.split(key)              # as wrong_context_probes splits
    k_batch, _ = jax.random.split(sub)          # as derange_batch splits
    perm = torch.as_tensor(np.array(jax.random.permutation(k_batch, 64)))

    derange = pderange.derange_batch
    monkeypatch.setattr(pderange, "derange_batch",
                        lambda b, mods, generator=None, shuffle_time=False:
                        derange(b, mods, perm=perm, shuffle_time=shuffle_time))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        _, loss, _ = pseqglow.sequence_nll(pspec, model, tb)
        gap = pmetrics.wrong_context_probes(pspec, model, tb, loss, cfg,
                                            torch.Generator())[GAP_KEY]
    base, jbase = float(loss), float(jloss)
    mis, jmis = base - float(gap), jbase - float(jgap)
    np.testing.assert_allclose(base, jbase, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(mis, jmis, atol=ATOL, rtol=RTOL)
    limit = 2 * ATOL + RTOL * (abs(jbase) + abs(jmis))
    assert abs(float(gap) - float(jgap)) <= limit, (float(gap), float(jgap), limit)
    control = jmetrics.wrong_context_probes(spec, params, jb, jloss, cfg,
                                            jax.random.PRNGKey(6))[GAP_KEY]
    assert abs(float(gap) - float(control)) > limit, (float(gap), float(control))


@pytest.mark.parametrize("curve, extreme", [
    ([-3.0, 70.1, 48.3], 70.1),
    ([-6.2, -82.8, 50.0], -82.8),
    ([0.0], 0.0),
])
def test_spread_row_keeps_the_signed_extreme_and_the_curve(curve, extreme):
    """An extra seed's row carries the gap of largest size with its sign
    (a size alone would hide a runaway in the wrong direction) and the
    curve it came from."""
    rows = [{"step": 100 * (i + 1), "val_loss": -float(i), "gap_p2": g}
            for i, g in enumerate(curve)]
    record = {"best_val": rows[-1], "curve": rows, "wall_s": 1.0,
              "steps_per_sec": 2.0, "launches": {}, "extreme_gap_p2": extreme}
    assert ablation_table1.extreme_gap(rows) == extreme
    row = ablation_table1.spread_row(record)
    assert row["extreme_gap_p2"] == extreme and row["curve"] == rows
    assert "launches" not in row


def test_precision_32_pair_artifact():
    """``runs/ablation_pair_p32_torch.json``: the pair at precision 32 on the
    card at full settings, seed 1234 and the two extra seeds, each run's
    curve validated at steps 100, ..., 900 and its extreme gap signed as
    its curve gives it (the run that tells rounding from the trajectory's
    own course; read in ROADMAP, pinned here only as a record)."""
    path = REPO / "runs" / "ablation_pair_p32_torch.json"
    assert path.exists(), "runs/ablation_pair_p32_torch.json missing"
    d = json.loads(path.read_text())
    assert "NVIDIA" in d["device"] and d["power_limit_w"] > 0
    assert d["precision"] == 32 and d["seed"] == 1234
    runs = [d["configs"][name] for name in ablation_table1.PAIR]
    runs += [d["extra_seeds"][seed][name] for seed in ("1235", "1236")
             for name in ablation_table1.PAIR]
    for run in runs:
        assert [r["step"] for r in run["curve"]] == list(range(100, 901, 100))
        assert run["extreme_gap_p2"] == ablation_table1.extreme_gap(run["curve"])
        assert all(math.isfinite(r["val_loss"]) for r in run["curve"])
    assert all(d["configs"][name]["precision"] == 32 for name in ablation_table1.PAIR)


def test_precision_32_trains_at_highest():
    """``--precision 32`` sets the run to float32 products throughout."""
    from lets_face_it_tpu_torch.utils.precision import training_precision

    hp = ablation_table1.table1_hparams(port_hp(train_hp()), precision=32)
    assert hp.precision == 32 and training_precision(hp) == "highest"
    assert "highest" in ablation_table1.MATMUL[32]


@pytest.mark.parametrize("module", [ablation_table1, trick_gate_probe,
                                    device_cache_scale_probe])
def test_modules_run_on_the_card_by_default(module, tmp_path):
    """Each entry point asks for the card by default and raises where there
    is none, before any work (it never falls back to the CPU)."""
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        module.main(["--out", str(tmp_path / "out.json")])
    assert not (tmp_path / "out.json").exists()


def test_modules_refuse_the_plain_training_path():
    """A spec outside the training kernels' envelope raises instead of
    training on the plain path."""
    hp = port_hp(train_hp())
    hp.Glow["rnn_type"] = "lstm"
    with pytest.raises(RuntimeError, match="plain path"):
        ablation_table1.run_config("final_model", max_steps=1, device="cpu", hp=hp)


# ---------------------------------------------------------------------------
# The two checks of the open gap claim
# ---------------------------------------------------------------------------

def test_permutations_read_seeded_gaps_beside_the_probe(monkeypatch):
    """``permutations`` P > 1 keeps each validation's gap_p2 (the loop's
    probe, its permutation seeded from the step) and adds P gaps, the i-th
    the p2 probe on the first val batch under the permutation seeded from
    (step, i). That the training is untouched is the card's run's to show
    (``test_permutations_artifact``: its curve equals the committed one)."""
    recomputed = {}
    validate = ploop.run_validation

    def recording(spec, hp, model, val_ds, device, step, seed, **kw):
        out = validate(spec, hp, model, val_ds, device, step, seed, **kw)
        sel = next(val_ds.epoch_index_batches(hp.batch_size, shuffle=False))
        batch = ploop.to_device(val_ds.get_batch(sel), device)
        with torch.no_grad():
            _, loss, _ = pseqglow.sequence_nll(spec, model, batch)
            probe = pmetrics.wrong_context_probes(
                spec, model, batch, loss, hp.Mismatch,
                ploop._seeded(seed, step + 1, "cpu"))[GAP_KEY]
            p2_only = {"shuffle_batch": {"p2": hp.Mismatch["shuffle_batch"]["p2"]}}
            gaps = [pmetrics.wrong_context_probes(
                spec, model, batch, loss, p2_only, ploop._seeded(step, i, "cpu"))[GAP_KEY]
                for i in range(3)]
        recomputed[step] = (float(probe), [float(g) for g in gaps])
        return out

    monkeypatch.setattr(ploop, "run_validation", recording)
    corpus = ploop.synthetic_corpus(_tiny("final_model"), ablation_table1.SEED)
    record, _ = ablation_table1.run_config("final_model", max_steps=9, device="cpu",
                                           corpus=corpus, val_every=1,
                                           hp=_tiny("final_model"), permutations=3)
    assert {r["step"]: (r["gap_p2"], r["gap_p2_perms"]) for r in record["curve"]} \
        == recomputed
    assert list(recomputed) == [9]
    assert all(len(set(g)) == 3 for _, g in recomputed.values())


def test_permutations_artifact(results):
    """``runs/ablation_perms_torch.json``: final_model on seed 1234 rerun on
    the card with eight more permutations a validation; its val_loss and
    gap_p2 curve is the committed run's, bit for bit."""
    path = REPO / "runs" / "ablation_perms_torch.json"
    assert path.exists(), "runs/ablation_perms_torch.json missing"
    d = json.loads(path.read_text())
    assert "NVIDIA" in d["device"] and d["power_limit_w"] > 0
    assert d["permutations"] == 8 and d["seed"] == 1234 and d["precision"] == 16
    curve = d["configs"]["final_model"]["curve"]
    committed = _cfg(results, "final_model")["curve"]
    assert [(r["step"], r["val_loss"], r["gap_p2"]) for r in curve] == \
        [(r["step"], r["val_loss"], r["gap_p2"]) for r in committed]
    for row in curve:
        assert len(row["gap_p2_perms"]) == 8
        assert all(math.isfinite(g) for g in row["gap_p2_perms"])


def test_jax_tool_cpu_artifact():
    """``runs/ablation_table1_jax_cpu.json``: the JAX package's unchanged
    tool (``tools/ablation_table1.py``, which trains seed 1234) on the CPU,
    in its own schema, final_model at least, validated at its steps."""
    path = REPO / "runs" / "ablation_table1_jax_cpu.json"
    assert path.exists(), "runs/ablation_table1_jax_cpu.json missing"
    d = json.loads(path.read_text())
    record = json.loads((REPO / "runs" / "ablation_table1.json").read_text())
    assert set(d) == set(record) and d["device"] == "cpu"
    assert d["fixture"] == record["fixture"] and d["gap_key"] == GAP_KEY
    assert "seed=1234" in (REPO / "tools" / "ablation_table1.py").read_text()
    assert "final_model" in d["configs"]
    for name, cfg in d["configs"].items():
        assert set(cfg) == set(record["configs"][name])
        assert cfg["config"] == name and cfg["max_steps"] == 900
        assert cfg["use_negative_nll_loss"] is _yaml_flag(name)
        assert [r["step"] for r in cfg["curve"]] == list(range(100, 901, 100))
        assert cfg["best_val"] == min(cfg["curve"], key=lambda r: r["val_loss"])
        assert all(math.isfinite(r["val_loss"]) for r in cfg["curve"])
