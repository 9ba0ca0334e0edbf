"""The negative-NLL trick's gate on the port, and the port's gate probe run.

A step takes the deranged branch iff its coin < 0.1 and
``last_mismatched_nll > 0``; a fired step sets ``last_mismatched_nll`` to
-(its NLL) and scales its loss by -0.1 (reference lets_face_it_glow.py:38-53).
The invariants tests/test_trick_gate.py pins on the JAX step, here on the
port's ``train_step`` and on ``MultiStep`` at k=5 (CPU), with the coins
injected so that whether a step fires depends on the gate alone: a closed
gate never fires and stays closed; an open gate fires on a low coin, each
fired step rewrites the gate variable to -nll and carries the -0.1 factor,
no other step touches either; on random noise the untrained model's NLL is
positive, so the first fire closes the gate for good.

``runs/trick_gate_probe_torch.json`` (``python -m
lets_face_it_tpu_torch.trick_gate_probe``, 900 steps on the card) is held to
the JAX test's conclusions: the gate open on every step, every deranged NLL
negative, about a tenth of the steps fired, and a post-optimum val
regression of more than 1,000 bits.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.train import state as pstate

from conftest import random_batch
from test_torch_port_common import port_hp, train_hp

ARTIFACT = Path(__file__).resolve().parent.parent / "runs" / "trick_gate_probe_torch.json"
N_STEPS, B = 20, 4
# a low coin every fourth step from the second: the gate alone decides
COINS = [0.05 if i % 4 == 1 else 0.5 for i in range(N_STEPS)]


@pytest.fixture
def coins(monkeypatch):
    """Every step's coin from COINS, whichever path draws it; the
    permutation and the dropout masks from the state's generator."""
    it = iter(COINS)
    draw = pstate.draw_step
    monkeypatch.setattr(pstate, "draw_step", lambda *a, **kw:
                        dataclasses.replace(draw(*a, **kw), coin=next(it)))


def _run(last, k):
    """N_STEPS steps on one random-noise batch from a fresh tiny model with
    the gate variable at ``last``: one ``train_step`` at a time (k=1), or
    ``MultiStep`` blocks of k over the batch's windows laid end to end. ->
    (per-step {deranged, nll, loss}, the gate variable after each step
    (k=1) or block, as (steps done, value))."""
    hp = port_hp(train_hp())
    assert hp.Train["use_negative_nll_loss"]
    spec = FlowSpec.build(hp)
    state = pstate.TrainState.create(SeqGlow.init(spec, torch.Generator().manual_seed(0)),
                                     hp, 10, seed=0)
    state.last_mismatched_nll = last
    batch = {name: torch.as_tensor(v) for name, v in random_batch(train_hp(), B).items()}
    rows, lasts = [], []
    if k == 1:
        for _ in range(N_STEPS):
            m = pstate.train_step(spec, hp, state, batch)
            rows.append({key: float(m[key]) for key in ("deranged", "nll", "loss")})
            lasts.append((state.step, float(state.last_mismatched_nll)))
        return rows, lasts
    seq_len = batch["p1_face"].shape[1]
    arrays = {name: v.reshape(-1, v.shape[-1]) for name, v in batch.items()}
    starts = (torch.arange(B, dtype=torch.int32) * seq_len).repeat(k, 1)
    multi = pstate.MultiStep(spec, hp, state, arrays, seq_len, B, k)
    for _ in range(N_STEPS // k):
        m = multi(starts)
        rows += [{key: float(m[key][i]) for key in ("deranged", "nll", "loss")}
                 for i in range(k)]
        lasts.append((state.step, float(state.last_mismatched_nll)))
    return rows, lasts


@pytest.mark.parametrize("k", [1, 5])
def test_closed_gate_never_fires_and_stays_closed(coins, k):
    """last_mismatched_nll <= 0 blocks the deranged branch whatever the
    coin, and only a fired step could rewrite it."""
    rows, lasts = _run(-1.0, k)
    assert all(r["deranged"] == 0.0 for r in rows)
    assert all(r["loss"] == r["nll"] for r in rows)
    assert all(value == -1.0 for _, value in lasts)


@pytest.mark.parametrize("k", [1, 5])
def test_open_gate_fires_on_a_low_coin_and_updates_last(coins, k):
    """With the gate open (+inf, the reference's unset state), the first low
    coin fires; the fired step sets the gate variable to -nll and its loss
    to -0.1 nll; no other step touches either. On random noise NLL > 0, so
    that fire closes the gate: no later low coin fires."""
    rows, lasts = _run(math.inf, k)
    fired = [i for i, r in enumerate(rows) if r["deranged"] == 1.0]
    assert fired == [1]
    nll = rows[1]["nll"]
    assert nll > 0
    np.testing.assert_allclose(rows[1]["loss"], -0.1 * nll, rtol=1e-6)
    assert all(r["loss"] == r["nll"] for i, r in enumerate(rows) if i != 1)
    for done, value in lasts:
        if done <= 1:
            assert value == math.inf
        else:
            np.testing.assert_allclose(value, -nll, rtol=1e-6)
    assert lasts[-1][1] <= 0


@pytest.mark.parametrize("k", [1, 5])
def test_gate_open_iff_deranged_nll_was_negative(coins, k):
    """After a fired step the gate is open iff that deranged NLL was
    negative; here, from a positive gate value, the fired step's NLL decides
    it."""
    rows, lasts = _run(math.inf, k)
    i = next(i for i, r in enumerate(rows) if r["deranged"] == 1.0)
    after = next(value for done, value in lasts if done > i)
    assert (after > 0) == (rows[i]["nll"] < 0)


def test_gate_probe_records_each_step_against_its_coin_and_gate(coins):
    """The probe's step loop at tiny widths on the fixture, the coins
    injected: each row's coin is the one the step took, and a step fired iff
    its coin was low and the gate variable read after the step before was
    positive (the device's select against the host's reading)."""
    from lets_face_it_tpu_torch import trick_gate_probe
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus

    hp = port_hp(train_hp())
    corpus = synthetic_corpus(hp, 1234)
    rows, validations, state = trick_gate_probe.gate_steps(
        max_steps=N_STEPS, device="cpu", corpus=corpus, val_every=10,
        hp=port_hp(train_hp()))
    assert [r["coin"] for r in rows] == COINS
    assert [r["deranged"] == 1.0 for r in rows] == [
        r["coin"] < 0.1 and r["gate_open"] for r in rows]
    assert any(r["deranged"] == 1.0 for r in rows)
    assert rows[0]["gate_open"] and [v["step"] for v in validations] == [10, 20]
    summary, windows = trick_gate_probe.summarize(rows, validations)
    assert summary["fired_steps"] == sum(r["deranged"] == 1.0 for r in rows)


def test_gate_probe_torch_artifact_integrity():
    """The 900-step run on the card tells the story the JAX record tells:
    gate open on every step, every deranged NLL negative, about 10 % fired,
    a regression of more than 1,000 bits after the val optimum."""
    assert ARTIFACT.exists(), (
        "runs/trick_gate_probe_torch.json missing: run python -m "
        "lets_face_it_tpu_torch.trick_gate_probe on the card and commit it")
    d = json.loads(ARTIFACT.read_text())
    assert "NVIDIA" in d["device"] and d["power_limit_w"] > 0
    s = d["summary"]
    assert s["total_steps"] >= 900
    assert not s["gate_ever_closed"]
    assert not s["any_deranged_nll_nonnegative"]
    assert s["deranged_nll_range"][1] < 0
    assert 0.05 <= s["fire_rate"] <= 0.15
    assert all(w["gate_open_frac"] == 1.0 for w in d["windows"])
    assert s["post_optimum_regression_nats"] > 1000
    # the collapse is post-optimum: best val strictly precedes the end
    assert s["best_val"]["step"] < s["final_val"]["step"]
    assert s["final_val"]["val_loss"] > s["best_val"]["val_loss"]
