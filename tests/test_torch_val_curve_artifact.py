"""The port's rehearsal curve and its extractor.

``runs/long_run_curve_torch.json`` is written on the card by ``python -m
lets_face_it_tpu_torch.long_run`` (final_model at B=256, precision 32, 12
epochs of 2,006 steps, a deliberate SIGTERM in the middle of an epoch and a
resume from the last epoch checkpoint). It must keep the integrity
tests/test_val_curve_artifact.py asks of the JAX record, at this depth, and
end near the JAX record's val NLL at the same step. The file must be
present.

On the CPU: the port's ``parse_log`` keeps the rows the JAX tool keeps, and
its CLI writes the JAX tool's schema with the machine record on top.
"""

import json
import math
import sys
from pathlib import Path

import pytest

from lets_face_it_tpu_torch import extract_val_curve

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import extract_val_curve as jax_extract  # noqa: E402

ARTIFACT = REPO / "runs" / "long_run_curve_torch.json"
RECORD = REPO / "runs" / "long_run_curve.json"
STEPS_PER_EPOCH, EPOCHS = 2006, 12
# the JAX record's val NLL at step 24,072 (runs/long_run_curve.json, longrun_a)
RECORD_VAL_24072 = -22394.56103515625

LOGS = {
    "validation_and_step_rows": [
        json.dumps({"step": 10, "train_loss": -5.0, "nll": -5.0}),
        json.dumps({"step": 20, "val_loss": -6.0, "jerk/gt_jerk": 0.2}),
        json.dumps({"step": 40, "val_loss": -7.5}),
    ],
    "non_json_lines": [
        "WARNING: some startup noise",
        "not json {",
        "{not json either}",
        json.dumps({"step": 20, "val_loss": -6.0}),
        "training done; best val_loss = -6.0",
        json.dumps({"supervisor": "launch", "attempt": 2}),
        json.dumps({"long_run": "validation", "step": 20, "window_s": 1.5}),
    ],
    "truncated_last_line": [
        json.dumps({"step": 2006, "val_loss": -6575.95}),
        json.dumps({"step": 2016, "train_loss": -6600.0}),
        json.dumps({"step": 4012, "val_loss": -8900.1})[:25],
    ],
    "indented_and_empty": [
        "",
        "   " + json.dumps({"step": 1, "val_loss": 1.0}),
        json.dumps({"step": 2, "val_loss": float("nan")}),
    ],
}


@pytest.mark.parametrize("name", sorted(LOGS))
def test_parse_log_keeps_the_jax_tools_rows(name, tmp_path):
    log = tmp_path / "run.log"
    log.write_text("\n".join(LOGS[name]))
    got, want = extract_val_curve.parse_log(log), jax_extract.parse_log(log)
    assert json.dumps(got) == json.dumps(want)
    assert got, name


def test_cli_writes_the_jax_schema_with_the_machine(tmp_path):
    logs = []
    for i, rows in enumerate((LOGS["validation_and_step_rows"],
                              LOGS["truncated_last_line"])):
        logs.append(tmp_path / f"seg{i}.log")
        logs[-1].write_text("\n".join(rows) + "\n")
    out = tmp_path / "curve.json"
    extract_val_curve.main([*map(str, logs), "--out", str(out), "--note", "kill at 30",
                            "--note", "resume from 20", "--device", "cpu"])
    d = json.loads(out.read_text())
    assert d["notes"] == ["kill at 30", "resume from 20"]
    assert [(s["log"], s["n_validations"]) for s in d["segments"]] == [
        ("seg0.log", 2), ("seg1.log", 1)]
    assert d["device"] == "cpu" and d["power_limit_w"] is None and d["host"]
    record = json.loads(RECORD.read_text())
    assert set(record) <= set(d)
    assert set(record["segments"][0]) == set(d["segments"][0])


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = tmp_path / "a.log"
    log.write_text("\n".join(LOGS["validation_and_step_rows"]))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        extract_val_curve.main([str(log), "--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


@pytest.fixture(scope="module")
def curve():
    assert ARTIFACT.exists(), (
        "runs/long_run_curve_torch.json missing: run python -m "
        "lets_face_it_tpu_torch.long_run on the card and commit it")
    return json.loads(ARTIFACT.read_text())


def test_rehearsal_curve_integrity(curve):
    """At least two segments (the run and its resume), a validation at
    every epoch's end to 24,072, val NLL strictly decreasing across the
    kill/resume boundary, the kill and the resume in the notes, from an
    NVIDIA card with its power limit."""
    assert len(curve["segments"]) >= 2
    rows = [r for s in curve["segments"] for r in s["rows"]]
    steps = [r["step"] for r in rows]
    assert steps == [STEPS_PER_EPOCH * n for n in range(1, EPOCHS + 1)]
    vals = [r["val_loss"] for r in rows]
    assert all(math.isfinite(v) for v in vals)
    assert all(b < a for a, b in zip(vals, vals[1:])), \
        "val NLL must decrease monotonically across the resume"
    notes = " ".join(curve["notes"]).lower()
    assert "kill" in notes and "resume" in notes
    assert "NVIDIA" in curve["device"] and curve["power_limit_w"] > 0


def test_rehearsal_killed_mid_epoch_and_resumed_from_an_epoch_checkpoint(curve):
    """The first segment was killed by the parent in the middle of an
    epoch; the next resumed from the last epoch checkpoint before the kill,
    at precision 32, B=256, with steps/s and wall time a segment."""
    first, second = curve["segments_summary"][:2]
    kill = first["killed_at_step"]
    assert kill is not None and kill % STEPS_PER_EPOCH != 0
    assert second["resume_from_step"] == (kill // STEPS_PER_EPOCH) * STEPS_PER_EPOCH
    assert second["last_step"] == STEPS_PER_EPOCH * EPOCHS
    for seg in curve["segments_summary"]:
        assert seg["steps_per_sec"] > 0 and seg["wall_s"] > 0
        assert seg["steps_per_epoch"] == STEPS_PER_EPOCH
    notes = " ".join(curve["notes"])
    assert "precision 32" in notes and "B=256" in notes and "k=8" in notes


def test_rehearsal_ends_near_the_jax_record(curve):
    """The last val NLL within 5 % of the JAX record's at step 24,072."""
    last = curve["segments"][-1]["rows"][-1]
    assert last["step"] == 24072
    record = json.loads(RECORD.read_text())
    want = next(r["val_loss"] for s in record["segments"] for r in s["rows"]
                if r["step"] == 24072)
    assert want == RECORD_VAL_24072
    assert abs(last["val_loss"] - want) <= 0.05 * abs(want), (last["val_loss"], want)
