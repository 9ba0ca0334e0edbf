"""The port's supervisor and the rehearsal's kill and resume, on the CPU.

``supervise_train`` (the counterpart of ``tools/supervise_train.py``) runs
fake children here: scripts that exit with the codes they are given and
record the arguments of each launch. ``long_run``'s parent then runs its
worker at tiny widths with ``--device cpu``, SIGTERMs it in the middle of
an epoch and resumes it under the supervisor; the final checkpoint equals
an uninterrupted run's bit for bit.
"""

import json
import sys
from pathlib import Path

import pytest
import torch
import yaml

from lets_face_it_tpu_torch import extract_val_curve, long_run, supervise_train
from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager
from lets_face_it_tpu_torch.utils.watchdog import STALL_EXIT_CODE

from test_torch_port_common import port_hp, train_hp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import supervise_train as jax_supervise  # noqa: E402

CHILD = """\
import json, sys
from pathlib import Path
state = Path(sys.argv[1])
codes = json.loads(state.read_text())
(state.parent / "argv.jsonl").open("a").write(json.dumps(sys.argv[2:]) + "\\n")
state.write_text(json.dumps(codes[1:]))
sys.exit(codes[0])
"""


def _child(tmp_path, codes):
    """A fake training command that exits with ``codes`` in turn and
    records its arguments."""
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    state = tmp_path / "codes.json"
    state.write_text(json.dumps(codes))
    return [sys.executable, str(script), str(state), "--ckpt_dir", "ck"]


def _launches(tmp_path):
    return [json.loads(line) for line in (tmp_path / "argv.jsonl").read_text().splitlines()]


def _events(capsys):
    return [json.loads(line)["supervisor"] for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"supervisor"')]


def _save(ckpt_dir, step):
    path = CheckpointManager(ckpt_dir).path(step)
    path.parent.mkdir(parents=True)
    torch.save({"meta": {"step": step}}, path)


@pytest.mark.parametrize("committed", [True, False])
def test_stall_then_done_relaunches_once(tmp_path, capsys, committed):
    """Exit 17, then 0: one relaunch, with ``--resume_from`` appended only
    where a checkpoint exists (else a fresh start, said as such)."""
    ckpt = tmp_path / "ck"
    if committed:
        _save(ckpt, 12)
    cmd = _child(tmp_path, [STALL_EXIT_CODE, 0])
    rc = supervise_train.supervise(cmd, ckpt, backoff_s=0.0)
    assert rc == 0
    launches = _launches(tmp_path)
    assert launches[0] == ["--ckpt_dir", "ck"]
    want = ["--ckpt_dir", "ck"] + (["--resume_from", str(ckpt)] if committed else [])
    assert launches[1] == want and len(launches) == 2
    events = _events(capsys)
    assert events == (["launch", "stalled", "launch", "done"] if committed else
                      ["launch", "stalled", "no_checkpoint_yet", "launch", "done"])


def test_resume_from_is_appended_once(tmp_path, capsys):
    ckpt = tmp_path / "ck"
    _save(ckpt, 3)
    cmd = _child(tmp_path, [STALL_EXIT_CODE, STALL_EXIT_CODE, 0])
    assert supervise_train.supervise(cmd, ckpt, backoff_s=0.0) == 0
    launches = _launches(tmp_path)
    assert [a.count("--resume_from") for a in launches] == [0, 1, 1]


def test_an_empty_step_directory_is_not_a_checkpoint(tmp_path):
    """A kill between ``save_checkpoint``'s mkdir and its rename leaves an
    empty numbered directory: the JAX tool's rule counts it, the port's
    does not (the trainer could not restore it)."""
    ckpt = tmp_path / "ck"
    (ckpt / "2006").mkdir(parents=True)
    (ckpt / ".2006.tmp").write_bytes(b"partial")
    assert jax_supervise.has_checkpoint(str(ckpt))
    assert not supervise_train.has_checkpoint(ckpt)
    _save(ckpt, 4012)
    assert supervise_train.has_checkpoint(ckpt)
    assert not supervise_train.has_checkpoint(tmp_path / "missing")


def test_stall_with_only_an_empty_step_directory_starts_afresh(tmp_path):
    ckpt = tmp_path / "ck"
    (ckpt / "2006").mkdir(parents=True)
    cmd = _child(tmp_path, [STALL_EXIT_CODE, 0])
    assert supervise_train.supervise(cmd, ckpt, backoff_s=0.0) == 0
    assert all("--resume_from" not in a for a in _launches(tmp_path))


@pytest.mark.parametrize("retry_crashes, want_rc, want_launches", [(0, 3, 1), (1, 0, 2)])
def test_a_crash_is_retried_only_when_allowed(tmp_path, capsys, retry_crashes, want_rc,
                                              want_launches):
    cmd = _child(tmp_path, [3, 0])
    rc = supervise_train.supervise(cmd, tmp_path / "ck", retry_crashes=retry_crashes,
                                   backoff_s=0.0)
    assert rc == want_rc and len(_launches(tmp_path)) == want_launches
    events = _events(capsys)
    assert events[:2] == ["launch", "crashed"]
    assert events[-1] == ("giving_up" if retry_crashes == 0 else "done")


def test_max_stalls_gives_up(tmp_path):
    cmd = _child(tmp_path, [STALL_EXIT_CODE] * 3)
    rc = supervise_train.supervise(cmd, tmp_path / "ck", max_stalls=1, backoff_s=0.0)
    assert rc == STALL_EXIT_CODE and len(_launches(tmp_path)) == 2


def test_cli_runs_the_command_after_the_separator(tmp_path):
    cmd = _child(tmp_path, [STALL_EXIT_CODE, 0])
    with pytest.raises(SystemExit) as done:
        supervise_train.main(["--ckpt_dir", str(tmp_path / "ck"), "--backoff_s", "0",
                              "--", *cmd])
    assert done.value.code == 0 and len(_launches(tmp_path)) == 2
    with pytest.raises(SystemExit):
        supervise_train.main(["--ckpt_dir", str(tmp_path / "ck")])


# ---------------------------------------------------------------------------
# long_run's parent and worker at tiny widths
# ---------------------------------------------------------------------------

# 2 train chunks of 40 frames: 50 windows of 16, 12 steps of 4 an epoch
# (blocks of 5, 5 and 2, run step by step on the CPU), 2 epochs; the kill
# at the first block's end past step 15, in epoch 2.
TINY = ["--device", "cpu", "--batch_size", "4", "--n_train_chunks", "2",
        "--n_val_chunks", "1", "--frames_per_chunk", "40", "--max_epochs", "2",
        "--steps_per_dispatch", "5", "--log_every", "1"]
EPOCH, KILL_AT, LAST = 12, 15, 24


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run and the killed and resumed one."""
    tmp = tmp_path_factory.mktemp("long_run")
    hp = port_hp(train_hp())
    cfg = tmp / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({k: v for k, v in vars(hp).items()
                                   if k != "config_name"}))
    out = {}
    for name, extra in (("whole", []), ("killed", ["--kill_at_step", str(KILL_AT)])):
        run_dir = tmp / name
        rc = long_run.main(["--run_dir", str(run_dir), "--ckpt_dir", str(run_dir / "ck"),
                            "--out", str(run_dir / "curve.json"), "--hparams", str(cfg),
                            *TINY, *extra])
        assert rc == 0, name
        out[name] = (run_dir, json.loads((run_dir / "curve.json").read_text()))
    return out


def test_long_run_kills_mid_epoch_and_resumes_from_the_epoch_checkpoint(runs):
    _, curve = runs["killed"]
    first, second = curve["segments_summary"]
    assert first["steps_per_epoch"] == EPOCH
    assert first["exit_code"] == -15 and KILL_AT <= first["killed_at_step"] < 2 * EPOCH
    assert first["killed_at_step"] % EPOCH != 0
    assert second["resume_from_step"] == EPOCH and second["exit_code"] == 0
    assert second["last_step"] == LAST
    notes = " ".join(curve["notes"])
    assert "killed DELIBERATELY" in notes and "epoch-1 checkpoint (step 12)" in notes
    assert [(s["log"], [r["step"] for r in s["rows"]]) for s in curve["segments"]] == [
        ("segment_1.log", [EPOCH]), ("segment_2.log", [LAST])]


def test_long_run_resume_equals_the_uninterrupted_run_bit_for_bit(runs):
    (whole_dir, whole), (killed_dir, killed) = runs["whole"], runs["killed"]
    last = [d / "ck" / str(LAST) / "checkpoint.pt" for d in (whole_dir, killed_dir)]
    assert long_run.checkpoint_differences(*last) == []
    rows = whole["segments"][0]["rows"]
    assert [r for r in rows if r["step"] > EPOCH] == killed["segments"][1]["rows"]
    assert [r["step"] for r in rows] == [EPOCH, LAST]


def test_checkpoint_differences_names_what_moved(runs, tmp_path):
    whole_dir, _ = runs["whole"]
    a = whole_dir / "ck" / str(LAST) / "checkpoint.pt"
    payload = torch.load(a, weights_only=True)
    name = next(iter(payload["state_dict"]))
    payload["state_dict"][name] = payload["state_dict"][name] + 1
    payload["meta"]["epoch"] += 1
    b = tmp_path / "b.pt"
    torch.save(payload, b)
    assert long_run.checkpoint_differences(a, b) == [f"state_dict.{name}", "meta"]


def test_long_run_segment_logs_parse_as_the_curve(runs):
    killed_dir, curve = runs["killed"]
    logs = sorted(killed_dir.glob("segment_*.log"))
    again = extract_val_curve.extract(logs, curve["notes"], {})
    assert again["segments"] == curve["segments"]
    events = long_run.read_events(logs[1])
    assert [e["long_run"] for e in events][0] == "start"
    assert [e["long_run"] for e in events][-2:] == ["done", "segment_end"]


def test_long_run_resume_only_continues_a_run_that_ended_early(runs, tmp_path):
    """A run bounded at epoch 1, then ``--resume_only`` to epoch 2 in
    another parent: a second segment from the epoch-1 checkpoint, and the
    final checkpoint of the uninterrupted run."""
    whole_dir, _ = runs["whole"]
    cfg = whole_dir.parent / "tiny.yaml"
    args = ["--run_dir", str(tmp_path), "--ckpt_dir", str(tmp_path / "ck"),
            "--out", str(tmp_path / "curve.json"), "--hparams", str(cfg), *TINY]
    assert long_run.main([*args, "--max_epochs", "1"]) == 0
    assert long_run.main([*args, "--resume_only"]) == 0
    curve = json.loads((tmp_path / "curve.json").read_text())
    assert [(s["resume_from_step"], s["last_step"], s["exit_code"])
            for s in curve["segments_summary"]] == [(0, EPOCH, 0), (EPOCH, LAST, 0)]
    assert long_run.checkpoint_differences(
        whole_dir / "ck" / str(LAST) / "checkpoint.pt",
        tmp_path / "ck" / str(LAST) / "checkpoint.pt") == []


def test_long_run_refuses_a_used_run_dir_and_a_resume_without_one(runs, tmp_path):
    whole_dir, _ = runs["whole"]
    with pytest.raises(SystemExit, match="already holds a run"):
        long_run.main(["--run_dir", str(whole_dir), "--ckpt_dir", str(whole_dir / "ck"),
                       *TINY])
    with pytest.raises(SystemExit, match="--resume_only"):
        long_run.main(["--run_dir", str(tmp_path / "none"), "--resume_only", *TINY])


def test_long_run_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        long_run.main(["--run_dir", str(tmp_path / "r"), "--out", str(tmp_path / "o.json")])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        long_run.main(["--worker", "--ckpt_dir", str(tmp_path / "ck")])
    assert not (tmp_path / "r").exists() and not (tmp_path / "ck").exists()
