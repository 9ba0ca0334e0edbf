"""The rest of the port's trainer on the CPU: the stall watchdog (the cases of
tests/test_watchdog.py) and the loop's heartbeats and its stop on an
exception, the checkpoints' layout for tools/supervise_train.py, the metric
logger, the parameter histograms against the JAX package's, the render
client against the JAX package's payload and against a stub render service
over HTTP, ``run_validation`` with ``check_invertion``, ``scale_logging``
and ``render`` on, the config file, and the trainer CLI's new flags."""

import json
import math
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from lets_face_it_tpu import config as jconfig
from lets_face_it_tpu.render.server import byteify as jbyteify
from lets_face_it_tpu.render.server import debyteify, make_handler
from lets_face_it_tpu.train import loop as jloop
from lets_face_it_tpu.train.render_client import RenderClient as JaxRenderClient
from lets_face_it_tpu_torch import config as pconfig
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.train import __main__ as train_cli
from lets_face_it_tpu_torch.train import loop as ploop
from lets_face_it_tpu_torch.train import metrics as pmetrics
from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager
from lets_face_it_tpu_torch.train.render_client import RenderClient, byteify
from lets_face_it_tpu_torch.utils import watchdog as pwatchdog
from lets_face_it_tpu_torch.utils.watchdog import STALL_EXIT_CODE, ProgressWatchdog

from test_torch_port_common import (jax_params, port_hp, port_model, specs,
                                    train_hp)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from supervise_train import has_checkpoint  # noqa: E402


def _wait_for(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------

def test_watchdog_fires_on_stall_after_arming():
    calls = []
    wd = ProgressWatchdog(0.2, on_stall=lambda idle, name: calls.append(idle),
                          poll_s=0.05)
    wd.beat()
    assert _wait_for(lambda: wd.fired)
    assert calls and calls[0] > 0.2


def test_watchdog_unarmed_until_first_beat():
    calls = []
    wd = ProgressWatchdog(0.1, on_stall=lambda *a: calls.append(a), poll_s=0.03)
    time.sleep(0.5)                     # well past timeout_s, but no beat yet
    assert not wd.fired and not calls
    wd.stop()


def test_watchdog_beats_keep_it_alive_and_stop_disarms():
    calls = []
    wd = ProgressWatchdog(1.5, on_stall=lambda *a: calls.append(a), poll_s=0.05)
    for _ in range(6):
        wd.beat()
        time.sleep(0.1)                 # always inside the timeout
    assert not wd.fired
    wd.stop()
    time.sleep(2.0)                     # stopped: a stall no longer fires
    assert not wd.fired and not calls


@pytest.mark.parametrize("timeout_s", [0.0, -1.0])
def test_watchdog_rejects_nonpositive_timeout(timeout_s):
    with pytest.raises(ValueError):
        ProgressWatchdog(timeout_s)


def test_watchdog_exit_code_is_the_supervisors():
    from lets_face_it_tpu.utils.watchdog import STALL_EXIT_CODE as JAX_CODE

    assert STALL_EXIT_CODE == JAX_CODE == 17


def test_watchdog_default_exits_17_in_a_child():
    """The default callback hard-exits with the stall code."""
    script = (f"import sys, time; sys.path.insert(0, {str(REPO)!r})\n"
              "from lets_face_it_tpu_torch.utils.watchdog import ProgressWatchdog\n"
              "wd = ProgressWatchdog(0.2, poll_s=0.05)\n"
              "wd.beat()\n"
              "time.sleep(30)\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == STALL_EXIT_CODE, out.stderr
    assert "no progress" in out.stderr


def _tiny_run_hp(**kw):
    hp = port_hp(train_hp())
    hp.batch_size = 8
    hp.max_epochs = 1
    hp.logger = False
    for k, v in kw.items():
        setattr(hp, k, v)
    return hp


def _corpus(hp, seed=1):
    return ploop.synthetic_corpus(hp, seed, n_train_chunks=2, n_val_chunks=1,
                                  n_test_chunks=1, frames_per_chunk=40)


def test_train_loop_beats_and_stops_watchdog(monkeypatch):
    """With ``stall_timeout_s`` the loop beats after every step and after
    validation, and stops the watchdog at the end."""
    made = []

    class Recording(ProgressWatchdog):
        def __init__(self, timeout_s, **kw):
            super().__init__(timeout_s, **kw)
            self.beats, self.stopped = 0, False
            made.append(self)

        def beat(self):
            self.beats += 1
            super().beat()

        def stop(self):
            self.stopped = True
            super().stop()

    monkeypatch.setattr(pwatchdog, "ProgressWatchdog", Recording)
    hp = _tiny_run_hp(stall_timeout_s=600.0)
    _, best = ploop.train(hp, seed=1, max_steps=3, device="cpu",
                          corpus=_corpus(hp), verbose=False)
    assert best < float("inf")
    assert len(made) == 1 and made[0].timeout_s == 600.0
    assert made[0].beats == 3 + 1 and made[0].stopped and not made[0].fired


def test_train_loop_stops_watchdog_on_exception(tmp_path):
    """An exception out of ``train`` (a raising val_hook, as a pruning hook
    raises) disarms the watchdog on the way out; a leaked armed watchdog
    would os._exit(17) the process later. Run in a child so that a
    regression kills the child, not the suite."""
    script = tmp_path / "scenario.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / 'tests')!r})
from test_torch_port_common import port_hp, train_hp
from lets_face_it_tpu_torch.train import loop
from lets_face_it_tpu_torch.utils import watchdog

made = []

class Recorded(watchdog.ProgressWatchdog):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        made.append(self)

watchdog.ProgressWatchdog = Recorded
hp = port_hp(train_hp())
hp.batch_size, hp.max_epochs, hp.logger, hp.stall_timeout_s = 8, 1, False, 600.0
corpus = loop.synthetic_corpus(hp, 1, n_train_chunks=2, n_val_chunks=1,
                               n_test_chunks=1, frames_per_chunk=40)

def boom(step, metrics):
    raise RuntimeError("pruned")

try:
    loop.train(hp, seed=1, max_steps=2, device="cpu", corpus=corpus,
               verbose=False, val_hook=boom)
except RuntimeError:
    pass
else:
    sys.exit(2)
for wd in made:
    wd._thread.join(timeout=20)
if len(made) != 1 or made[0]._thread.is_alive() or made[0].fired:
    sys.exit(3)
print("stopped", len(made))
""")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr[-2000:])
    assert "stopped 1" in r.stdout


# ---------------------------------------------------------------------------
# Logging
# ---------------------------------------------------------------------------

def test_metric_logger_json_lines_and_tensorboard(tmp_path, capsys):
    logger = ploop.MetricLogger(tmp_path / "tb")
    logger.scalars(5, {"a": torch.tensor(1.5), "b": 2})
    logger.histogram(5, "h", np.arange(6.0).reshape(2, 3))
    logger.video_url(5, "http://host/video/v.mp4")
    logger.close()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == {"step": 5, "a": 1.5, "b": 2.0}
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_metric_logger_without_tensorboard_warns_and_prints(tmp_path, monkeypatch,
                                                            capsys):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    logger = ploop.MetricLogger(tmp_path / "tb")
    assert logger.writer is None
    logger.scalars(1, {"x": 3.0})
    logger.histogram(1, "h", np.zeros(3))
    out = capsys.readouterr()
    assert "TensorBoard logging disabled" in out.err
    assert json.loads(out.out.strip()) == {"step": 1, "x": 3.0}
    off = ploop.MetricLogger(tmp_path / "off", enabled=False)
    assert off.writer is None and not (tmp_path / "off").exists()


def test_scale_histograms_match_jax():
    hp = train_hp()
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=3)
    want = jloop.scale_histograms(params)
    got = ploop.scale_histograms(port_model(params, pspec))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=1e-6)


# ---------------------------------------------------------------------------
# Render client
# ---------------------------------------------------------------------------

def test_render_payload_matches_jax(tmp_path):
    """The face payload in the byte protocol, with the standardization read
    from the feature store, equals the JAX package's."""
    from lets_face_it_tpu.data.synthetic import write_synthetic_dataset
    from lets_face_it_tpu_torch.data.synthetic import dims_for

    hp = train_hp()
    hp.dataset_root = str(tmp_path)
    write_synthetic_dataset(tmp_path / hp.Data["file_name"], seed=0,
                            dims=dims_for(hp.Data), n_train_chunks=1,
                            n_val_chunks=1, n_test_chunks=1, frames_per_chunk=20)
    seq = np.random.default_rng(0).standard_normal((2, 7, 16)).astype(np.float32)
    got, want = RenderClient("http://x/", port_hp(hp)), JaxRenderClient("http://x", hp)
    assert got.face_means is not None
    np.testing.assert_array_equal(got.face_means, want.face_means)
    assert got._face_payload(seq[0]) == want._face_payload(seq[0])
    assert byteify(seq) == jbyteify(seq)


class _StubService:
    """Stands in for the render service behind the repo's HTTP handler:
    records each payload and answers with a file name."""

    def __init__(self, video_dir, fail=False):
        self.video_dir = Path(video_dir)
        self.payloads = []
        self.fail = fail

    def render(self, payload):
        if self.fail:
            raise RuntimeError("renderer down")
        self.payloads.append(payload)
        return payload["file_name"]


@pytest.fixture
def render_service(tmp_path):
    service = _StubService(tmp_path)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield service, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


def _val_setup(tmp_path, **validation):
    hp = _tiny_run_hp(dataset_root=str(tmp_path / "no_store"))
    hp.Validation = dict(hp.Validation, **validation)
    spec, pspec = specs(train_hp())
    model = port_model(jax_params(spec, seed=5), pspec)
    _, val_ds = ploop.load_datasets(hp, _corpus(hp))
    return hp, pspec, model, val_ds


class _RecordingLogger(ploop.MetricLogger):
    def __init__(self):
        super().__init__(enabled=False)
        self.hists, self.lines = {}, []

    def histogram(self, step, name, values):
        self.hists[name] = np.asarray(values)

    def scalars(self, step, values):
        self.lines.append((step, dict(values)))


def test_run_validation_invertion_histograms_and_render(render_service, tmp_path):
    """Validation with check_invertion, scale_logging and render on: the
    invertibility error of the first val batch, the three histograms, and a
    POST of sample 0 (ground truth, generated) that the service receives and
    answers; ``on_rendered`` gets the video's URL."""
    service, url = render_service
    hp, pspec, model, val_ds = _val_setup(tmp_path, check_invertion=True, scale_logging=True,
                                          render=True, inference=True)
    client = RenderClient(url, hp, timeout=30)
    fired = threading.Event()
    seen = {}
    client.on_rendered = lambda step, u: (seen.update(step=step, url=u), fired.set())
    logger = _RecordingLogger()
    out = ploop.run_validation(pspec, hp, model, val_ds, torch.device("cpu"), 7, 1,
                               logger=logger, render_client=client)
    assert math.isfinite(out["reconstruction/error_percentage"])
    jb = ploop.to_device(val_ds.get_batch(np.arange(min(hp.batch_size, len(val_ds)))),
                         "cpu")
    z_seq, loss, _ = pseqglow.sequence_nll(pspec, model, jb)
    assert out["reconstruction/error_percentage"] == pytest.approx(
        float(pmetrics.invertibility_error(pspec, model, jb, z_seq, loss)), rel=1e-6)
    assert sorted(logger.hists) == ["actnorm_bias", "actnorm_scales", "lu_log_s"]
    assert logger.hists["actnorm_scales"].shape == (pspec.n_steps, pspec.channels)
    assert logger.lines == [(7, out)]
    assert fired.wait(timeout=30), "on_rendered never fired"
    assert seen["step"] == 7 and seen["url"].endswith("/video/val_7.mp4")
    (payload,) = service.payloads
    assert payload["file_name"] == "val_7.mp4" and payload["fps"] == 25
    start = pspec.cond.longest_history
    gt_expr = debyteify(payload["seqs"][0], "expression")
    np.testing.assert_array_equal(gt_expr[:, :10], jb["p1_face"][0, start:, :10].numpy())
    assert debyteify(payload["seqs"][1], "pose").shape == (hp.Validation["seq_len"] - start, 12)


def test_render_failure_never_stops_validation(tmp_path, capsys):
    hp, pspec, model, val_ds = _val_setup(tmp_path, render=True, inference=True)

    def broken(generated, gt, step):
        raise ConnectionError("no service")

    out = ploop.run_validation(pspec, hp, model, val_ds, torch.device("cpu"), 3, 1,
                               render_client=broken)
    assert "val_loss" in out and "jerk/generated_jerk" in out
    assert "render failed: no service" in capsys.readouterr().err


def test_render_client_survives_a_failing_service(tmp_path, capsys):
    service = _StubService(tmp_path, fail=True)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        hp = port_hp(train_hp())
        hp.dataset_root = str(tmp_path / "none")
        client = RenderClient(f"http://127.0.0.1:{server.server_address[1]}", hp,
                              timeout=30)
        seq = np.zeros((1, 4, 16), np.float32)
        client(seq, seq, step=2).join(timeout=30)
    finally:
        server.shutdown()
    assert "render request failed" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Config, checkpoints, CLI
# ---------------------------------------------------------------------------

def test_config_merges_like_jax(tmp_path):
    (tmp_path / "config.toml").write_text(
        '[comet]\napi_key = "k"\n[project]\nrandom_seed = 7\n')
    (tmp_path / "config.local.toml").write_text('[comet]\nproject_name = "p"\n')
    got = pconfig.load_config(tmp_path)
    assert got["comet"] == jconfig.load_config(tmp_path)["comet"]
    assert got["comet"] == {"api_key": "k", "project_name": "p"}
    assert got["project"] == {"random_seed": 7}   # other sections pass through
    empty = tmp_path / "empty"
    assert pconfig.load_config(empty) == {"comet": jconfig.load_config(empty)["comet"]}


def test_checkpoints_are_numbered_directories(tmp_path):
    """One directory per step, as tools/supervise_train.py looks for them
    before appending --resume_from; the newest three are kept."""
    hp = _tiny_run_hp(max_epochs=5, check_val_every_n_epoch=1)
    ck = tmp_path / "ck"
    assert not has_checkpoint(str(ck))
    ploop.train(hp, seed=2, ckpt_dir=ck, max_steps=24, device="cpu",
                corpus=_corpus(hp), verbose=False)
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [12, 18, 24]
    assert has_checkpoint(str(ck))
    assert sorted(p.name for p in ck.iterdir()) == ["12", "18", "24"]
    assert mgr.latest() == ck / "24" / "checkpoint.pt"


def _write_hparams(tmp_path, hp):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in vars(hp).items()
                                    if k != "config_name"}))
    return path


def test_train_cli_new_flags(tmp_path, capsys):
    """--device_data_cache on, --stall_timeout_s, --log_dir (TensorBoard with
    the histograms of scale_logging) and --render_url (render off in this
    config, so no client) on the CPU; the run resumes from its directory."""
    hp = train_hp()
    hp.batch_size = 8
    hp.Validation["scale_logging"] = True
    cfg = _write_hparams(tmp_path, hp)
    common = [str(cfg), "--synthetic-data", "--device", "cpu", "--seed", "4",
              "--ckpt_dir", str(tmp_path / "ck"), "--device_data_cache", "on",
              "--stall_timeout_s", "600", "--log_dir", str(tmp_path / "tb"),
              "--render_url", "http://127.0.0.1:9"]
    train_cli.main(common + ["--max_steps", "2"])
    train_cli.main(common + ["--max_steps", "3", "--resume_from", str(tmp_path / "ck")])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    vals = [m for m in lines if "val_loss" in m]
    assert [m["step"] for m in vals] == [2, 3]
    assert all("reconstruction/error_percentage" in m for m in vals)
    assert CheckpointManager(tmp_path / "ck").all_steps() == [2, 3]
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
