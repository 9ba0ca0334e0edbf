"""The trainer's switches of the JAX package (train.py:34-64) in the port, on
the CPU: ``steps_per_dispatch`` (k steps per call of the k-step function,
``train/state.py::MultiStep``, run step by step here; the CUDA graph is the
card's), its resume, ``wire_dtype: bf16``, ``--profile_dir`` and
``precision: 16``.

The k-step trajectory is held to k = 1 bit for bit: on the CPU the k-step
body is the single step's arithmetic (the same draws in the same order, the
deranged batch chosen by a select instead of a branch).
"""

import json
import math

import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from lets_face_it_tpu_torch.data.device_cache import DeviceWindowBatcher
from lets_face_it_tpu_torch.data.prefetch import gather_host, receive
from lets_face_it_tpu_torch.train import __main__ as train_cli
from lets_face_it_tpu_torch.train import loop as ploop
from lets_face_it_tpu_torch.train import state as pstate
from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager

from test_torch_port_common import port_hp, train_hp

# A seed whose run takes a deranged step (the negative-NLL trick) inside a
# block of 5: step 15, the third of the block 13-17 (an epoch is 12 steps).
DERANGED_SEED, DERANGED_STEP = 4, 15


def _hp(**kw):
    hp = port_hp(train_hp())
    hp.batch_size = 4
    hp.max_epochs = 2
    hp.logger = False
    hp.device_data_cache = "on"
    hp.Train["use_negative_nll_loss"] = True
    for k, v in kw.items():
        setattr(hp, k, v)
    return hp


def _corpus(hp):
    return ploop.synthetic_corpus(hp, 1, n_train_chunks=2, n_val_chunks=1,
                                  n_test_chunks=1, frames_per_chunk=40)


def _run(hp, **kw):
    steps, vals = [], []
    state, _ = ploop.train(
        hp, seed=DERANGED_SEED, device="cpu", corpus=_corpus(hp), verbose=False,
        step_hook=lambda s, m: steps.append(
            (s, float(m["loss"]), float(m["deranged"]), float(m["grad_norm"]))),
        val_hook=lambda s, m: vals.append((s, m["val_loss"])), **kw)
    return state, steps, vals


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_steps_per_dispatch_matches_single_steps():
    """k = 5 takes the data, draws and updates of k = 1 (blocks of 5, the
    epoch's rest as a short block), with a deranged step inside a block."""
    s1, steps1, vals1 = _run(_hp(), max_steps=20)
    s5, steps5, vals5 = _run(_hp(steps_per_dispatch=5), max_steps=20)
    assert [s for s, *_ in steps5] == list(range(1, 21))
    assert [s for s, *_ in steps1] == [s for s, *_ in steps5]
    deranged = [s for s, _, d, _ in steps5 if d]
    assert DERANGED_STEP in deranged and 13 < DERANGED_STEP < 17
    assert steps5 == steps1
    assert vals5 == vals1 and [s for s, _ in vals5] == [12, 20]
    for a, b in zip(_params(s1), _params(s5)):
        assert torch.equal(a, b)
    assert s5.step == s1.step == 20
    assert math.isclose(float(s5.last_mismatched_nll), s1.last_mismatched_nll)


def test_steps_per_dispatch_resumes(tmp_path):
    """Stopped at step 14 (mid-epoch, mid-block) and resumed under k = 5
    from its checkpoint, the run ends where the uninterrupted k = 1 run
    ends (tests/test_checkpoint.py:141 for the JAX package)."""
    sa, _, vals_a = _run(_hp())
    _, _, vals_b = _run(_hp(steps_per_dispatch=5), max_steps=14,
                        ckpt_dir=str(tmp_path / "ck"))
    assert CheckpointManager(tmp_path / "ck").all_steps() == [12, 14]
    sc, steps_c, vals_c = _run(_hp(steps_per_dispatch=5),
                               resume_from=str(tmp_path / "ck"),
                               ckpt_dir=str(tmp_path / "ck"))
    assert [s for s, *_ in steps_c] == list(range(15, 25))
    assert vals_b[0] == vals_a[0] and vals_c == vals_a[1:]
    for a, b in zip(_params(sa), _params(sc)):
        assert torch.equal(a, b)


def test_steps_per_dispatch_needs_the_device_cache(capsys):
    """Without the device data cache the loop says so and runs k = 1."""
    _, steps, _ = _run(_hp(steps_per_dispatch=4, device_data_cache="off"),
                       max_steps=5)
    assert [s for s, *_ in steps] == [1, 2, 3, 4, 5]
    assert "needs the device data cache" in capsys.readouterr().out


def test_nan_in_a_block_names_its_step(monkeypatch):
    """With terminate_on_nan, a non-finite step inside a block of k stops
    the run after the block, naming that step."""
    original = pstate.MultiStep._body

    def poisoned(self, i):
        if self.state.step + i + 1 == 7:
            with torch.no_grad():
                self.state.model.flow["actnorm"]["bias"].fill_(float("nan"))
        original(self, i)

    monkeypatch.setattr(pstate.MultiStep, "_body", poisoned)
    with pytest.raises(FloatingPointError, match="step 7: loss nan"):
        _run(_hp(steps_per_dispatch=5, terminate_on_nan=True), max_steps=12)


def test_starts_block_and_optimizers():
    hp = _hp()
    train_ds, _ = ploop.load_datasets(hp, _corpus(hp))
    batcher = DeviceWindowBatcher(train_ds, "cpu")
    blocks = [np.array([3, 1, 4, 1]), np.array([5, 9, 2, 6])]
    starts = batcher.get_starts_block(blocks)["starts"]
    assert starts.dtype == torch.int32
    np.testing.assert_array_equal(starts.numpy(),
                                  train_ds.window_starts[np.asarray(blocks)])
    params = [torch.nn.Parameter(torch.zeros(2))]
    assert pstate.graph_supported(torch.optim.Adam(params))
    assert not pstate.graph_supported(torch.optim.SGD(params, lr=0.1))


# ---------------------------------------------------------------------------
# The bf16 wire
# ---------------------------------------------------------------------------

def test_bf16_wire_batches_are_the_rounded_host_batches():
    """What crosses is each float array rounded through bf16 (JAX
    loop.py:276-290 ships ml_dtypes.bfloat16), widened to float32 on the
    device, bit for bit; other dtypes pass unchanged."""
    hp = _hp(device_data_cache="off")
    train_ds, _ = ploop.load_datasets(hp, _corpus(hp))
    sel = np.array([0, 7, 3, 11])
    host = gather_host(train_ds, sel)
    got = receive(ploop.batch_transfer(train_ds, "cpu", None, wire_bf16=True)(sel))
    assert set(got) == set(host)
    for k, v in host.items():
        ref = v.numpy().astype(ml_dtypes.bfloat16).astype(np.float32)
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      ref.view(np.uint32))
    mixed = {"x": torch.tensor([1.0 + 2.0 ** -9, 3.0]),
             "i": torch.tensor([1, 2], dtype=torch.int32)}
    up = ploop.upload(mixed, "cpu", wire_bf16=True)
    assert up["i"].dtype == torch.int32 and torch.equal(up["i"], mixed["i"])
    assert up["x"].tolist() == [1.0, 3.0]


def test_bf16_wire_trains():
    _, steps, _ = _run(_hp(device_data_cache="off", wire_dtype="bf16",
                           max_epochs=1), max_steps=3)
    assert len(steps) == 3 and all(math.isfinite(v) for _, v, _, _ in steps)


# ---------------------------------------------------------------------------
# The CLI: --profile_dir, --precision 16, --steps_per_dispatch, --wire_dtype
# ---------------------------------------------------------------------------

def _write_hparams(tmp_path, hp):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in vars(hp).items()
                                    if k != "config_name"}))
    return path


def test_profile_dir_writes_a_trace(tmp_path):
    hp = train_hp()
    hp.batch_size = 8
    train_cli.main([str(_write_hparams(tmp_path, hp)), "--synthetic-data",
                    "--device", "cpu", "--max_steps", "3",
                    "--ckpt_dir", str(tmp_path / "ck"),
                    "--profile_dir", str(tmp_path / "prof")])
    trace = tmp_path / "prof" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("seq" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
               for e in events)


@pytest.mark.parametrize("extra", [[], ["--steps_per_dispatch", "2",
                                        "--device_data_cache", "on"],
                                   ["--wire_dtype", "bf16"]])
def test_precision_16_trains_and_restores(tmp_path, capsys, extra):
    """--precision 16 (with the other switches) takes 3 steps with finite
    losses, and torch's matmul settings are as they were afterwards."""
    hp = train_hp()
    hp.batch_size = 8
    train_cli.main([str(_write_hparams(tmp_path, hp)), "--synthetic-data",
                    "--device", "cpu", "--max_steps", "3", "--precision", "16",
                    "--ckpt_dir", str(tmp_path / "ck")] + extra)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [m["step"] for m in lines if "train_loss" in m] == [3]
    assert all(math.isfinite(m["train_loss"]) for m in lines if "train_loss" in m)
    assert CheckpointManager(tmp_path / "ck").all_steps() == [3]
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_train_precision_16_takes_three_steps():
    hp = _hp(precision=16, max_epochs=1)
    losses = []
    ploop.train(hp, seed=1, max_steps=3, device="cpu", corpus=_corpus(hp),
                verbose=False, step_hook=lambda s, m: losses.append(float(m["loss"])))
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert torch.get_float32_matmul_precision() == "highest"
