"""The port's benchmark (``lets_face_it_tpu_torch/bench.py``) and timing
helpers (``utils/timing.py``) against the root ``bench.py`` and the JAX
package's ``utils/timing.py`` on the CPU.

The timing helpers are held to the JAX package's semantics; the bench's
model config and batches to ``__graft_entry__``'s bit for bit; its NLL to
JAX ``sequence_nll`` on the same weights; its output line to the root
bench's keys (captured from the root bench's ``main`` with its sections
stubbed); and each section runs here at a tiny size through the kernels'
plain versions. Whether a card is present is decided inside the tests.
"""

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lets_face_it_tpu.model import FlowSpec, init_seqglow
from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu.utils import timing as jtiming
from lets_face_it_tpu_torch import bench
from lets_face_it_tpu_torch.data.synthetic import dims_for, make_synthetic_corpus
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.model.spec import FlowSpec as PortFlowSpec
from lets_face_it_tpu_torch.ops import flow_kernels
from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator
from lets_face_it_tpu_torch.utils import timing

from test_torch_port_common import (assert_close, jax_params, port_hp,
                                    port_model, specs, train_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parent.parent
MACHINE = {"device": "stub card", "power_limit_w": 1.0, "host": "stub host"}


# ---------------------------------------------------------------------------
# utils/timing.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixed, per_iter", [(0.25, 0.01), (0.0, 0.5),
                                             (3.0, -0.2)])
def test_diff_time_matches_jax(monkeypatch, fixed, per_iter):
    """N against 2N on a patched clock: the same seconds an iteration as the
    JAX package's, the fixed cost cancelled, floored at 1e-9 / iters."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def run_n(n):
        clock[0] += fixed + per_iter * n

    got = timing.diff_time(run_n, 7)
    want = jtiming.diff_time(run_n, 7)
    assert got == want
    assert got == pytest.approx(max(per_iter * 7, 1e-9) / 7)


def test_hard_sync_takes_nested_cpu_tensors(monkeypatch):
    """Nested dicts, lists and tuples of CPU tensors (and no tensor at all)
    need no synchronize."""
    def no_sync(*_):
        raise AssertionError("synchronize called for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timing.hard_sync({"m": {"loss": torch.zeros(()), "x": [torch.ones(2)]}})
    timing.hard_sync(({"a": (torch.ones(1),)}, torch.zeros(3)))
    timing.hard_sync({"none": None, "n": 3})
    assert timing._first_tensor({"a": [1, {"b": torch.ones(2)}]}).shape == (2,)


def test_cuda_time_ms_needs_a_card():
    """Without a card the CUDA-event timer raises; on one it times."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            timing.cuda_time_ms(lambda: None, 3)
    else:
        x = torch.ones(64, device="cuda")
        assert timing.cuda_time_ms(lambda: x.mul_(1.0), 3) > 0.0


# ---------------------------------------------------------------------------
# The model config, batches and NLL against the root bench's
# ---------------------------------------------------------------------------

def _root_hparams():
    hp = graft._tiny_final_hparams()
    hp.Train["seq_len"] = 80
    return hp


def test_bench_hparams_and_spec_equal_root():
    jhp, php = _root_hparams(), bench.bench_hparams()
    assert vars(php) == vars(jhp)
    jspec, pspec = FlowSpec.build(jhp), PortFlowSpec.build(php)
    for field in dataclasses.fields(pspec):
        got, want = getattr(pspec, field.name), getattr(jspec, field.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), field.name
        else:
            assert got == want, field.name


@pytest.mark.parametrize("seed, b, t", [(0, 3, 124), (7, 2, 80)])
def test_example_batch_equals_root_bitwise(seed, b, t):
    hp = bench.bench_hparams()
    got = bench.example_batch(hp, b, t, seed=seed)
    want = graft._example_batch(hp, b, t, seed=seed)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])


@pytest.fixture(scope="module")
def jax_nll():
    """JAX ``sequence_nll`` (XLA path) of the bench model at
    ``init_seqglow(PRNGKey(0))`` on the parity batch: (spec, params, batch,
    loss, losses)."""
    hp = _root_hparams()
    spec = FlowSpec.build(hp)
    params = init_seqglow(jax.random.PRNGKey(0), spec)
    batch = graft._example_batch(hp, 2, hp.Train["seq_len"], seed=7)
    fn = jax.jit(lambda p, b: jseqglow.sequence_nll(spec, p, b, use_fused=False)[1:])
    loss, losses = fn(params, batch)
    return params, batch, np.asarray(loss), np.asarray(losses)


def test_sequence_nll_on_jax_weights_equals_jax(jax_nll):
    """The port's ``sequence_nll`` (the training kernels' plain versions on
    the CPU) on JAX's weights carried across equals JAX's, loss and
    per-frame losses."""
    params, batch, loss, losses = jax_nll
    hp = bench.bench_hparams()
    pspec = PortFlowSpec.build(hp)
    model = port_model(params, pspec)
    with torch.no_grad():
        _, got, got_losses = pseqglow.sequence_nll(
            pspec, model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert_close(got, loss)
    assert_close(got_losses, losses)
    # the bench's own check: the same model against its float64 plain path
    assert bench.nll_parity_check(hp, pspec, model, device="cpu") < 1e-5


# ---------------------------------------------------------------------------
# The output line against the root bench's
# ---------------------------------------------------------------------------

def _stub_sections(port: bool):
    """Stand-ins for the sections of the root bench (``port=False``) or the
    port's, each returning what the real one returns."""
    kw = {}

    def sampling(*a, with_band=False, **k):
        return (1.0, 1.0, (1.0, 1.0)) if with_band else (1.0, 1.0)

    def training(*a, with_band=False, **k):
        return (1.0, 1.0, (1.0, 1.0)) if with_band else (1.0, 1.0)

    kw.update(
        nll_parity_check=lambda *a, **k: 1e-7,
        bench_sampling=sampling,
        bench_training=training,
        bench_streaming=lambda *a, **k: (1.0, 2.0, 0.5),
        bench_streaming_session=lambda *a, **k: {
            "p50": 1.0, "p99": 2.0, "max": 3.0, "max_dispatch": 1,
            "underruns_at_depth": 0, "min_buffer_depth": 1, "depth": 2},
        bench_streaming_capacity=lambda *a, **k: (
            64, {"64": {"chained_ms_per_frame": 1.0, "path": "stub"}}),
        bench_training_e2e=lambda *a, **k: 1.0,
        bench_batch_scaling=lambda *a, **k: {
            "64": {"step_ms": 1.0, "windows_per_sec": 1.0}},
    )
    if not port:
        kw.update(wait_for_accelerator=lambda *a, **k: True,
                  build_full_model=lambda: (None, None, None))
    return kw


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _root_line(root_bench, monkeypatch, capsys, scaling: bool) -> dict:
    """What the root bench's ``main`` prints with its sections stubbed."""
    with monkeypatch.context() as m:
        for name, fn in _stub_sections(port=False).items():
            m.setattr(root_bench, name, fn)
        m.setattr(sys, "argv", ["bench.py"] + (["--scaling"] if scaling else []))
        root_bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("scaling", [False, True])
def test_output_keys_equal_root_bench_keys(root_bench, monkeypatch, capsys,
                                           scaling):
    want = _root_line(root_bench, monkeypatch, capsys, scaling)
    for name, fn in _stub_sections(port=True).items():
        monkeypatch.setattr(bench, name, fn)
    got = bench.run(None, None, None, device="cpu", scaling=scaling,
                    machine=MACHINE)
    assert set(got) == set(want) | {"device", "power_limit_w", "host"}
    assert set(got["bands"]) == set(want["bands"])
    assert {k: got[k] for k in MACHINE} == MACHINE
    assert ("batch_scaling" in got) == scaling
    json.dumps(got)


def test_chip_smoke_holds_the_root_bench_keys(root_bench, monkeypatch, capsys):
    """The key list chip_smoke.py's step 21 holds the card's line to is the
    root bench's (without --scaling) and the port's two."""
    want = _root_line(root_bench, monkeypatch, capsys, False)
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert sorted(smoke.BENCH_KEYS) == sorted(want)
    assert set(smoke.BENCH_PORT_KEYS) == {"power_limit_w", "host"}
    assert set(smoke.BENCH_SIZES) <= {f.name for f in dataclasses.fields(bench.Sizes)}


def test_run_whole_on_the_cpu(tiny, root_bench, monkeypatch, capsys):
    """Every section through ``run`` at a tiny size: the root bench's keys,
    every number finite, k=8 null only because the CPU has no device
    cache, the ladder's rung checked."""
    hp, spec, model = tiny
    want = _root_line(root_bench, monkeypatch, capsys, False)
    sizes = bench.Sizes(sampling_iters=1, pushes=3, session_frames=10, sessions=1,
                        train_iters=1, train_repeats=1, e2e_steps=2, e2e_warm=1,
                        ladder=(2,), ladder_iters=2)
    got = bench.run(hp, spec, model, device="cpu", sizes=sizes, machine=MACHINE)
    assert set(got) == set(want) | set(MACHINE)
    nulls = [k for k, v in got.items() if v is None]
    assert nulls == ["train_steps_per_sec_b256_e2e_k8"]
    numbers = [v for v in got.values() if isinstance(v, (int, float))]
    numbers += [x for band in got["bands"].values() for x in band]
    assert np.isfinite(numbers).all()
    assert got["streaming_capacity_ladder"]["2"]["max_abs_err_vs_plain"] == 0.0
    assert got["nll_parity_rel_err_vs_torch_f64"] < 1e-5
    json.dumps(got)


def test_main_refuses_without_cuda(monkeypatch):
    """No card: ``main`` raises before it builds, measures or prints."""
    def never(*a, **k):
        raise AssertionError("measured without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "run", never)
    monkeypatch.setattr(bench, "build_full_model", never)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        bench.main([])


# ---------------------------------------------------------------------------
# The sections on the CPU at a tiny size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """A tiny config inside the kernels' envelopes, the port's HParams and
    spec, and JAX-initialised weights on the CPU."""
    hp = train_hp()
    spec, pspec = specs(hp)
    assert flow_kernels.fused_supported(pspec)
    return port_hp(hp), pspec, port_model(jax_params(spec, seed=3), pspec)


def _is_pair(x):
    return isinstance(x, tuple) and len(x) == 2 and all(
        isinstance(v, float) for v in x)


@pytest.mark.parametrize("iters", [2, None])
def test_sampling_section(tiny, iters):
    hp, spec, model = tiny
    fps, dt = bench.bench_sampling(hp, spec, model, batch_size=2, gen_frames=3,
                                   iters=iters, device="cpu")
    assert fps > 0 and dt > 0 and fps == pytest.approx(2 * 3 / dt)
    fps, dt, band = bench.bench_sampling(hp, spec, model, batch_size=2,
                                         gen_frames=3, iters=2, with_band=True,
                                         device="cpu")
    assert _is_pair(band) and band[0] <= fps <= band[1]


def test_training_sections(tiny):
    hp, spec, model = tiny
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sps, dt, band = bench.bench_training(hp, spec, model, batch_size=2, iters=1,
                                         repeats=3, with_band=True, device="cpu")
    assert sps == pytest.approx(1.0 / dt) and _is_pair(band)
    assert band[0] <= sps <= band[1]
    table = bench.bench_batch_scaling(hp, spec, model, batch_sizes=(2, 4),
                                      device="cpu")
    assert list(table) == ["2", "4"]
    for row in table.values():
        assert set(row) == {"step_ms", "windows_per_sec"}
        assert row["step_ms"] > 0 and row["windows_per_sec"] > 0
    # the sections train copies: the weights they were given stay as they were
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_training_b1024_is_none_only_on_oom(tiny, monkeypatch):
    hp, spec, model = tiny

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("stub")

    monkeypatch.setattr(bench, "bench_training", oom)
    assert bench.training_b1024(hp, spec, model, device="cpu") is None
    monkeypatch.setattr(bench, "bench_training",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("x")))
    with pytest.raises(ValueError):
        bench.training_b1024(hp, spec, model, device="cpu")


def test_e2e_section(tiny):
    """The trainer's data path on the CPU (host gather, no device cache);
    k=8 needs the cache, so it gives None here."""
    hp, spec, model = tiny
    corpus = make_synthetic_corpus(n_train_chunks=2, n_val_chunks=1,
                                   n_test_chunks=1, frames_per_chunk=40, seed=0,
                                   dims=dims_for(hp.Data))
    sps = bench.bench_training_e2e(hp, spec, model, batch_size=2, steps=3,
                                   warm=1, device="cpu", corpus=corpus)
    assert isinstance(sps, float) and sps > 0
    assert bench.bench_training_e2e(hp, spec, model, batch_size=2, steps=3,
                                    warm=1, k_dispatch=8, device="cpu",
                                    corpus=corpus) is None


def test_streaming_sections(tiny):
    hp, spec, model = tiny
    p50, p99, chained = bench.bench_streaming(hp, spec, model, n_frames=5,
                                              device="cpu")
    assert 0 < p50 <= p99 and chained > 0
    sess = bench.bench_streaming_session(hp, spec, model, n_frames=10, fps=100.0,
                                         sessions=2, device="cpu")
    assert set(sess) == {"p50", "p99", "max", "max_dispatch",
                         "underruns_at_depth", "min_buffer_depth", "depth"}
    assert sess["depth"] == 2 and sess["max_dispatch"] >= 1
    assert all(isinstance(sess[k], float) for k in ("p50", "p99", "max"))
    assert all(isinstance(sess[k], int) for k in
               ("max_dispatch", "underruns_at_depth", "min_buffer_depth"))


def test_capacity_ladder_on_the_plain_path(tiny):
    """Real rungs on the CPU: each first push checked (the wrapper runs its
    plain twin here), the path read from the launch counters: none."""
    hp, spec, model = tiny
    best, table = bench.bench_streaming_capacity(
        hp, spec, model, budget_ms=1e9, n_iters=3, ladder=(2, 4), device="cpu")
    assert best == 4 and list(table) == ["2", "4"]
    for row in table.values():
        assert row["path"] == "plain" and row["max_abs_err_vs_plain"] == 0.0
        assert isinstance(row["chained_ms_per_frame"], float)


@pytest.mark.parametrize("costs, best, rungs", [
    ({64: 10.0, 256: 30.0, 1024: 50.0, 4096: 1.0, 8192: 1.0}, 256, 3),
    ({64: 41.0, 256: 1.0, 1024: 1.0, 4096: 1.0, 8192: 1.0}, 0, 1),
    ({64: 1.0, 256: 2.0, 1024: 3.0, 4096: 4.0, 8192: 40.0}, 8192, 5),
    ({64: "oom"}, 0, 1),
    ({64: 1.0, 256: "oom"}, 64, 2),
])
def test_capacity_ladder_stops_at_the_first_failing_rung(costs, best, rungs):
    """Given per-rung costs: the largest rung within 40 ms before the first
    rung over budget or out of memory; 0 when the first rung fails."""
    def rung(b):
        if costs[b] == "oom":
            raise torch.cuda.OutOfMemoryError("stub")
        return {"chained_ms_per_frame": costs[b], "path": "stub"}

    got_best, table = bench.bench_streaming_capacity(None, None, None, rung=rung,
                                                     device="cpu")
    assert got_best == best and len(table) == rungs
    last = table[list(table)[-1]]
    if "oom" in costs.values():
        assert last == {"error": "OutOfMemoryError"}


def test_capacity_ladder_fails_on_other_errors():
    def rung(b):
        raise ValueError("a kernel failed")

    with pytest.raises(ValueError):
        bench.bench_streaming_capacity(None, None, None, rung=rung, device="cpu")


def test_first_push_check_catches_a_wrong_frame(tiny):
    """A frame kernel whose output is off by more than the one-frame limit
    fails the check."""
    hp, spec, model = tiny
    gen = StreamingGenerator(spec, model, batch_size=3, device="cpu")
    frame = bench.on_device(bench._stream_frames(np.random.default_rng(0), 3,
                                                 spec.channels,
                                                 hp.Data["speech_dim"], 1)[0],
                            "cpu")
    assert bench.check_first_push(gen, frame) == 0.0
    kernel = gen.frame_kernel

    def off(*args, **kwargs):
        x, states = kernel(*args, **kwargs)
        return x + 1e-3, states

    gen.frame_kernel = off
    with pytest.raises(RuntimeError, match="plain twin"):
        bench.check_first_push(gen, frame)
