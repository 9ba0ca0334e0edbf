"""Benchmark of the port on one NVIDIA GPU (the port of the root ``bench.py``).

    python -m lets_face_it_tpu_torch.bench [--scaling]

Autoregressive 25-fps gesture sampling throughput of the final-model flow
(K=16, GRU couplings, the full conditioning stack) on seeded random
weights, the streaming path's latency, live-session pacing and capacity,
and the training step's rate, all on the card. Prints ONE JSON line on
stdout with the root bench's keys:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

plus ``power_limit_w`` and ``host`` (the host's CPU model); ``device`` is
the card's name as nvidia-smi gives it. Progress and the sections' readings
go to stderr. ``--scaling`` adds the training step at B = 64 ... 1024.

Baseline: the reference publishes no throughput numbers (BASELINE.md); the
target of BASELINE.json is 50x real time at 25 fps, 1250 generated frames
per second per chip. ``vs_baseline`` is the measured frames/s divided by
that target.

Timing: every section times host clock around work that ends in
``torch.cuda.synchronize()`` (``utils/timing.py``): a local card needs no
correction for a transport's fetch cost, so the sampling rows take the
median of three rounds of a sized number of calls, and the training rows
keep the N-against-2N difference of ``diff_time``. No key holds device
time: ``streaming_frame_device_ms_chained`` keeps the root bench's name but
is host wall time a push of chained pushes (``_chained_ms``), which the
host bounds at B=1; a device time comes only from a profiler trace. A
section's functions take ``device=``; ``main`` runs them on the card
(``resolve_device("cuda")`` raises without one) and never falls back to
the CPU.

No section falls back to another path when a kernel fails: only a CUDA
out-of-memory error is recorded, as ``{"error": "OutOfMemoryError"}`` in a
table or ``null`` for a value, and anything else fails the run. Each rung of
the streaming-capacity ladder holds its first push's frame kernel against
its plain twin (``ops/flow_kernels.py::frame_rev_fused_ref``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import platform
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.data.device_cache import make_device_batcher
from lets_face_it_tpu_torch.data.prefetch import (SideStreamTransfer,
                                                  prefetch_batches, receive)
from lets_face_it_tpu_torch.data.synthetic import dims_for, make_synthetic_corpus
from lets_face_it_tpu_torch.data.windows import WindowDataset
from lets_face_it_tpu_torch.hparams import HParams
from lets_face_it_tpu_torch.model import seqglow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import flow_kernels, train_kernels
from lets_face_it_tpu_torch.sample.streaming import (StreamingGenerator,
                                                     run_paced_session)
from lets_face_it_tpu_torch.sample.weights import seeded_random_model
from lets_face_it_tpu_torch.train import state as train_state
from lets_face_it_tpu_torch.train.loop import batch_transfer
from lets_face_it_tpu_torch.utils.device import resolve_device
from lets_face_it_tpu_torch.utils.precision import matmul_precision
from lets_face_it_tpu_torch.utils.timing import diff_time, hard_sync

REALTIME_FPS = 25.0
TARGET_REALTIME_FACTOR = 50.0
# frame_rev against its plain twin: the one-frame limit (chip_smoke.py's)
FRAME_ATOL, FRAME_RTOL = 2e-4, 1e-4
CAPACITY_LADDER = (64, 256, 1024, 4096, 8192)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_hparams() -> HParams:
    """The root bench's model: the final-model architecture (56-D face, K=16,
    GRU couplings, 512-D conditioning) of ``__graft_entry__._tiny_final_hparams``
    at the 80-frame training window (``Train.seq_len = 80``)."""
    hp = HParams(
        Conditioning={
            "cond_dim": 512,
            "p1_face": {"dropout": 0, "enc": "none", "hidden_dim": 256,
                        "history": 5, "dim": 56},
            "p1_speech": {"dropout": 0.5, "enc": "rnn", "hidden_dim": 128,
                          "history": 2},
            "p2_face": {"dropout": 0.6, "enc": "rnn", "hidden_dim": 256,
                        "history": 24, "dim": 56},
            "p2_speech": {"dropout": 0.3, "enc": "rnn", "hidden_dim": 256,
                          "history": 16},
            "use_frame_nb": False,
        },
        Data={"file_name": "lets_face_it.h5", "expression_dim": 50,
              "jaw_dim": 3, "neck_dim": 3, "speech_dim": 30,
              "use_standardization": True, "expression_delta_dim": 0,
              "jaw_delta_dim": 0, "neck_delta_dim": 0},
        Glow={"K": 16, "L": 1, "LU_decomposed": True, "actnorm_scale": 1.0,
              "flow_coupling": "affine", "flow_permutation": "invconv",
              "hidden_channels": 128, "rnn_type": "gru", "scale_eps": 1e-4},
        Infer={"eps": 1.0, "seq_len": 25},
        Train={"seq_len": 80, "use_negative_nll_loss": True},
        Validation={"seq_len": 32, "scale_logging": False},
        Optim={"name": "adam",
               "args": {"adam": {"betas": [0.9, 0.9999], "eps": 1e-8}},
               "Schedule": {"name": "step", "warm_up": 0,
                            "args": {"step": {"gamma": 0.73, "step_size": 3}}}},
        batch_size=8,
        lr=1e-5,
        max_epochs=1,
        gradient_clip_val=20.0,
        logger=False,
    )
    hp.config_name = "graft_entry"
    return hp


def example_batch(hp, batch_size: int, seq_len: int, seed: int = 0) -> dict:
    """The root bench's batch (``__graft_entry__._example_batch``): standard
    normal float32 numpy arrays [B, T, D] of the four modalities, in its
    draw order."""
    rng = np.random.default_rng(seed)
    c = hp.Data["expression_dim"] + hp.Data["jaw_dim"] + hp.Data["neck_dim"]
    s = hp.Data["speech_dim"]
    return {
        "p1_face": rng.standard_normal((batch_size, seq_len, c)).astype(np.float32),
        "p2_face": rng.standard_normal((batch_size, seq_len, c)).astype(np.float32),
        "p1_speech": rng.standard_normal((batch_size, seq_len, s)).astype(np.float32),
        "p2_speech": rng.standard_normal((batch_size, seq_len, s)).astype(np.float32),
    }


def on_device(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def build_full_model(device="cuda"):
    """(hp, spec, weights on ``device``): ``bench_hparams`` with seeded random
    weights (``seeded_random_model(spec, 0)``)."""
    hp = bench_hparams()
    spec = FlowSpec.build(hp)
    return hp, spec, seeded_random_model(spec, 0).to(device)


def _stream_frames(rng, b: int, c: int, s: int, n: int) -> list:
    """n conversation frames, each {p2_face [b, c], p1_speech [b, s],
    p2_speech [b, s]} of standard normal float32 numpy arrays."""
    return [{"p2_face": rng.standard_normal((b, c)).astype(np.float32),
             "p1_speech": rng.standard_normal((b, s)).astype(np.float32),
             "p2_speech": rng.standard_normal((b, s)).astype(np.float32)}
            for _ in range(n)]


def bench_sampling(hp, spec, params, batch_size: int, gen_frames: int = 100,
                   iters: int | None = None, with_band: bool = False, *,
                   device="cuda"):
    """Offline generation: ``sequence_sample`` of ``gen_frames`` frames after
    the longest history, at B = ``batch_size``. Each call draws its latents
    from a ``torch.Generator`` of its own seed, all made before the timed
    calls. Three rounds of ``iters`` calls (None: sized to about 0.75 s a
    round, 20 to 300), each timed by host clock up to a synchronize; the
    median round. -> (frames/s, s a call), and with ``with_band`` the
    (min, max) frames/s over the rounds."""
    seq_len = spec.cond.longest_history + gen_frames
    data = on_device(example_batch(hp, batch_size, seq_len), device)
    eps = float(hp.Infer["eps"])
    seeds = np.random.default_rng(1)

    def generators(n):
        return [torch.Generator(device=device).manual_seed(int(s))
                for s in seeds.integers(2**62, size=n)]

    def timed(gens):
        t0 = time.perf_counter()
        out = None
        for g in gens:
            out = seqglow.sequence_sample(spec, params, data, seq_len,
                                          eps_std=eps, generator=g)
        hard_sync(out)
        return time.perf_counter() - t0

    timed(generators(1))                       # first use
    if iters is None:
        # the least of 5 probes of 3 calls: a stall only adds time
        probe = generators(3)
        per_call = min(timed(probe) / 3 for _ in range(5))
        iters = int(min(max(20, round(0.75 / per_call)), 300))
    gens = generators(3 * iters)
    dts = sorted(timed(gens[i * iters:(i + 1) * iters]) / iters
                 for i in range(3))
    dt = dts[1]
    frames_per_sec = batch_size * gen_frames / dt
    if with_band:
        return (frames_per_sec, dt,
                (batch_size * gen_frames / dts[-1], batch_size * gen_frames / dts[0]))
    return frames_per_sec, dt


def bench_training(hp, spec, params, batch_size: int = 256, iters: int = 5,
                   repeats: int = 1, with_band: bool = False, *, device="cuda"):
    """The training step (``train_step``) at B = ``batch_size``, T =
    ``hp.Train["seq_len"]``, on a copy of ``params``: seconds a step by the
    N-against-2N difference (``iters`` against 2 ``iters``), the median of
    ``repeats``. -> (steps/s, s a step), and with ``with_band`` the
    (min, max) steps/s over the repeats."""
    state = train_state.TrainState.create(copy.deepcopy(params), hp,
                                          steps_per_epoch=100, seed=0)
    batch = on_device(example_batch(hp, batch_size, hp.Train["seq_len"]), device)
    hard_sync(train_state.train_step(spec, hp, state, batch))   # first use

    def run_n(n):
        m = None
        for _ in range(n):
            m = train_state.train_step(spec, hp, state, batch)
        hard_sync(m)

    dts = sorted(diff_time(run_n, iters) for _ in range(repeats))
    dt = dts[len(dts) // 2]
    if with_band:
        return 1.0 / dt, dt, (1.0 / dts[-1], 1.0 / dts[0])
    return 1.0 / dt, dt


def bench_corpus(hp):
    """The end-to-end rows' corpus, in memory: 40 train chunks of 400
    frames (and one val and one test chunk) of ``data/synthetic.py``, seed
    0, the root bench's ``write_synthetic_dataset`` arguments."""
    return make_synthetic_corpus(n_train_chunks=40, n_val_chunks=1,
                                 n_test_chunks=1, frames_per_chunk=400, seed=0,
                                 dims=dims_for(hp.Data))


def bench_training_e2e(hp, spec, params, batch_size: int = 256,
                       steps: int = 50, warm: int = 10, k_dispatch: int = 1, *,
                       device="cuda", corpus=None):
    """End-to-end training rate (steps/s): windows of ``corpus`` (default
    ``bench_corpus``) through the trainer's data path (the device data
    cache where ``make_device_batcher`` keeps one, the host gather and
    upload otherwise) and the prefetch worker, into chained steps; host
    clock over ``steps`` steps after ``warm``, up to a synchronize.

    ``k_dispatch > 1`` runs k steps a call (``train_state.MultiStep``, one
    CUDA graph a block on the card), which needs the device cache: returns
    None where there is none (the CPU)."""
    corpus = corpus if corpus is not None else bench_corpus(hp)
    ds = WindowDataset.from_chunks(corpus, "train", hp.Data, hp.Conditioning,
                                   hp.Train["seq_len"])
    state = train_state.TrainState.create(copy.deepcopy(params), hp,
                                          steps_per_epoch=100, seed=0)
    batcher = make_device_batcher(ds, hp, device)

    def endless():
        # the trainer's per-epoch (seed, epoch) reshuffle
        epoch = 0
        while True:
            rng = np.random.default_rng([0, epoch])
            yield from ds.epoch_index_batches(batch_size, rng=rng, shuffle=True,
                                              drop_last=True)
            epoch += 1

    if k_dispatch > 1:
        if batcher is None:
            return None
        multi = train_state.MultiStep(spec, hp, state, batcher.arrays,
                                      ds.seq_len, batch_size, k_dispatch)

        def blocks():
            it = endless()
            while True:
                yield [next(it) for _ in range(k_dispatch)]

        items = prefetch_batches(blocks(), transfer=SideStreamTransfer(
            batcher.get_starts_block, device))
        step = lambda staged: multi(receive(staged)["starts"])  # noqa: E731
    else:
        items = prefetch_batches(endless(),
                                 transfer=batch_transfer(ds, device, batcher))
        step = lambda staged: train_state.train_step(  # noqa: E731
            spec, hp, state, receive(staged))

    n, n0, t0, m = 0, 0, None, None
    with contextlib.closing(items):
        for staged in items:
            m = step(staged)
            n += k_dispatch
            if t0 is None and n >= warm:
                hard_sync(m)
                t0, n0 = time.perf_counter(), n
            elif t0 is not None and n - n0 >= steps:
                break
    hard_sync(m)
    return (n - n0) / (time.perf_counter() - t0)


def bench_batch_scaling(hp, spec, params, batch_sizes=(64, 128, 256, 512, 1024),
                        *, device="cuda") -> dict:
    """Training windows/s against batch size: ``bench_training`` at each B
    (2 to 5 iterations). A B that runs out of device memory reads
    ``{"error": "OutOfMemoryError"}``."""
    table = {}
    for bsz in batch_sizes:
        try:
            sps, dt = bench_training(hp, spec, params, batch_size=bsz,
                                     iters=max(2, min(5, 512 // bsz)),
                                     device=device)
        except torch.cuda.OutOfMemoryError:
            table[str(bsz)] = {"error": "OutOfMemoryError"}
            log(f"scaling B={bsz}: out of device memory")
            torch.cuda.empty_cache()
            continue
        table[str(bsz)] = {"step_ms": round(dt * 1e3, 1),
                           "windows_per_sec": round(bsz * sps, 1)}
    return table


def _chained_ms(gen: StreamingGenerator, frames: list, n: int) -> float:
    """Host ms a push of ``n`` chained pushes of ``gen`` (``frames`` cycled,
    no fetch), up to one synchronize: a settling run, then the median of 3
    rounds. Host wall time, not device time: where the host cannot keep the
    card fed, this is the host's time a push."""
    def chained():
        t0 = time.perf_counter()
        out = None
        for i in range(n):
            out = gen.push(**frames[i % len(frames)])
        hard_sync(out)
        return time.perf_counter() - t0

    chained()                                  # settle
    return sorted(chained() / n * 1e3 for _ in range(3))[1]


def bench_streaming(hp, spec, params, n_frames: int = 200, *, device="cuda"):
    """A live avatar's frame at B=1: ``n_frames`` pushes of a
    ``StreamingGenerator``, each frame fetched to the host (host clock per
    push: p50, p99 ms), then the chained cost (``_chained_ms`` over
    ``n_frames`` pushes). Inputs are 8 frames on the device, cycled. ->
    (p50_ms, p99_ms, chained_ms)."""
    c, s = spec.channels, hp.Data["speech_dim"]
    frames = [on_device(f, device)
              for f in _stream_frames(np.random.default_rng(5), 1, c, s, 8)]
    gen = StreamingGenerator(spec, params, batch_size=1,
                             eps_std=float(hp.Infer["eps"]), device=device)
    gen.push(**frames[0]).cpu()                # first use

    lat = []
    for i in range(n_frames):
        inp = frames[i % len(frames)]
        t0 = time.perf_counter()
        gen.push(**inp).cpu()                  # the frame on the host
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    return (float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99)),
            _chained_ms(gen, frames, n_frames))


def bench_streaming_session(hp, spec, params, n_frames: int = 300,
                            fps: float = REALTIME_FPS, depth: int = 2,
                            sessions: int = 3, *, device="cuda") -> dict:
    """Live sessions through the depth-``depth`` jitter buffer
    (``run_paced_session``): ``n_frames`` frames arriving on the ``fps``
    clock, backlogs drained in blocks; ``sessions`` sessions (the first
    precompiles), per-metric medians over them: completion lateness p50,
    p99 and max (ms), the largest catch-up block, underruns at ``depth``
    and the least buffer depth that absorbs the worst lateness."""
    c, s = spec.channels, hp.Data["speech_dim"]
    frames = _stream_frames(np.random.default_rng(6), 1, c, s, n_frames)
    gen = StreamingGenerator(spec, params, batch_size=1,
                             eps_std=float(hp.Infer["eps"]), device=device)
    reports = []
    for i in range(sessions):
        gen.reset()
        reports.append(run_paced_session(gen, frames, depth=depth, fps=fps,
                                         precompile=(i == 0)))
    lat = [r.lateness_s * 1e3 for r in reports]
    return {
        "p50": float(np.median([np.percentile(x, 50) for x in lat])),
        "p99": float(np.median([np.percentile(x, 99) for x in lat])),
        "max": float(np.median([x.max() for x in lat])),
        "max_dispatch": int(max(r.max_dispatch for r in reports)),
        "underruns_at_depth": int(np.median([r.underruns for r in reports])),
        "min_buffer_depth": int(np.median([r.min_depth for r in reports])),
        "depth": depth,
    }


def check_first_push(gen: StreamingGenerator, frame: dict) -> float:
    """Push ``frame`` through ``gen`` and hold what its frame kernel returned
    against the plain twin (``frame_rev_fused_ref``) on the inputs that push
    handed the kernel, at the one-frame limit (atol ``FRAME_ATOL``, rtol
    ``FRAME_RTOL``) -> the largest |difference|; raises where they
    disagree or the push did not reach the kernel."""
    seen = []
    kernel = gen.frame_kernel

    def recording(*args, **kwargs):
        out = kernel(*args, **kwargs)
        seen.append((args, out))
        return out

    gen.frame_kernel = recording
    try:
        gen.push(**frame)
    finally:
        gen.frame_kernel = kernel
    if len(seen) != 1:
        raise RuntimeError(f"a push reached the frame kernel {len(seen)} times")
    (spec, weights, z, projs, states), (x, new_states) = seen[0]
    x_ref, st_ref = flow_kernels.frame_rev_fused_ref(
        flow_kernels.kernel_spec(spec), weights, flow_kernels.pad_lanes(spec, z),
        projs, states, flow_kernels.precision_mode())
    err = 0.0
    for name, got, ref in (("x", x, flow_kernels.unpad_lanes(spec, x_ref)),
                           ("states", new_states, st_ref)):
        got, ref = got.double(), ref.double()
        diff = (got - ref).abs()
        if not torch.isfinite(got).all() or (
                diff > FRAME_ATOL + FRAME_RTOL * ref.abs()).any():
            raise RuntimeError(
                f"frame_rev B={z.shape[0]} {name}: max |diff| "
                f"{diff.max().item():.3e} from its plain twin exceeds atol "
                f"{FRAME_ATOL} + rtol {FRAME_RTOL}*|ref|")
        err = max(err, diff.max().item())
    return err


def _frame_launches() -> tuple:
    return (flow_kernels.frame_rev_fused.launches,
            dict(flow_kernels.sample_gates.plans))


def _path_since(before: tuple, pushes: int) -> str:
    """What served ``pushes`` pushes since ``before`` (``_frame_launches()``),
    from the launch counters: "frame_rev(<the gates' plans>)", with the
    launches a push where a push took more than one, or "plain" where no
    kernel launched (the CPU)."""
    launches, plans = before
    per_push = (flow_kernels.frame_rev_fused.launches - launches) / pushes
    if per_push == 0:
        return "plain"
    used = [p for p, n in flow_kernels.sample_gates.plans.items() if n > plans[p]]
    path = f"frame_rev({'+'.join(used)})"
    return path if per_push == 1 else f"{path} x{per_push:g} a push"


def capacity_rung(hp, spec, params, b: int, n_iters: int = 64, *,
                  device="cuda") -> dict:
    """One rung of the capacity ladder: a ``StreamingGenerator`` of ``b``
    sessions, its first push checked (``check_first_push``), then the
    chained ms a frame (``_chained_ms`` over ``n_iters`` pushes) on 8 frames
    staged on the device. -> {"chained_ms_per_frame", "path",
    "max_abs_err_vs_plain"}."""
    c, s = spec.channels, hp.Data["speech_dim"]
    frames = [on_device(f, device)
              for f in _stream_frames(np.random.default_rng(b), b, c, s, 8)]
    before = _frame_launches()
    gen = StreamingGenerator(spec, params, batch_size=b,
                             eps_std=float(hp.Infer["eps"]), device=device)
    err = check_first_push(gen, frames[0])
    ms = _chained_ms(gen, frames, n_iters)
    return {"chained_ms_per_frame": ms,
            "path": _path_since(before, pushes=1 + 4 * n_iters),
            "max_abs_err_vs_plain": err}


def bench_streaming_capacity(hp, spec, params, fps: float = REALTIME_FPS,
                             budget_ms: float = 40.0, n_iters: int = 64,
                             ladder=CAPACITY_LADDER, *, device="cuda",
                             rung=None):
    """Concurrent live sessions per card: a batched ``StreamingGenerator`` is
    B 25-fps sessions sharing each push, so the capacity is the largest B of
    ``ladder`` whose chained cost a frame stays within ``budget_ms`` (one
    frame period at ``fps``). The ladder stops at the first rung over budget
    or out of device memory (recorded as ``{"error": "OutOfMemoryError"}``);
    any other error fails. ``rung(b)`` measures one rung (default
    ``capacity_rung``). -> (sessions, {str(B): row}); 0 sessions when the
    first rung fails."""
    rung = rung or (lambda b: capacity_rung(hp, spec, params, b, n_iters,
                                            device=device))
    table, best = {}, 0
    for b in ladder:
        try:
            row = rung(b)
        except torch.cuda.OutOfMemoryError:
            table[str(b)] = {"error": "OutOfMemoryError"}
            log(f"capacity B={b}: out of device memory")
            torch.cuda.empty_cache()
            break
        row["chained_ms_per_frame"] = round(row["chained_ms_per_frame"], 3)
        table[str(b)] = row
        log(f"capacity B={b}: {row}")
        if row["chained_ms_per_frame"] <= budget_ms:
            best = b
        else:
            break
    return best, table


def nll_parity_check(hp, spec, params, *, device="cuda") -> float:
    """Relative error of ``sequence_nll`` on ``device`` (on the card: the
    training kernels) against the same function in float64 on the CPU,
    where the kernels' wrappers run their plain versions, on the same
    weights and the root bench's batch (B=2, T = ``hp.Train["seq_len"]``,
    seed 7)."""
    batch = example_batch(hp, 2, hp.Train["seq_len"], seed=7)
    with torch.no_grad():
        _, loss, _ = seqglow.sequence_nll(spec, params, on_device(batch, device))
        ref_model = copy.deepcopy(params).to("cpu", torch.float64)
        _, ref, _ = seqglow.sequence_nll(
            spec, ref_model, {k: torch.as_tensor(v, dtype=torch.float64)
                              for k, v in batch.items()})
    return abs(float(loss) - float(ref)) / max(abs(float(ref)), 1e-9)


def training_b1024(hp, spec, params, *, device="cuda"):
    """Steps/s of the B=1024 step (2 iterations), or None when it runs out
    of device memory; logs the peak memory allocated on the card."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        sps, _ = bench_training(hp, spec, params, batch_size=1024, iters=2,
                                device=device)
    except torch.cuda.OutOfMemoryError:
        sps = None
        torch.cuda.empty_cache()
    if on_card:
        log(f"training B=1024: {'out of device memory; ' if sps is None else ''}"
            f"peak {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB "
            "allocated")
    return sps


@dataclass(frozen=True)
class Sizes:
    """How much each section of ``run`` measures; the defaults are the root
    bench's."""
    sampling_iters: int | None = None    # calls a round; None: sized
    pushes: int = 200
    session_frames: int = 300
    sessions: int = 3
    train_iters: int = 5
    train_repeats: int = 3
    e2e_steps: int = 50
    e2e_warm: int = 10
    ladder: tuple = CAPACITY_LADDER
    ladder_iters: int = 64               # chained pushes a rung is timed on


def run(hp, spec, params, *, device="cuda", scaling: bool = False,
        sizes: Sizes = Sizes(), machine: dict) -> dict:
    """Every section, at "highest" (float32 products) and the
    ``*_bf16matmul`` rows at "medium" (bf16 operands in the kernels, the
    trainer's ``--precision 16``) -> the result line: the root bench's keys,
    ``machine``'s (``device``, ``power_limit_w``, ``host``) among them."""
    with matmul_precision("highest"):
        parity = nll_parity_check(hp, spec, params, device=device)
        log(f"nll parity vs the float64 plain path: {parity:.3e}")
        fps_b1, _ = bench_sampling(hp, spec, params, batch_size=1,
                                   iters=sizes.sampling_iters, device=device)
        fps_batch, _, band_batch = bench_sampling(
            hp, spec, params, batch_size=128, iters=sizes.sampling_iters,
            with_band=True, device=device)
        log(f"sampling: B=1 {fps_b1:.1f}, B=128 {fps_batch:.1f} frames/s "
            f"(band {band_batch})")
        stream_p50, stream_p99, stream_chained = bench_streaming(
            hp, spec, params, n_frames=sizes.pushes, device=device)
        log(f"streaming push B=1: p50 {stream_p50:.3f}, p99 {stream_p99:.3f}, "
            f"chained {stream_chained:.3f} ms")
        sess = bench_streaming_session(hp, spec, params,
                                       n_frames=sizes.session_frames,
                                       sessions=sizes.sessions, device=device)
        log(f"paced session: {sess}")
        capacity, capacity_table = bench_streaming_capacity(
            hp, spec, params, n_iters=sizes.ladder_iters, ladder=sizes.ladder,
            device=device)
        train_sps, _, band_train = bench_training(
            hp, spec, params, iters=sizes.train_iters,
            repeats=sizes.train_repeats, with_band=True, device=device)
        log(f"training B=256: {train_sps:.3f} steps/s (band {band_train})")
        sps_1024 = training_b1024(hp, spec, params, device=device)
        train_sps_e2e = bench_training_e2e(hp, spec, params,
                                           steps=sizes.e2e_steps,
                                           warm=sizes.e2e_warm, device=device)
        train_sps_e2e_k8 = bench_training_e2e(
            hp, spec, params, steps=sizes.e2e_steps, warm=sizes.e2e_warm,
            k_dispatch=8, device=device)
        log(f"training e2e: k=1 {train_sps_e2e:.3f}, k=8 {train_sps_e2e_k8} "
            "steps/s")
        batch_table = (bench_batch_scaling(hp, spec, params, device=device)
                       if scaling else None)
    with matmul_precision("medium"):
        train_sps_fast, _, band_train_fast = bench_training(
            hp, spec, params, iters=sizes.train_iters,
            repeats=sizes.train_repeats, with_band=True, device=device)
        fps_b1_fast, _ = bench_sampling(hp, spec, params, batch_size=1,
                                        iters=sizes.sampling_iters, device=device)
        fps_batch_fast, _, band_batch_fast = bench_sampling(
            hp, spec, params, batch_size=128, iters=sizes.sampling_iters,
            with_band=True, device=device)

    def maybe(x, digits):
        return round(x, digits) if x is not None else None

    target = REALTIME_FPS * TARGET_REALTIME_FACTOR
    result = {
        "metric": "gesture_frames_per_sec_per_chip_25fps_sampling",
        "value": round(fps_batch, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps_batch / target, 3),
        "sampling_batch": 128,
        "sampling_fps_batch1": round(fps_b1, 1),
        "realtime_factor_batch1": round(fps_b1 / REALTIME_FPS, 2),
        "streaming_frame_latency_ms_p50": round(stream_p50, 3),
        "streaming_frame_latency_ms_p99": round(stream_p99, 3),
        "streaming_frame_device_ms_chained": round(stream_chained, 3),
        "streaming_session_lateness_ms_p50": round(sess["p50"], 3),
        "streaming_session_lateness_ms_p99": round(sess["p99"], 3),
        "streaming_session_lateness_ms_max": round(sess["max"], 3),
        "streaming_session_max_catchup_dispatch": sess["max_dispatch"],
        "streaming_session_underruns_at_depth2": sess["underruns_at_depth"],
        "streaming_session_min_buffer_depth": sess["min_buffer_depth"],
        "streaming_sessions_per_chip_within_frame_budget": capacity,
        "streaming_realtime_headroom": round(
            (1e3 / REALTIME_FPS) / max(stream_p50, 1e-9), 1),
        "train_steps_per_sec_b256_T80": round(train_sps, 3),
        "train_steps_per_sec_b256_e2e": maybe(train_sps_e2e, 3),
        "train_steps_per_sec_b256_e2e_k8": maybe(train_sps_e2e_k8, 3),
        "train_steps_per_sec_b256_T80_bf16matmul": round(train_sps_fast, 3),
        "sampling_fps_batch1_bf16matmul": round(fps_b1_fast, 1),
        "sampling_fps_batched_bf16matmul": round(fps_batch_fast, 1),
        "train_windows_per_sec": round(train_sps * 256, 1),
        "train_windows_per_sec_b1024": maybe(
            sps_1024 * 1024 if sps_1024 is not None else None, 1),
        "nll_parity_rel_err_vs_torch_f64": round(parity, 8),
        **machine,
        "bands": {
            "value": [round(band_batch[0], 1), round(band_batch[1], 1)],
            "sampling_fps_batched_bf16matmul": [
                round(band_batch_fast[0], 1), round(band_batch_fast[1], 1)],
            "train_steps_per_sec_b256_T80": [
                round(band_train[0], 3), round(band_train[1], 3)],
            "train_steps_per_sec_b256_T80_bf16matmul": [
                round(band_train_fast[0], 3), round(band_train_fast[1], 3)],
        },
        "streaming_capacity_ladder": capacity_table,
    }
    if batch_table is not None:
        result["batch_scaling"] = batch_table
    return result


def kernel_wrappers() -> dict:
    """Each kernel's wrapper (whose ``launches`` counts its launches) by the
    kernel's name."""
    return {"frame_rev": flow_kernels.frame_rev_fused,
            "seq_rev": flow_kernels.sequence_rev_fused,
            "sample_gates": flow_kernels.sample_gates,
            "sample_chain": flow_kernels.sample_chain,
            "cond_gates": train_kernels.cond_gates,
            "seq_fwd": train_kernels.seq_fwd, "seq_bwd": train_kernels.seq_bwd}


def host_cpu() -> str:
    """The host's CPU: ``/proc/cpuinfo``'s model name (where the machine
    hides it, the vendor, family and model numbers), the CPUs this process
    sees and their clock."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if not line.strip():
                break                          # the first processor's block
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', platform.machine())} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}")
    clock = f", {float(info['cpu MHz']):.0f} MHz" if "cpu MHz" in info else ""
    return f"{name}, {os.cpu_count()} CPUs{clock}"


def machine(device) -> dict:
    """{"device": the card's name, "power_limit_w": its power limit in W
    (both by nvidia-smi), "host": ``host_cpu()``}; off the card the device
    type and no power limit."""
    from lets_face_it_tpu_torch.precision_ab import card_name

    if torch.device(device).type != "cuda":
        return {"device": torch.device(device).type, "power_limit_w": None,
                "host": host_cpu()}
    name, limit = card_name(device).rsplit(", ", 1)
    return {"device": name, "power_limit_w": float(limit.split()[0]),
            "host": host_cpu()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scaling", action="store_true",
                        help="add the training step at B = 64 ... 1024")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lets_face_it_tpu_torch.ops import cuda_build

    cuda_build.build()
    about = machine(device)
    log(f"benchmarking on {about['device']}, {about['power_limit_w']} W "
        f"(host {about['host']})")
    hp, spec, params = build_full_model(device)
    line = run(hp, spec, params, device=device, scaling=args.scaling,
               machine=about)
    log("kernel launches: "
        f"{ {name: fn.launches for name, fn in kernel_wrappers().items()} }")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
