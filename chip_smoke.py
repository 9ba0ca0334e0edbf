#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path, its training path of
``hparams/final_model.yaml`` at full width on seeded random weights, its
render path and its feature extraction at the FLAME 2019 sizes, from the
sources in this checkout:

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels (``lets_face_it_tpu_torch/csrc``) with nvcc
   and prints each one's registers and spills;
3. holds each sampling kernel against its plain PyTorch version on the card:
   ``frame_rev`` and ``seq_rev`` as their wrappers run them, and the two
   kernels each frame of them runs, ``sample_gates`` and ``sample_chain``,
   alone, at the main paths' batches and at odd ones (partial tiles and
   clusters), with and without the own-face history, the gates on each of
   their two plans forced ("vector", the launcher's below 64 rows at
   "highest", and "tile" on the tensor cores), the tile plan's 3xTF32 at
   B=128 no farther from the float64 product than the plain float32
   version, and ``sequence_sample``'s B=128 on the gates' tile plan;
4. saves the weights in the reference's names, loads them through
   ``Generator.from_checkpoint``, generates a sequence and streams frames
   (``StreamingGenerator``), and checks the outputs against the plain path on
   the CPU with the same latents;
5. checks that each sampling kernel's launch counter rose during step 4
   (``sample_gates`` and ``sample_chain`` count the launches that
   ``frame_rev`` and ``seq_rev`` make of them), the gates' counters by plan
   too (B=1 on the vector plan, the B=64 pushes on the tile plan);
6. times the serving path and each sampling kernel beside its plain version,
   a library yardstick and its bound, the gates on the launcher's plan
   beside the other plan;
7. traces a push at B=1 and B=64 and a generate at B=1 with
   ``torch.profiler``: device time, device idle share and the largest device
   operations of each call;
8. holds the training kernels against their plain versions at B=256, N=56
   (the conditioning gates ``cond_gates`` on both plans, "tc" also against
   the float64 product, the forward's outputs, and the
   backward's outputs on seeded cotangents), and the autograd Function's
   gradients against eager autograd through the ``flow.frame_fwd`` loop, on
   two weight seeds (these checks time nothing: they run after step 22's
   training, beside step 19's trials and step 23's runs);
9. trains ``final_model`` at B=256 for 3 steps and one validation on the
   synthetic corpus (``train.loop.train``), checks that ``cond_gates``,
   ``seq_fwd``, ``seq_bwd`` and ``seq_rev`` were launched, that loss and gradient norm
   are finite, and that the checkpoint loads through
   ``Generator.from_checkpoint`` and generates;
10. holds 2 training steps at B=32 against the same steps on the CPU plain
    path (same weights, batch and draws);
11. times the training step and each training kernel beside its plain
    version, a library yardstick and its bound (``seq_fwd`` as the whole
    route and as its two launches, ``cond_gates`` beside its simt plan and
    one cuBLAS call for the same product), and traces a training step with
    ``torch.profiler``; steps 9, 12 and 13 require the gates' new plans
    among their launches ("tc" for training, "tile" for evaluation);
12. inverts latents at B=128, T=100 with ``sequence_invert`` (one
    ``frame_rev`` call a frame) against its plain route on the card and
    against the frames ``sequence_nll`` encoded, on two weight seeds, with
    the invertibility error held to its closed form, and times both routes;
13. evaluates the training checkpoint of step 9 on the synthetic test split
    through ``python -m lets_face_it_tpu_torch.run_test`` (``.npz`` keys,
    finite values, the summary, launches and ms per batch);
14. trains at B=256 with the device data cache off and on (3 steps and a
    validation with ``check_invertion`` and ``scale_logging`` on, each way
    once): the batches of both data paths bit for bit, the
    per-step NLL of both runs, and the loop's steps and windows per second.
15. renders a study segment on the synthetic head at the FLAME 2019 sizes
    (V=5023): ``stimulus.render_segment`` with the step 4 ``Generator``
    (one ``seq_rev`` call) and the FLAME decoder on the card, its mp4 write
    swapped for a stand-in that keeps the vertices; the same faces, and one
    face of 1,500 frames, through ``RenderService.get_vertices`` from the
    byte protocol's blobs; the vertices held against the float64 CPU path,
    2 frames of the pair through the raster stage
    (``render/video.py::render_double_face_frames``, 2048x1024) against the
    frames of the float64 vertices, and, where OpenCV is installed, written
    as an mp4 and read back; the mesh stage's times, a profile window, the
    raster time and the peak device memory.
16. extracts features on the card (``lets_face_it_tpu_torch/features``): a
    2-minute stereo session at 44.1 kHz through the prosody (traced), MFCC
    and VAD functions, held against the same functions on the CPU, with
    seconds per minute of audio and Viterbi's share; the batched FLAME
    landmark fit at B=256, 30 + 60 steps, on the synthetic head at V=5023
    (frames/s, landmark RMS, line-search trials a step), at B=64 the
    objective's value and gradient and then whole fits held against the
    CPU; RingNet-lite and a fit seeded by it; 5 s of lipsync meshes
    through the mesh fit; then the extraction CLI's audio and voca stages
    on two sessions of 6 s with the synthetic head, the participants'
    landmark fits and the combiner in memory (the stages that write HDF5
    run in the CPU tests), ``final_model`` trained 3 steps from that corpus
    and a sequence generated from its checkpoint (``cond_gates``,
    ``seq_fwd``, ``seq_bwd`` and ``seq_rev`` launched on that path); one
    ``{"extract": ...}`` line.
17. the matmul precision modes and the trainer's other switches: what an
    eager float32 product gives under each torch setting on this card;
    every kernel at "high" (TF32 operands) and "medium" (bf16 operands)
    against its plain twin at the same mode at the main paths' shapes, with
    the launch counters of each call, each kernel's first step (one product
    deep) held tighter and the same kernel launched at each other mode
    required to fail that limit, and ``seq_rev`` and ``frame_rev`` bit for
    bit as their gates and chain kernels launched one by one (the gates
    alone at B=1, 64, 128 and 512); each kernel's time at each mode beside
    its plain twin, the library call at torch's same setting (for
    ``seq_bwd`` the eager loop's autograd backward) and its bound
    at the mode's tensor-core rate, the gates at B=128 too, each gate kernel
    beside its other plan; each mode's path (two training steps, a
    validation, three pushes) with its launches and gate plans ("tc" and
    "tile" required); the B=256 step at precision
    32 and 16 and a trace of it at 16; a short A/B (50 steps a arm, a
    validation at the end) with the val-NLL deltas held; the trainer with
    ``steps_per_dispatch`` 5 (one CUDA graph a block, replays counted)
    against 1 over 25 steps (replays on fresh blocks, a deranged step and
    a new epoch's rate among them), with the loop's ms a step and idle
    share; the bf16 wire with
    the cache off (batches bit for bit, ms a step); and the CLI at
    ``--precision 16`` with ``--profile_dir`` for 3 steps; one
    ``{"precision": ...}`` line. The kernels' line gains a record per
    kernel and reduced mode.
18. the kernels at two specs of the JAX kernels' envelope that the
    final_model checks do not reach: C = 54 (each half of the coupling
    split padded from 27 to 28 lanes) and C = 54 at H = 512 (the chain's
    hidden split in a cluster of 8, its streaming variant timed beside it;
    the training pair's hidden split): each
    spec's path (2 steps, a validation, 3 pushes) with its launches, then
    every kernel against its plain twin at the final_model limits, timed
    beside the library call and its bound (``cond_gates`` at every mode, as
    step 17 holds it, and against the float64 product), with the chain's
    and seq_bwd's plans printed; the chain at C = 54, H = 128 also forced
    to its streaming variant, for its time beside the resident one's; then
    final widths at H = 256 (the chain resident in a cluster of 16): a step,
    a validation and 3 pushes, ``frame_rev`` B=1 and 64, ``seq_rev`` B=1
    the same way, and ``seq_fwd`` and ``seq_bwd`` B=64 on their hidden
    split (each against its plain twin as at H = 1024 below, the backward
    at the training limits alone; the walk plans timed beside them); at
    C = 54, H = 512 both plans of both serial training kernels ("walk" and
    "hsplit") checked and timed, with the launcher's printed; then final
    widths at H = 1024,
    where both serial training kernels run their hidden split: the path
    (2 steps at B=64, a validation, 3 pushes; "hsplit" required of both),
    and ``seq_fwd`` and ``seq_bwd`` at B=64 and, at K = 32, B=16 (N=28), each
    against its plain twin at the training limits or 3 times the twin's own
    float32 - float64 distance, whichever is larger, timed beside the eager
    loop and the bound; then final widths on the sampling chain's hidden
    split (H = 1,152 and 2,048, K = 16): each path (2 steps at B=64, a
    validation whose inversion launches ``frame_rev``, 3 pushes; the chain's
    "hsplit" plan required), ``frame_rev`` B=1 and 64 and ``seq_rev`` B=1
    over 76 frames against their plain twins (one frame at the final_model
    limits; a sequence's first frames there too, all of it at
    max(SEQ_LOOSE_ATOL, 3 x the twin's own float32 - float64 distance)),
    the chain alone at B=1; and the ceiling, H = 8,192 at K = 4: the same
    kernel rows on the hidden split, without a path; one ``{"widened":
    ...}`` line and a record per kernel and spec in the kernels' line.
19. the hyperparameter search (``train/tuning.py``): ``Study.optimize`` on
    final_model over ``hparam_tuning_configs/large_hparam_search.py``, 3
    trials of 10 steps from a pinned seed, each in a spawned subprocess on
    the card; each trial's spec, state, seconds and launches, none failed,
    and each inside the JAX kernels' envelope on the training and sampling
    kernels; one ``{"tuning": ...}`` line.
20. data parallelism (``parallel/mesh.py``): 5 steps at B=256 on world size
    1 over NCCL and world size 2 over gloo on the one card, both at once,
    against one process (step 10's limits); one ``{"ddp": ...}`` line.
21. the benchmark (``lets_face_it_tpu_torch/bench.py``, which
    ``python -m lets_face_it_tpu_torch.bench`` runs in full) in process at a
    cut of its sizes: sampling B=1 and 128, pushes, a paced session, the
    whole capacity ladder to B=8192 with each rung's first push held against
    ``frame_rev``'s plain twin, the B=256 and B=1024 steps, the loop at k=1
    and k=8, the precision-16 rows, the NLL against the float64 plain path
    (step 8's limit); the root bench's keys all present, every number
    finite, k=8 not null, every kernel launched. Then the bench's shapes
    no earlier step holds: ``sequence_nll`` at B=512 and B=1024 (loss,
    per-frame losses, every gradient leaf) against the plain route at
    step 8's limits, seq_rev at B=128 over 100 frames against its plain
    twin, and a ``torch.profiler`` window over the 124-frame
    ``sequence_sample`` B=128 call (seq_rev's kernels and the rest); one
    ``{"bench": ...}`` line, and the bench's launches in the kernels' line.
22. the paper's Table-1 path at a cut (``ablation_table1.py``,
    ``trick_gate_probe.py``, ``device_cache_scale_probe.py``):
    ``final_model`` and ``no_nll_trick`` 40 steps each at B=64, precision
    16, validating at steps 20 and 40 with the wrong-context probes; 40
    steps of the gate probe's loop; the scale probe on 290 train chunks of
    1,000 frames (B=256 k=8, then B=1024). ``cond_gates``, ``seq_fwd`` and
    ``seq_bwd`` launched on the path (``table1``); the first val batch's
    NLL and each deranged NLL on the trained weights against the plain
    route at the training forward's limit; every fired step's gate
    variable -nll and loss -0.1 nll; both cut splits cached by ``auto``;
    every loss finite. One ``{"table1": ...}`` line. It runs after step 18;
    its checks against the plain route time nothing and run beside step
    19's trials, after step 8's.
23. kill and resume on the card at a cut (``long_run.py``,
    ``supervise_train.py``, ``extract_val_curve.py``): ``final_model`` at
    full width, B=256, precision 32, 8 steps a CUDA graph, the device data
    cache on, 3 epochs of 10 steps; one worker uninterrupted and, beside
    it, one SIGTERMed by its parent after epoch 1's checkpoint and resumed
    under ``supervise_train``: the final weights, Adam's state, the step
    generator and the meta equal bit for bit, the validation rows after the
    kill equal, the curve's segments as expected, and ``cond_gates``,
    ``seq_fwd``, ``seq_bwd`` and ``seq_rev`` launched in the resumed
    segment (``resume``). The two runs start before step 19 and run beside
    its trials and steps 8 and 22's checks; their check follows step 19.
    One ``{"resume": ...}`` line.
24. the JAX package's start replayed (``train/replay.py``): the small
    fixture ``tests/fixtures/torch_table1_replay_small.npz`` (the JAX
    seed-1234 weights at a small width, 24 steps' draws with two fired
    steps, two validations' probe permutations, the JAX package's per-step
    NLL and gradient norm) through ``train(replay=)`` on the card, where
    ``cond_gates``, ``seq_fwd`` and ``seq_bwd`` launch (``replay``), and
    on the CPU: every step's branch, NLL and gradient norm against the JAX
    record and against the CPU replay, each validation against the CPU's.
    One ``{"replay": ...}`` line.

Each step's wall time is printed as it ends (``wall: step ...``) and all of
them as one ``{"step_wall_s": ...}`` line before the total. The line before
the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
It needs no network, imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T_START = time.perf_counter()   # before torch and the port are imported

REPO = Path(__file__).resolve().parent
if not (REPO / "lets_face_it_tpu_torch" / "csrc").is_dir():
    sys.exit("chip_smoke: FAILED: run from a checkout: lets_face_it_tpu_torch/ "
             "is not beside this script")
sys.path.insert(0, str(REPO))


def in_thread(fn, *args):
    """Start ``fn(*args)`` in a thread -> a join that returns its result or
    raises what it raised (fail()'s SystemExit too) in the caller."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 -- handed to the caller
            box["exc"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    return join


def timed_build():
    """Build every kernel library (``ops/cuda_build.py``, nvcc in parallel)
    -> (paths, seconds)."""
    from lets_face_it_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build()
    return paths, time.perf_counter() - t0


# Run as a script, the build starts here, before torch and the port are
# imported: the imports take seconds that the nvcc processes overlap
# (main() waits for them).
BUILD = in_thread(timed_build) if __name__ == "__main__" else None

# each kernel's wrapper by its name in the JSON record
from lets_face_it_tpu_torch.bench import kernel_wrappers  # noqa: E402
# mean ms a call by CUDA events; a function captured once in a CUDA graph
from lets_face_it_tpu_torch.utils.timing import cuda_time_ms as time_ms  # noqa: E402
from lets_face_it_tpu_torch.utils.timing import graphed  # noqa: E402

SEED = 20240
# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): HBM3 bytes/s and
# float32 FLOP/s without tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Tolerances. One frame (16 steps): float32 with a different summation order
# than cuBLAS, so allclose at atol 2e-4, rtol 1e-4 (the JAX kernel tests').
ATOL, RTOL = 2e-4, 1e-4
# Whole sequences: each generated frame feeds the next through the own-face
# history, so rounding differences grow with the frame index. The first
# SEQ_TIGHT frames are held at the one-frame tolerance, the whole sequence at
# SEQ_LOOSE_ATOL (absolute, on standardized frames whose |x| reaches ~30).
# On an H100 the largest reading over the three weight seeds below at B=128
# was 4.727e-03, and the plain version's own float32-vs-float64 drift
# 1.680e-03; the limit keeps about 4x headroom over that spread, while a
# wrong index or state shows in whole frames.
SEQ_TIGHT = 8
SEQ_LOOSE_ATOL = 2e-2
# Weight seeds the sequence kernel is held against its plain version on at
# B=128 (the first also at B=1 and on the main path).
SEQ_SEEDS = (SEED, SEED + 1, SEED + 2)
# Calls per traced window of step 7 (20 until the script's time limit needed
# the time: the profiler's own cost grows with the operations it records).
PROFILE_CALLS = 6
# Training kernels against their plain versions (step 8), float32 in another
# summation order: forward values atol 1e-5 / rtol 1e-5, backward outputs
# atol 2e-5 / rtol 1e-4 (the JAX kernel tests', tests/test_pallas_train.py).
TRAIN_VAL_ATOL, TRAIN_VAL_RTOL = 1e-5, 1e-5
TRAIN_BWD_ATOL, TRAIN_BWD_RTOL = 2e-5, 1e-4
# The Function's gradients against eager autograd: each parameter gradient
# is a sum over N*B = 14,336 rows (and the state chain runs through 56
# frames), taken in another order by the two paths, so an entry is held to
# atol 2e-5 plus GRAD_LEAF_RTOL times the largest |entry| of its leaf.
GRAD_ATOL, GRAD_LEAF_RTOL = 2e-5, 1e-4
TRAIN_SEEDS = (SEED, SEED + 1)
# Training main path (step 9): 10 synthetic train chunks of 160 frames give
# 810 windows of 80, 3 steps of 256 per epoch; the 2 val chunks 122 windows.
TRAIN_STEPS, TRAIN_CHUNKS = 3, 10
# Step 12: sequence_invert at B=128 on these weight seeds. Both routes and the
# reconstruction are held at the one-frame tolerance (the conditioning is
# teacher-forced, so rounding does not feed back through the output). The
# backward logdet is the forward one negated, so the invertibility error
# |(backward + loss) / loss| * 100 equals |2 mean(log p(z)) / ln 2 / loss|
# * 100; it is held to that within INVERT_ERR_RTOL (relative).
INVERT_SEEDS, INVERT_BATCH = (SEED, SEED + 1), 128
INVERT_ERR_RTOL = 1e-4
# Step 14: the trainer with the device data cache off and on on a corpus of
# 20 train chunks (1620 windows of 80, 6 steps of 256 an epoch, so a run
# crosses an epoch): LOOP_WARM steps, LOOP_WINDOW steps timed, LOOP_WINDOW
# steps traced (off, on, on, off until step 24 needed the time; 40 chunks and
# windows of 8 until the script's time limit did).
CACHE_RUNS = ("off", "on")
LOOP_CHUNKS, LOOP_WARM, LOOP_WINDOW = 20, 3, 4
# Step 10: the GPU's steps against the CPU plain path's at B=32. The first
# step starts from the same weights (NLL rtol 1e-5, the JAX trajectory
# test's); Adam moves every entry by about the learning rate (1e-5) per step
# whatever its gradient's size, so an entry whose gradient is at rounding
# level may move the other way on the other path: the second step's NLL is
# held at rtol 1e-4 and the weights at two steps' moves in opposite
# directions (4e-5). Measured on an H100: 1.542e-05.
CPU_STEPS, CPU_BATCH = 2, 32
CPU_NLL_RTOL1, CPU_NLL_RTOL, CPU_PARAM_ATOL = 1e-5, 1e-4, 4e-5
# Step 15: the render phase at the FLAME 2019 sizes on the synthetic head (the
# real model is not redistributable): V=5023, 300 shape + 100 expression
# components, 36 pose correctives, 5 joints; 2048x1024 frames. A segment of
# 100 packed frames (N=76 generated), one face of RENDER_LONG frames (a
# minute at 25 fps), RENDER_FRAMES frames rasterized (4 until step 24 needed
# the time). The host's raster takes one thread a frame (7-17 s a frame on
# the 8-core hosts of the H100 machines measured), so the rasters that time nothing run at once.
RENDER_VERTICES, RENDER_LONG, RENDER_FRAMES = 5023, 1500, 2
# The card's vertices against the CPU path in float64 from the same float32
# inputs: float32 products over 400 components, then a chain of 4x4
# transforms per vertex. The generated side's coefficients (random weights)
# put coordinates at |x| up to about 2.1, where the CPU's own float32 path
# reads 2.0e-06 against float64; the limit keeps 10x headroom for another
# summation order, while a wrong index, joint or blend weight moves vertices
# by 1e-3 or more.
RENDER_VERT_ATOL = 2e-5
# Frames rasterized from the card's vertices against the same frames from
# the float64 vertices. A shade that moved by rounding truncates to the next
# uint8 level anywhere: at most RASTER_LEVEL_SHARE of the pixels may differ
# (the CPU's float32 vertices give 1.4e-02 on these frames, textured). A
# larger difference only where a pixel centre changes triangle: at most
# RASTER_EDGE_SHARE of the pixels (CPU float32: 3.8e-06), each on a visible
# triangle edge (its 3x3 neighbourhood in a face-id render holds another face
# or the background).
RASTER_LEVEL_SHARE, RASTER_EDGE_SHARE = 5e-2, 1e-4
# Step 16: the extraction path. The audio of a 2-minute stereo session at
# 44.1 kHz (10 minutes until steps 18-20 needed the time, 5 until the
# script's time limit did: the traced prosody call records about 9,000
# device operations a minute), to EXTRACT_FPS
# frames; the landmark fit at B=FIT_BATCH on the
# synthetic head at the FLAME 2019 sizes (the real model and its landmark
# embedding are not redistributable), 30 + 60 steps, with targets projected
# from known parameters as tools/flame_fit_probe.py's make_targets projects
# them (seed 3, scale 512, offset 512); LIPSYNC_SECONDS of lipsync meshes at
# LIPSYNC_FPS through the mesh fit with LIPSYNC_STEPS steps; then the CLI's
# stages on two sessions of CLI_SECONDS and the trainer on their corpus.
EXTRACT_FS, EXTRACT_MINUTES, EXTRACT_FPS = 44100, 2, 25
FIT_BATCH, FIT_CPU_BATCH = 256, 64
# CLI_SECONDS of 6 is the least that keeps final_model's B=256: the train
# split's four chunks of 148 frames give 4 x 69 = 276 windows of 80.
LIPSYNC_SECONDS, LIPSYNC_FPS, LIPSYNC_STEPS = 5, 60, 40
CLI_SECONDS, CLI_FS = 6, 16000
# The four participants' landmark fits of the CLI leg at 10 + 20 steps (the
# CLI's 30 + 60 until step 24 needed the time: 34.4 s of step 16).
CLI_FIT_STEPS = (10, 20)
# The card against the CPU path of the same port functions. The energy
# features and the VAD tracks at the CPU tests' limits against the JAX
# package (tests/test_torch_features_audio.py): atol 1e-5. The pitch track
# (30,000 frames at 20 ms) at the same 1e-5, but for at most
# PITCH_OFF_GRID_FRAMES frames, each within what one step of the sinc lag
# grid (PITCH_GRID_STEP samples) moves it: a chosen peak may sit on two grid
# points equal to rounding, which cuFFT and pocketfft round the other way
# (one such frame in a 10-minute session on an H100), and each such
# analysis frame reaches the two track frames interpolated from it; the
# resampled pitch features then within 1e-5 plus what those frames move
# them. MFCC atol 2e-3: over the
# 60,000 frames of this session the two FFT libraries round differently,
# and preemphasis of a 140 Hz voice at 44.1 kHz cancels most of the signal,
# which magnifies that rounding in the log filterbank energies; two H100
# runs read 5.9e-04 and 7.1e-04 (the CPU test's 2e-4 was set on 1-2 s
# signals). The fit's objective value rtol 1e-5 and
# gradient rtol/atol 1e-5 (tests/test_torch_flame_fit.py); whole fits
# (chaotic in float32 beyond a few steps, see that file) by quality: the
# median landmark RMS and the median loss within FIT_QUALITY_RTOL of the
# CPU's at B=FIT_CPU_BATCH.
EXTRACT_MFCC_ATOL, EXTRACT_PROSODY_ATOL, EXTRACT_VAD_ATOL = 2e-3, 1e-5, 1e-5
PITCH_GRID_STEP, PITCH_OFF_GRID_FRAMES = 1.0 / 16, 4
FIT_GRAD_RTOL, FIT_GRAD_ATOL, FIT_QUALITY_RTOL = 1e-5, 1e-5, 0.15


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "plans"):
            fn.plans = dict.fromkeys(fn.plans, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def read_plans() -> dict:
    """The kernels' launches by plan since the last reset_launches:
    cond_gates' "tc" and "simt", sample_gates' "vector" and "tile",
    sample_chain's "whole_steps" and "hsplit", the serial training kernels'
    "walk" and "hsplit"."""
    return {name: dict(fn.plans) for name, fn in kernel_wrappers().items()
            if hasattr(fn, "plans")}


def require_plan(path: str, plans: dict, name: str, plan: str) -> None:
    if plans[name][plan] == 0:
        fail(f"{name}'s {plan} plan was never launched on the {path} path "
             f"(plans {plans[name]})")


def require_launches(path: str, counts: dict, names) -> None:
    for name in names:
        if counts[name] == 0:
            fail(f"{name} kernel was never launched on the {path} path")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check_close(name, got, ref, atol=ATOL, rtol=RTOL):
    """``got`` against ``ref`` in float64, elementwise |got - ref| <= atol +
    rtol * |ref|, on the card where either lies there (the training
    residuals run to 10^8 entries); returns the largest |got - ref|."""
    import torch

    got, ref = torch.as_tensor(got), torch.as_tensor(ref)
    dev = got.device if got.is_cuda else ref.device
    got, ref = got.to(dev, torch.float64), ref.to(dev, torch.float64)
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        fail(f"{name}: max |diff| {err.max().item():.3e} exceeds "
             f"atol {atol} + rtol {rtol}*|ref|")
    return err.max().item()


# Wall seconds of each step, closed by lap() and printed as one line before
# the total: where the script's time limit goes.
STEP_WALL: dict = {}
_LAP = [time.perf_counter()]


def lap(label: str) -> None:
    """Close step ``label``: record and print its wall since the last lap."""
    now = time.perf_counter()
    STEP_WALL[label] = round(now - _LAP[0], 1)
    _LAP[0] = now
    print(f"wall: step {label} {STEP_WALL[label]:.1f} s")


def timed(fn):
    """(fn(), ms of that one call by CUDA events): a plain version timed
    by the run that is checked."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def drift(got, ref) -> dict:
    """Largest |got - ref| of frame 0, of the first SEQ_TIGHT frames and of
    all frames of [N, B, C] sequences."""
    d = (got.double() - ref.double()).abs().amax(dim=(1, 2))
    return {"frame0": d[0].item(), f"first{SEQ_TIGHT}": d[:SEQ_TIGHT].max().item(),
            "all": d.max().item()}


def cond_plans_ms(spec, tw, cs, prec, reps) -> dict:
    """``cond_gates`` on each plan at ``prec`` beside the launcher's, by
    CUDA-graph replay: "simt_original" (the register-staged SIMT tile that
    ran before the gates' redesign), "simt" (the launcher's SIMT tile, the
    staged ring), "tc" (the tensor cores' default tile)."""
    from lets_face_it_tpu_torch.ops import train_kernels as tk

    kws = {"simt_original": {"plan": "simt", "tile": 0},
           "simt": {"plan": "simt", "tile": tk.cond_gates_plan(0)[1]},
           "tc": {"plan": "tc", "tile": tk.cond_gates_plan(1)[1]}}
    return {name: time_ms(graphed(lambda kw=kw: tk.cond_gates(spec, tw, cs, precision=prec,
                                                              **kw)), reps)
            for name, kw in kws.items()}


def f64_rms_check(name, got, ref, ref64) -> dict:
    """A product at "highest" on the tensor cores (3xTF32) against the
    float64 product: its rms from ``ref64`` no larger than the plain float32
    version's (``ref``), over every output of ``got`` and ``ref`` (tuples
    or tensors) -> {"kernel": rms, "plain": rms}."""
    import torch

    if torch.is_tensor(got):
        got, ref, ref64 = (got,), (ref,), (ref64,)

    def rms(xs):
        return math.sqrt(sum((x.double() - r).pow(2).sum().item()
                             for x, r in zip(xs, ref64))
                         / sum(r.numel() for r in ref64))

    read = {"kernel": rms(got), "plain": rms(ref)}
    if not read["kernel"] <= read["plain"]:
        fail(f"{name}: rms from the float64 product {read['kernel']:.4e} exceeds "
             f"the plain float32 version's {read['plain']:.4e}")
    print(f"check {name} at highest against the float64 product: rms "
          f"{read['kernel']:.4e}, plain float32 {read['plain']:.4e}  ok")
    return read


def _device_us(evt) -> float:
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0   # the host operator reports its kernels' time again
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile_summary(name: str, prof, calls: int, wall_ms: float,
                    groups: dict | None = None) -> dict:
    """Device time per call of a ``torch.profiler`` window of ``calls``
    calls (device kernels and copies), the device's idle share against
    ``wall_ms`` per call (1 - device / wall), device operations per call and
    the five largest; with ``groups`` ({group: names}) also the device ms
    per call of the operations whose names hold one of a group's names, and
    of the rest."""
    on_device = [e for e in prof.key_averages() if _device_us(e) > 0]
    if not on_device:
        fail(f"profile {name}: the trace shows no device time")
    device_ms = sum(_device_us(e) for e in on_device) / 1e3 / calls
    top = sorted(on_device, key=_device_us, reverse=True)[:5]
    out = {
        "window": name, "calls": calls, "wall_ms_per_call": wall_ms,
        "device_ms_per_call": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
        "device_ops_per_call": sum(e.count for e in on_device) / calls,
        "top": [{"op": e.key[:60], "ms_per_call": _device_us(e) / 1e3 / calls,
                 "count_per_call": e.count / calls} for e in top],
    }
    if groups:
        ms = dict.fromkeys([*groups, "rest"], 0.0)
        for e in on_device:
            group = next((g for g, names in groups.items()
                          if any(n in e.key for n in names)), "rest")
            ms[group] += _device_us(e) / 1e3 / calls
        out["groups_ms_per_call"] = ms
    return out


def trace_window(name: str, fn, calls: int, groups: dict | None = None) -> dict:
    """Host wall time per call of ``calls`` synchronised calls of ``fn`` (no
    profiler: its own cost per operation is large), then as many again under
    ``torch.profiler``, summarised by ``profile_summary`` (with ``groups``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return profile_summary(name, prof, calls, wall_ms, groups)


class LoopTrace:
    """A ``step_hook`` for ``train()`` that leaves the loop unsynchronised:
    it keeps each step's metrics as tensors and synchronises only at the
    window ends. After ``warm`` steps it times ``n`` steps by the host clock,
    then traces the next ``n`` under ``torch.profiler``: the traced steps'
    device time over their own wall time (profiler included) is the loop's
    idle share."""

    def __init__(self, warm: int, n: int):
        self.warm, self.n = warm, n
        self.metrics, self.marks, self.prof = [], {}, None

    @property
    def max_steps(self) -> int:
        return self.warm + 2 * self.n

    def __call__(self, step, m):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.metrics.append(m)
        if step in (self.warm, self.warm + self.n, self.max_steps):
            torch.cuda.synchronize()
            self.marks[step] = time.perf_counter()
        if step == self.warm + self.n:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif step == self.max_steps:
            self.prof.__exit__(None, None, None)

    def summary(self, name: str) -> dict:
        w, n, t = self.warm, self.n, self.marks
        timed_ms = (t[w + n] - t[w]) * 1e3 / n
        traced_ms = (t[w + 2 * n] - t[w + n]) * 1e3 / n
        out = profile_summary(name, self.prof, n, traced_ms)
        out["untraced_wall_ms_per_step"] = timed_ms
        out["idle_share_vs_untraced"] = 1.0 - out["device_ms_per_call"] / timed_ms
        return out


@contextlib.contextmanager
def plain_paths(seqglow):
    """``seqglow.sequence_nll`` and ``sequence_sample`` on their plain routes
    (``flow.frame_fwd`` and ``flow.frame_rev`` frame by frame, no kernel)
    while the block runs."""
    saved = seqglow.training_path, seqglow.sampling_path
    seqglow.training_path = seqglow.sampling_path = lambda spec: "plain"
    try:
        yield
    finally:
        seqglow.training_path, seqglow.sampling_path = saved


# ---------------------------------------------------------------------------
# Work counts for the bounds (each input read once, each output written once)
# ---------------------------------------------------------------------------

def _row_step_flops(spec) -> int:
    """FLOPs of one reversed flow step for one batch row (FMA = 2)."""
    c, z1, h = spec.channels, spec.z1_dim, spec.hidden_channels
    cout, cond = spec.coupling_out_dim, spec.cond.cond_dim
    matmul = 2 * ((z1 + cond) * 3 * h + h * 3 * h + h * cout + c * c)
    pointwise = cond + 12 * h + 6 * (cout // 2) + 2 * c
    return matmul + pointwise


# The sampling weights that are product operands: a set rounded to bf16 for
# "medium" holds them at 2 bytes (``flow_kernels.round_sampling_weights``);
# the biases and the actnorm stay float32.
PRODUCT_WEIGHTS = ("w_ih_t", "w_hh_t", "out_w_t", "w_inv")


def _weight_bytes(weights, weight_bytes: int = 4) -> int:
    """Bytes of the flow's sampling weights, each once (``chain`` is a
    re-laid copy of some of the others, ``flow_kernels.chain_weights``),
    the products' operands at ``weight_bytes`` each."""
    return sum(t.numel() * (weight_bytes if n in PRODUCT_WEIGHTS else 4)
               for n, t in weights._asdict().items() if n not in ("chain", "mode"))


def weights64(weights):
    """A sampling weight set in float64 (the plain versions' other twin)."""
    return weights._replace(**{n: t.double() for n, t in weights._asdict().items()
                               if n != "mode"})


def frame_bound_ms(spec, weights, b: int, peak=PEAK_F32_FLOP_S, weight_bytes=4):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    io = 4 * (b * c + k * b * spec.cond.cond_dim + k * b * h      # inputs
              + b * c + k * b * h)                                 # outputs
    return _bound(_weight_bytes(weights, weight_bytes) + io,
                  b * k * _row_step_flops(spec), peak)


def seq_bound_ms(spec, weights, n: int, b: int, peak=PEAK_F32_FLOP_S, weight_bytes=4):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    p1, cond = spec.cond.p1_face.out_dim, spec.cond.cond_dim
    w_bytes = _weight_bytes(weights, weight_bytes) + k * p1 * cond * weight_bytes
    io = 4 * (n * b * c + n * k * b * cond + b * p1 + k * b * h   # inputs
              + n * b * c)                                         # output
    flops = n * b * k * (_row_step_flops(spec) + 2 * p1 * cond)
    return _bound(w_bytes + io, flops, peak)


def gates_bound_ms(spec, b: int, p1: int, peak=PEAK_F32_FLOP_S, weight_bytes=4):
    """One frame's gates: proj (P1 > 0), gc and gh for all K steps; the
    products' weights at ``weight_bytes`` each."""
    k, h, cond = spec.n_steps, spec.hidden_channels, spec.cond.cond_dim
    g = 3 * h
    w_bytes = k * ((p1 * cond + cond * g + h * g) * weight_bytes + 2 * g * 4)
    io = k * b * cond + b * p1 + k * b * h + (k * b * cond if p1 else 0) + 2 * k * b * g
    flops = 2 * b * k * (p1 * cond + cond * g + h * g)
    return _bound(w_bytes + 4 * io, flops, peak)


def chain_bound_ms(spec, weights, b: int, p1: int, peak=PEAK_F32_FLOP_S,
                   weight_bytes=4):
    """One frame's serial chain: its resident weights read once (the
    products' at ``weight_bytes`` each), the gates and states in, x, the
    states and the history out."""
    k, c, z1, h = spec.n_steps, spec.channels, spec.z1_dim, spec.hidden_channels
    cout, g = spec.coupling_out_dim, 3 * spec.hidden_channels
    io = b * c + 2 * k * b * g + k * b * h + b * p1 + b * c + k * b * h + b * p1
    products = k * (z1 * g + h * cout + c * c)
    w_bytes = 4 * weights.chain.numel() - (4 - weight_bytes) * products
    matmul = 2 * (z1 * g + h * cout + c * c)
    pointwise = 12 * h + 6 * (cout // 2) + 2 * c
    return _bound(w_bytes + 4 * io, b * k * (matmul + pointwise), peak)


# ---------------------------------------------------------------------------
# Library yardsticks: the same function as ATen calls (torch.gru_cell,
# torch.addmm), replayed from one CUDA graph. Timed here only.
# ---------------------------------------------------------------------------

def library_step(spec, w, gru, k, z, proj, h):
    import torch
    import torch.nn.functional as F

    z1d, half = spec.z1_dim, spec.coupling_out_dim // 2
    z1 = z[:, :z1d]
    h_new = torch.gru_cell(torch.cat([z1, F.leaky_relu(proj, 0.01)], -1), h,
                           gru["w_ih"][k], gru["w_hh"][k], gru["b_ih"][k],
                           gru["b_hh"][k])
    hout = torch.addmm(w.out_b[k], h_new, w.out_w_t[k])
    scale = torch.sigmoid(hout[:, half:] + 2.0).clamp_min(spec.scale_eps)
    z = torch.cat([z1, z[:, z1d:] / scale - hout[:, :half]], -1) @ w.w_inv[k]
    return z * w.an_neg_logs_exp[k] - w.an_bias[k], h_new


def library_frame_rev(spec, w, gru, z, cond_projs, states):
    import torch

    new = torch.empty_like(states)
    for k in reversed(range(spec.n_steps)):
        z, new[k] = library_step(spec, w, gru, k, z, cond_projs[k], states[k])
    return z, new


def library_seq_rev(spec, w, gru, w_p1_t, zs, fixed, hist, states0):
    import torch

    c = spec.channels
    states = states0.clone()
    xs = []
    for t in range(zs.shape[0]):
        z = zs[t]
        for k in reversed(range(spec.n_steps)):
            proj = torch.addmm(fixed[t, k], hist, w_p1_t[k])
            z, states[k] = library_step(spec, w, gru, k, z, proj, states[k])
        xs.append(z)
        hist = torch.cat([hist[:, c:], z], -1)
    return torch.stack(xs)


def library_gates(spec, w, w_p1_t, fixed, hist, states):
    """The gates as three batched cuBLAS products."""
    import torch
    import torch.nn.functional as F

    proj = fixed
    if hist.shape[-1]:
        proj = torch.baddbmm(fixed, hist.expand(spec.n_steps, -1, -1), w_p1_t)
    gc = torch.baddbmm(w.b_ih[:, None], F.leaky_relu(proj, 0.01),
                       w.w_ih_t[:, spec.z1_dim:])
    return proj, gc, torch.baddbmm(w.b_hh[:, None], states, w.w_hh_t)


def _bwd_row_step_flops(spec) -> int:
    """FLOPs of one backward step for one row: the recomputed forward step,
    the four transposed products and the gate cotangents."""
    c, z1, h, cout = (spec.channels, spec.z1_dim, spec.hidden_channels,
                      spec.coupling_out_dim)
    matmul = 2 * (cout * h + 3 * h * h + 3 * h * z1 + c * c)
    pointwise = 30 * h + 10 * (cout // 2) + 2 * c
    return _row_step_flops(spec) + matmul + pointwise


def _bound(n_bytes, flops, peak=PEAK_F32_FLOP_S):
    """(ms, what bounds it): the larger of ``n_bytes`` at the memory's
    rate and ``flops`` at ``peak`` (float32 FMA, or a reduced precision's
    tensor-core rate)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def train_fwd_bound_ms(spec, tw, n: int, b: int, peak=PEAK_F32_FLOP_S):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    half, cond = spec.coupling_out_dim // 2, spec.cond.cond_dim
    w_bytes = sum(t.numel() for t in tw) * 4
    io = 4 * (n * b * c + n * k * b * cond + k * b * h                  # inputs
              + n * b * c + n * k * b * (half + c + h))                   # outputs
    return _bound(w_bytes + io, n * b * k * _row_step_flops(spec), peak)


def train_serial_bound_ms(spec, n: int, b: int):
    """The serial chain of the forward alone (seq_fwd.cu after cond_gates):
    its weights (w_hh, W, w_ih[:Z1], out_w and the vectors), xs, gc and the
    states in; z, the scales and the two residual stacks out; the products
    but the conditioning one."""
    k, c, z1, h = spec.n_steps, spec.channels, spec.z1_dim, spec.hidden_channels
    cout, g = spec.coupling_out_dim, 3 * spec.hidden_channels
    half = cout // 2
    w_floats = k * (h * g + c * c + z1 * g + h * cout + g + cout + 2 * c)
    io = (n * b * c + n * k * b * g + k * b * h                        # inputs
          + n * b * c + n * k * b * (half + c + h))                      # outputs
    flops = 2 * (h * g + c * c + z1 * g + h * cout) + 12 * h + 6 * half + 2 * c
    return _bound(4 * (w_floats + io), n * b * k * flops)


def train_bwd_bound_ms(spec, tw, n: int, b: int, peak=PEAK_F32_FLOP_S):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    half, cond, cout = spec.coupling_out_dim // 2, spec.cond.cond_dim, spec.coupling_out_dim
    w_bytes = (sum(t.numel() for t in tw)
               + k * (c * c + 3 * h * h + 3 * h * spec.z1_dim + cout * h)) * 4
    io = 4 * (n * b * c + n * k * b * (half + c + h + cond) + k * b * h  # inputs
              + n * b * c + k * b * h + n * k * b * (3 * h + h + cout + c))  # outputs
    return _bound(w_bytes + io, n * b * k * _bwd_row_step_flops(spec), peak)


def cond_gates_bound_ms(spec, n: int, b: int, peak=PEAK_F32_FLOP_S):
    """The conditioning gates of every frame and step: [N*B, cond] @
    [cond, 3H] per step, cond read, weights and bias read, gc written."""
    k, cond, g = spec.n_steps, spec.cond.cond_dim, 3 * spec.hidden_channels
    n_bytes = 4 * (n * k * b * cond + k * (cond + 1) * g + n * k * b * g)
    return _bound(n_bytes, 2 * n * b * k * cond * g, peak)


def face_id_frames(verts_l, verts_r, faces, width: int, height: int):
    """[T, H, W] the visible face of ``render_double_face_frames``'s scene
    (faces of the left head, then of the right; -1 for the background): each
    face drawn with vertices of its own in a colour that encodes its index,
    unlit (ambient 1, no lights), so that every covered pixel reads back its
    face's index exactly."""
    import numpy as np

    from lets_face_it_tpu_torch.render.rasterizer import Rasterizer
    from lets_face_it_tpu_torch.render.video import FACE_SHIFT

    n_faces = faces.shape[0]
    ids = np.arange(2 * n_faces)
    rgb = np.stack([(ids >> 16) & 255, (ids >> 8) & 255, ids & 255], axis=1)
    colors = np.repeat((rgb + 0.5) / 255.0, 3, axis=0).astype(np.float32)
    corners = faces.reshape(-1)
    verts = np.concatenate([verts_l[:, corners], verts_r[:, corners]], axis=1)
    verts[:, :3 * n_faces, 0] -= FACE_SHIFT
    verts[:, 3 * n_faces:, 0] += FACE_SHIFT
    raster = Rasterizer(width=width, height=height, x=width // 2, y=400, z=-1,
                        f=(4754.97941935, 4754.97941935), ambient=1.0, lights=[])
    img = raster.render([(np.ascontiguousarray(verts, np.float32),
                          np.arange(6 * n_faces, dtype=np.int32).reshape(-1, 3),
                          colors)]).astype(np.int64)
    face = (img[..., 0] << 16) | (img[..., 1] << 8) | img[..., 2]
    return np.where(face == 0xFFFFFF, -1, face)


def visible_edges(ids):
    """[T, H, W] True where a pixel's 3x3 neighbourhood holds another face
    (or the background) than the pixel's own."""
    import numpy as np

    pad = np.pad(ids, ((0, 0), (1, 1), (1, 1)), mode="edge")
    h, w = ids.shape[1:]
    edge = np.zeros(ids.shape, bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            edge |= pad[:, dy:dy + h, dx:dx + w] != ids
    return edge


def render_checks(gen, tmp, dev) -> dict:
    """Step 15's path and checks on ``dev``: ``stimulus.render_segment`` with
    the port's ``Generator`` (one ``seq_rev`` call) and its FLAME decoder on
    the synthetic head, the mp4 write swapped for a stand-in that keeps what
    it is handed; the two faces again as a POST hands them to
    ``RenderService.get_vertices``; one RENDER_LONG-frame face; all held
    against the float64 CPU path; RENDER_FRAMES frames of the pair through
    the raster stage held against those of the float64 vertices, then
    written as an mp4 where OpenCV imports. Returns what the timings reuse
    and the readings."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch import stimulus
    from lets_face_it_tpu_torch.render import flame, video
    from lets_face_it_tpu_torch.render.server import RenderService, byteify, debyteify
    from lets_face_it_tpu_torch.utils.native import load_library

    rng = np.random.default_rng(SEED + 15)
    head = flame.synthetic_flame_model(RENDER_VERTICES, seed=SEED, device=dev)
    head64 = flame.synthetic_flame_model(RENDER_VERTICES, seed=SEED, device="cpu",
                                         dtype=torch.float64)
    t_pad = gen.hp.Validation["seq_len"]
    padded = rng.standard_normal((t_pad, 273)).astype(np.float32)
    n = t_pad - gen.spec.cond.longest_history
    frames = padded[-n:]
    info = {"left_gender": "female", "right_gender": "male",
            "left_shape": rng.standard_normal(300).tolist(),
            "right_shape": rng.standard_normal(300).tolist(),
            "left_skin_color": "white", "right_skin_color": "black"}

    handed, generated = [], []

    def mp4_stand_in(file_name, vertices, vertices2, faces, **kwargs):
        handed.append((vertices, vertices2, kwargs))
        Path(file_name).write_bytes(b"")
        return file_name

    generate = gen.generate

    def keep_generated(packed):
        generated.append(generate(packed))
        return generated[-1]

    stimulus.render_double_face_video, gen.generate = mp4_stand_in, keep_generated
    reset_launches()
    t0 = time.perf_counter()
    try:
        stimulus.render_segment(gen, head, frames, padded, "S1", "segment.mp4",
                                Path(tmp) / "stimuli", info, 2.0, 1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        stimulus.render_double_face_video = video.render_double_face_video
        del gen.generate
    segment_s = time.perf_counter() - t0
    launches = read_launches()
    (v_left, v_right, kwargs), = handed
    kwargs = {k: v for k, v in kwargs.items() if k != "fps"}
    if v_left.device.type != dev.type or v_left.shape != (n, RENDER_VERTICES, 3):
        fail(f"render_segment handed vertices {tuple(v_left.shape)} on {v_left.device}")

    # the two faces as a POST of the byte protocol carries them: left ground
    # truth (p1 talks more, so p1 sits left), right generated
    def request(face, shape, rows):
        pose = np.zeros((rows, 12), np.float32)
        pose[:, :3], pose[:, 3:6] = face["neck"][-rows:], face["jaw"][-rows:]
        return {"expression": byteify(np.asarray(face["expression"][-rows:], np.float32)),
                "pose": byteify(pose),
                "shape": byteify(np.repeat(np.asarray(shape, np.float32)[None], rows, 0)),
                "rotation": byteify(np.zeros((rows, 3), np.float32))}

    pred = generated[0][0]
    faces_pair = [request(stimulus.face_block(frames, 0), info["left_shape"], n),
                  request({"expression": pred[:, :50], "jaw": pred[:, 100:103],
                           "neck": pred[:, 103:106]}, info["right_shape"], n)]
    rows = RENDER_LONG
    face_long = request({"expression": 0.5 * rng.standard_normal((rows, 50)),
                         "jaw": 0.2 * rng.standard_normal((rows, 3)),
                         "neck": 0.2 * rng.standard_normal((rows, 3))},
                        info["left_shape"], rows)
    face_long["rotation"] = byteify((0.1 * rng.standard_normal((rows, 3))).astype(np.float32))
    service = RenderService(head, video_dir=Path(tmp) / "videos", device=dev)

    def reference(face):
        f = {k: torch.from_numpy(debyteify(face, k)).double() for k in face}
        return flame.get_vertices(head64, f["expression"], f["pose"], f["rotation"],
                                  shape=f["shape"])

    errs = {}
    served = [service.get_vertices(f) for f in faces_pair]
    refs = [reference(f) for f in faces_pair]
    for side, seg_v, got, ref in zip(("left", "right"), (v_left, v_right), served, refs):
        errs[f"{side}_vs_render_segment"] = check_close(
            f"RenderService.get_vertices {side} N={n} vs render_segment's",
            got, seg_v, atol=RENDER_VERT_ATOL, rtol=0.0)
        errs[f"{side}_vs_cpu_f64"] = check_close(
            f"RenderService.get_vertices {side} N={n} vs the CPU float64 path",
            got, ref, atol=RENDER_VERT_ATOL, rtol=0.0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    long_v = service.get_vertices(face_long)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
    errs[f"long_n{rows}_vs_cpu_f64"] = check_close(
        f"RenderService.get_vertices N={rows} vs the CPU float64 path", long_v,
        reference(face_long), atol=RENDER_VERT_ATOL, rtol=0.0)
    max_abs = max(r.abs().max().item() for r in refs)
    print(f"check render vertices (V={RENDER_VERTICES}, |x| <= {max_abs:.3f}; atol "
          f"{RENDER_VERT_ATOL}): {json.dumps(errs)}  ok")

    # the raster stage: the card's vertices against the float64 vertices
    k = RENDER_FRAMES
    ref_l, ref_r = (r[:k].float().numpy() for r in refs)
    load_library("rasterizer")      # built at first use: not in the raster's time
    t0 = time.perf_counter()
    imgs = video.render_double_face_frames(v_left[:k], v_right[:k], head.faces, **kwargs)
    raster_ms = (time.perf_counter() - t0) * 1e3 / k
    # the host's other rasters time nothing but the mp4 write's wall: the
    # face ids, the float64 vertices' frames and the mp4 write run at once,
    # each in a thread (one raster thread a frame; the native call releases
    # the GIL)
    has_cv2 = importlib.util.find_spec("cv2") is not None
    mp4_path = Path(tmp) / "segment.mp4"

    def write_mp4():
        t0 = time.perf_counter()
        video.render_double_face_video(mp4_path, v_left[:k], v_right[:k], head.faces,
                                       fps=25, **kwargs)
        return time.perf_counter() - t0

    mp4_done = in_thread(write_mp4) if has_cv2 else None
    ids_done = in_thread(face_id_frames, ref_l, ref_r, head.faces, 2048, 1024)
    ref_imgs = video.render_double_face_frames(ref_l, ref_r, head.faces, **kwargs)
    ids = ids_done()
    if imgs.shape != (k, 1024, 2048, 3):
        fail(f"raster stage: images {imgs.shape}")
    diff = (imgs != ref_imgs).any(-1)
    big = np.abs(imgs.astype(np.int16) - ref_imgs.astype(np.int16)).max(-1) > 1
    off_edge = int((big & ~visible_edges(ids)).sum())
    share, big_share = float(diff.mean()), float(big.mean())
    if share > RASTER_LEVEL_SHARE or big_share > RASTER_EDGE_SHARE or off_edge:
        fail(f"raster stage: {share:.3e} of pixels differ (limit {RASTER_LEVEL_SHARE}), "
             f"{big_share:.3e} by more than one level (limit {RASTER_EDGE_SHARE}), "
             f"{off_edge} of those off a visible triangle edge")
    coverage = float((ids >= 0).mean())
    print(f"check raster stage, {k} frames 2048x1024 (textured): {share:.3e} of "
          f"pixels differ from the float64 vertices' frames (limit "
          f"{RASTER_LEVEL_SHARE}), {big_share:.3e} by more than one level (limit "
          f"{RASTER_EDGE_SHARE}), all on visible triangle edges; the heads cover "
          f"{coverage:.4f} of a frame  ok")
    # the mp4 write where OpenCV is installed (GPU hosts may lack it)
    mp4 = None
    if not has_cv2:
        print("render: the mp4 write (cv2.VideoWriter) is left out: cv2 is not "
              "installed here; the CPU tests cover it (tests/test_torch_render.py)")
    else:
        import cv2

        path = mp4_path
        mp4_s = mp4_done()
        cap = cv2.VideoCapture(str(path))
        try:
            count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            read, frame = cap.read()
        finally:
            cap.release()
        if count != k or not read or frame.shape != (1024, 2048, 3):
            fail(f"render_double_face_video: {count} frames, first read {read}")
        mp4 = {"frames": count, "bytes": path.stat().st_size, "wall_s": mp4_s}
        print(f"check render_double_face_video: {k} frames rasterized and written "
              f"as mp4 in {mp4_s:.3f} s beside the two reference rasters "
              f"({mp4['bytes']} bytes), read back with "
              f"{count} frames of 2048x1024  ok")
    return {"service": service, "head": head, "faces_pair": faces_pair,
            "face_long": face_long, "kwargs": kwargs, "v_pair": (v_left, v_right),
            "launches": launches, "readings": {
                "segment_frames": n, "segment_wall_s": segment_s, "max_abs_err": errs,
                "raster_diff_share": share, "raster_diff_over_one_level_share": big_share,
                "coverage": coverage, "raster_ms_per_frame": raster_ms, "mp4": mp4,
                "long_call_peak_bytes": peak}}


def render_times(checked, card: str) -> dict:
    """Step 15's times on the card: the mesh stage (``RenderService.get_vertices``
    from a request's blobs, and the decoder alone on tensors already on the
    card) at N=76 and N=RENDER_LONG by CUDA events, and a profile window of
    the long call."""
    import torch

    from lets_face_it_tpu_torch.render import flame
    from lets_face_it_tpu_torch.render.server import debyteify

    service, head = checked["service"], checked["head"]
    out = {}
    for face, reps in ((checked["faces_pair"][1], 10), (checked["face_long"], 5)):
        rows = len(debyteify(face, "expression"))
        t = {k: torch.from_numpy(debyteify(face, k)).to(service.device) for k in face}
        served = time_ms(lambda: service.get_vertices(face), reps)
        decoder = time_ms(lambda: flame.get_vertices(
            head, t["expression"], t["pose"], t["rotation"], shape=t["shape"]), reps)
        out[f"mesh_n{rows}"] = {"get_vertices_ms": served, "decoder_ms": decoder}
        print(f"render mesh stage N={rows} V={RENDER_VERTICES} on {card}: "
              f"RenderService.get_vertices {served:.3f} ms (blobs decoded on the host, "
              f"uploaded, decoded on the card), the decoder alone {decoder:.3f} ms "
              f"(CUDA events, {reps} calls)")
    window = trace_window(f"render_get_vertices_n{RENDER_LONG}",
                          lambda: service.get_vertices(checked["face_long"]), 3)
    print(json.dumps(window))
    out["trace_long"] = window
    return out


def session_audio(rng, fs: int, seconds: float, f_base: float, turn_s: float,
                  first: bool):
    """One channel of a dyadic session: a voice whose f0 glides around
    ``f_base`` (as tests/test_integration_pipeline.py builds its audio) that
    speaks every other turn of ``turn_s`` seconds (the first turn when
    ``first``) and is heard at 3 % as crosstalk in the others, plus noise."""
    import numpy as np

    t = np.arange(int(fs * seconds)) / fs
    phase = 2 * np.pi * (f_base + 40 * np.sin(2 * np.pi * 0.2 * t)) * t
    gain = np.where(((t // turn_s) % 2 == 0) == first, 0.3, 0.009).astype(np.float32)
    voice = np.sin(phase).astype(np.float32) * gain
    return voice + 0.01 * rng.standard_normal(t.shape, dtype=np.float32)


def extract_audio_checks(dev, card) -> dict:
    """Step 16's audio: a 2-minute stereo session through
    ``extract_prosodic_features`` (traced), ``extract_mfcc_to_frames`` and
    ``crosstalk_vad`` on the card, each held against the same function on
    the CPU; seconds per minute of audio and Viterbi's share of prosody."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch.features import mfcc, prosody, vad

    rng = np.random.default_rng(SEED + 16)
    fs, seconds = EXTRACT_FS, 60 * EXTRACT_MINUTES
    nb = int(seconds * EXTRACT_FPS)
    t0 = time.perf_counter()
    x1 = session_audio(rng, fs, seconds, 140.0, 7.0, True)
    x2 = session_audio(rng, fs, seconds, 210.0, 7.0, False)
    gen_s = time.perf_counter() - t0

    def one_call(fn):
        """(output, host seconds) of one synchronised call after a warm one."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    card_out = {}

    def run_prosody():
        card_out["prosody"] = prosody.extract_prosodic_features(x1, fs, nb,
                                                                device=dev)

    window = trace_window(f"extract_prosodic_features_{EXTRACT_MINUTES}min", run_prosody, 1)
    print(json.dumps(window))
    prosody_s = window["wall_ms_per_call"] / 1e3
    freqs, strengths, _ = prosody.pitch_candidates(x1, fs=fs, time_step=0.02,
                                                   device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prosody.viterbi_pitch(freqs, strengths)     # ends in a copy to the host
    viterbi_s = time.perf_counter() - t0
    mfcc_card, mfcc_s = one_call(lambda: mfcc.extract_mfcc_to_frames(
        x1 * 32768.0, fs, nb, device=dev))
    vad_card, vad_s = one_call(lambda: vad.crosstalk_tracks(x1, x2, fs, nb, device=dev))
    bin_card = vad.crosstalk_vad(x1, x2, fs, nb, device=dev)

    tracks_card = prosody.compute_prosody(x1, fs, 0.02, device=dev)
    t0 = time.perf_counter()
    prosody_cpu = prosody.extract_prosodic_features(x1, fs, nb, device="cpu")
    mfcc_cpu = mfcc.extract_mfcc_to_frames(x1 * 32768.0, fs, nb, device="cpu")
    vad_cpu = vad.crosstalk_tracks(x1, x2, fs, nb, device="cpu")
    cpu_s = time.perf_counter() - t0
    tracks_cpu = prosody.compute_prosody(x1, fs, 0.02, device="cpu")
    pitch_diff, energy_diff = ((c.cpu() - h).abs() for c, h in zip(tracks_card, tracks_cpu))
    off_grid = int((pitch_diff > EXTRACT_PROSODY_ATOL).sum())
    by_channel = (card_out["prosody"].cpu() - prosody_cpu).abs().amax(dim=0).tolist()
    errs = {"pitch_track": pitch_diff.max().item(), "pitch_track_frames": len(pitch_diff),
            "pitch_track_off_grid_frames": off_grid,
            "energy_track": energy_diff.max().item(), "prosody_by_channel": by_channel,
            "mfcc": (mfcc_card.cpu() - mfcc_cpu).abs().max().item()}
    print(f"extract audio card vs CPU (before the checks): {json.dumps(errs)}")
    # a frame whose lag moved one grid step moves log(f0 + 1) by at most
    # PITCH_GRID_STEP / lag at the shortest lag, fs / 600 Hz; the resampling
    # to the video frames moves no output by more than the sum of its input
    # moves, and the derivative takes each input move twice over the 20 ms
    # step; a voicing decision taken the other way would move a frame by ~1
    pitch_atol = PITCH_GRID_STEP / (fs / prosody.PITCH_CEILING)
    if not (energy_diff.max() <= EXTRACT_PROSODY_ATOL
            and off_grid <= PITCH_OFF_GRID_FRAMES and pitch_diff.max() <= pitch_atol):
        fail(f"compute_prosody card vs CPU: energy max|diff| {errs['energy_track']:.3e} "
             f"(limit {EXTRACT_PROSODY_ATOL}); pitch max|diff| {errs['pitch_track']:.3e} "
             f"(limit {pitch_atol:.3e}) in {off_grid} frames beyond "
             f"{EXTRACT_PROSODY_ATOL} (limit {PITCH_OFF_GRID_FRAMES})")
    limits = [EXTRACT_PROSODY_ATOL, EXTRACT_PROSODY_ATOL,
              EXTRACT_PROSODY_ATOL + off_grid * pitch_atol,
              EXTRACT_PROSODY_ATOL + off_grid * 2 * pitch_atol / 20.0]
    for ch, (err, limit) in enumerate(zip(by_channel, limits)):
        if not err <= limit:
            fail(f"extract_prosodic_features channel {ch}: max|diff| {err:.3e} from "
                 f"the CPU's exceeds {limit:.3e}")
    check_close("extract_mfcc_to_frames card vs CPU", mfcc_card, mfcc_cpu,
                EXTRACT_MFCC_ATOL, 0.0)
    for i, (card_t, cpu_t, binary) in enumerate(zip(vad_card, vad_cpu, bin_card)):
        errs[f"vad_track{i + 1}"] = check_close(f"crosstalk_tracks {i + 1}", card_t,
                                                cpu_t, EXTRACT_VAD_ATOL, 0.0)
        clear = (cpu_t - 0.1).abs() > 1e-3
        if not torch.equal(binary.cpu()[clear], (cpu_t >= 0.1).float()[clear]):
            fail(f"crosstalk_vad {i + 1}: the binary track differs from the CPU's")
    active = [float(b.mean()) for b in bin_card]
    minutes = seconds / 60
    out = {"audio_minutes": minutes, "fs": fs, "frames": nb,
           "s_per_audio_minute": {"prosody": prosody_s / minutes,
                                  "mfcc": mfcc_s / minutes, "vad": vad_s / minutes},
           "viterbi_s": viterbi_s, "viterbi_share_of_prosody": viterbi_s / prosody_s,
           "vad_active_share": active, "signal_s": gen_s,
           "cpu_reference_s": cpu_s, "max_abs_err_vs_cpu": errs,
           "prosody_trace": window}
    print(f"extract audio: {minutes:g} min of {fs / 1e3:g} kHz stereo to {nb} frames on "
          f"{card}: prosody {prosody_s / minutes:.4f} s per audio minute (Viterbi "
          f"{viterbi_s:.3f} s of the call's {prosody_s:.3f} s, "
          f"{viterbi_s / prosody_s:.3f}), MFCC {mfcc_s / minutes:.4f}, VAD "
          f"{vad_s / minutes:.4f}; against the CPU: pitch track off grid in "
          f"{off_grid} of {len(pitch_diff)} frames, features within {limits} "
          f"by channel, MFCC within "
          f"{EXTRACT_MFCC_ATOL}, VAD tracks within {EXTRACT_VAD_ATOL}; VAD active "
          f"{active}  ok")
    return out


def probe_targets(model, emb, n: int, seed: int = 3):
    """Landmarks of random ground-truth parameters, projected at scale 512
    and offset 512 (tools/flame_fit_probe.py's make_targets, the same draws
    in the same order), as numpy."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch.features import flame_fit

    rng = np.random.default_rng(seed)
    gt = {"trans": rng.normal(0, 0.05, (n, 3)), "rot": rng.normal(0, 0.1, (n, 3)),
          "pose": np.zeros((n, 12)), "shape": rng.normal(0, 0.3, (n, 300)),
          "exp": rng.normal(0, 0.3, (n, 100))}
    gt = {k: torch.as_tensor(v, dtype=torch.float32, device=model.device)
          for k, v in gt.items()}
    with torch.no_grad():
        return (512.0 * flame_fit.model_landmarks(model, emb, gt)[..., :2]
                + 512.0).cpu().numpy()


def landmark_rms(model, emb, params, targets):
    """Per-frame RMS (px) of the fitted landmarks against the targets."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch.features import flame_fit

    with torch.no_grad():
        lmks = flame_fit.model_landmarks(model, emb, params)
        proj = (params["scale"][:, None, None] * lmks[..., :2]).cpu().numpy()
    return np.sqrt(((proj - targets) ** 2).sum(-1).mean(-1))


def extract_fit_checks(dev, card) -> dict:
    """Step 16's fits on the synthetic head at FLAME 2019 sizes: ``fit_batch``
    at B=FIT_BATCH (frames/s, landmark RMS, evaluations a step) and a
    traced window of 2 + 2 steps; at B=FIT_CPU_BATCH the objective's value
    and gradient and then whole fits against the CPU; ``estimate_init`` and a fit seeded by it; the lipsync
    meshes of LIPSYNC_SECONDS through ``fit_to_vertices``."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch.features import flame_fit, lipsync, ringnet_lite
    from lets_face_it_tpu_torch.render import flame

    head = flame.synthetic_flame_model(RENDER_VERTICES, seed=0, device=dev)
    emb = flame_fit.synthetic_landmark_embedding(head, 51, seed=2)
    targets = probe_targets(head, emb, FIT_BATCH)
    flame_fit.fit_batch(head, emb, targets[:8], stage1_steps=1, stage2_steps=1)

    def fit(init=None, n=FIT_BATCH, model=head, embedding=emb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses, evals = flame_fit.fit_batch(model, embedding, targets[:n], init)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rms = landmark_rms(model, embedding, params, targets[:n])
        return params, losses.cpu().numpy(), rms, wall, evals

    _, losses, rms, fit_s, (e1, e2) = fit()
    steps = 30 + 60
    window = trace_window(f"fit_batch_b{FIT_BATCH}_2+2_steps", lambda: flame_fit.fit_batch(
        head, emb, targets, stage1_steps=2, stage2_steps=2), 1)
    print(json.dumps(window))
    fit_reading = {"batch": FIT_BATCH, "wall_s": fit_s, "frames_per_s": FIT_BATCH / fit_s,
                   "rms_px_median": float(np.median(rms)),
                   "rms_px_p95": float(np.percentile(rms, 95)),
                   "loss_median": float(np.median(losses)),
                   "evals": [e1, e2], "line_search_evals_per_step": (e1 + e2 - steps) / steps,
                   "trace_2_2_steps": window}
    print(f"extract fit: fit_batch B={FIT_BATCH}, 30 + 60 steps, V={RENDER_VERTICES} on "
          f"{card}: {fit_s:.3f} s = {FIT_BATCH / fit_s:.1f} frames/s; landmark RMS "
          f"median {fit_reading['rms_px_median']:.3f} px, p95 "
          f"{fit_reading['rms_px_p95']:.3f} px; {e1} + {e2} objective evaluations "
          f"({fit_reading['line_search_evals_per_step']:.2f} line-search trials a step)")

    # the card against the CPU at B=FIT_CPU_BATCH: the objective, then fits
    head_cpu = flame.synthetic_flame_model(RENDER_VERTICES, seed=0, device="cpu")
    emb_cpu = flame_fit.synthetic_landmark_embedding(head_cpu, 51, seed=2)
    rng = np.random.default_rng(SEED + 18)
    n = FIT_CPU_BATCH
    point = {"trans": rng.uniform(-0.05, 0.05, (n, 3)), "rot": rng.uniform(-0.3, 0.3, (n, 3)),
             "pose": rng.uniform(-0.2, 0.2, (n, 12)), "shape": rng.normal(0, 0.5, (n, 300)),
             "exp": rng.normal(0, 0.5, (n, 100)), "scale": np.full(n, 512.0)}
    grads = {}
    for where, model, embedding in (("card", head, emb), ("cpu", head_cpu, emb_cpu)):
        rm, re = flame_fit.restrict_to_landmarks(model, embedding)
        p = {k: torch.tensor(v, dtype=torch.float32, device=model.device,
                             requires_grad=True) for k, v in point.items()}
        t = torch.as_tensor(targets[:n], device=model.device)
        loss = flame_fit._lmk_dist(rm, re, p, t) + flame_fit._regularizers(p)
        grads[where] = (loss.detach().cpu(),
                        dict(zip(p, (g.cpu() for g in torch.autograd.grad(loss.sum(),
                                                                        list(p.values()))))))
    value_err = check_close("fit objective card vs CPU", grads["card"][0],
                            grads["cpu"][0], 0.0, FIT_GRAD_RTOL)
    value_err /= grads["cpu"][0].abs().max().item()
    grad_err = max(check_close(f"fit gradient {k} card vs CPU", g, grads["cpu"][1][k],
                               FIT_GRAD_ATOL, FIT_GRAD_RTOL)
                   for k, g in grads["card"][1].items())
    # the card's fits of these frames are those of its B=FIT_BATCH run
    l_card, r_card = losses[:n], rms[:n]
    _, l_cpu, r_cpu, cpu_s, _ = fit(n=n, model=head_cpu, embedding=emb_cpu)
    quality = {"rms_px_median": (float(np.median(r_card)), float(np.median(r_cpu))),
               "loss_median": (float(np.median(l_card)), float(np.median(l_cpu)))}
    for name, (a, b) in quality.items():
        if not abs(a - b) <= FIT_QUALITY_RTOL * b:
            fail(f"fit B={n} {name}: card {a:.4f} vs CPU {b:.4f} (rtol {FIT_QUALITY_RTOL})")
    quality["rms_px_p95"] = (float(np.percentile(r_card, 95)),
                             float(np.percentile(r_cpu, 95)))
    print(f"check fit card vs CPU at B={n}: objective max rel diff {value_err:.3e}, "
          f"gradient max|diff| {grad_err:.3e} (rtol/atol {FIT_GRAD_RTOL}); whole fits "
          f"(card, CPU in {cpu_s:.1f} s): {json.dumps(quality)} (medians within "
          f"{FIT_QUALITY_RTOL})  ok")

    # RingNet-lite, and a fit seeded by it (the init the session driver reads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = ringnet_lite.estimate_init(head, emb, targets)
    torch.cuda.synchronize()
    ringnet_s = time.perf_counter() - t0
    _, l_seed, r_seed, seeded_s, _ = fit(init={k: est[k] for k in ("rot", "shape", "exp")})
    ringnet = {"wall_s": ringnet_s, "frames_per_s": FIT_BATCH / ringnet_s,
               "seeded_fit_wall_s": seeded_s,
               "seeded_rms_px_median": float(np.median(r_seed)),
               "seeded_loss_median": float(np.median(l_seed))}
    print(f"extract ringnet-lite: estimate_init B={FIT_BATCH} {ringnet_s:.3f} s on {card}; "
          f"the fit seeded by it {seeded_s:.3f} s, landmark RMS median "
          f"{ringnet['seeded_rms_px_median']:.3f} px (unseeded "
          f"{fit_reading['rms_px_median']:.3f})")

    # lipsync meshes through the mesh fit
    audio = session_audio(rng, 16000, LIPSYNC_SECONDS, 140.0, 3.0, True)
    lip = lipsync.EnvelopeLipsync(head, out_fps=LIPSYNC_FPS)
    meshes = lip(audio, 16000, head.v_template.cpu().numpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _ = flame_fit.fit_to_vertices(head, meshes, n_steps=LIPSYNC_STEPS)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    with torch.no_grad():
        recon = flame.flame_vertices(head, params["shape"], params["exp"],
                                     params["jaw"], params["neck"]) + params["trans"][:, None]
        err = (recon - torch.as_tensor(meshes, device=dev)).square().sum(-1)
    vertex_rms = float(err.mean().sqrt())
    if not (vertex_rms < 1e-2 and torch.isfinite(err).all()):
        fail(f"fit_to_vertices: vertex RMS {vertex_rms}")
    mesh = {"meshes": int(meshes.shape[0]), "steps": LIPSYNC_STEPS, "wall_s": mesh_s,
            "meshes_per_s": meshes.shape[0] / mesh_s, "vertex_rms": vertex_rms}
    print(f"extract lipsync: {meshes.shape[0]} EnvelopeLipsync meshes (V={RENDER_VERTICES}) "
          f"through fit_to_vertices, {LIPSYNC_STEPS} steps, on {card}: {mesh_s:.3f} s, "
          f"vertex RMS {vertex_rms:.3e}")
    return {"fit": fit_reading, "cpu_check": {"objective_rel": value_err,
                                              "gradient_abs": grad_err, **quality},
            "ringnet": ringnet, "mesh_fit": mesh, "head": head, "emb": emb}


def extract_cli_checks(tmp, dev, card, head, emb, frames) -> dict:
    """Step 16's CLI leg: two sessions of CLI_SECONDS through the CLI's
    audio and voca stages with the synthetic head passed as ``assets``; the
    participants' landmark fits (``fit_participant``, one chunk each,
    CLI_FIT_STEPS) and
    the combiner (``combine_corpus``) in memory; ``final_model`` trains 3
    steps from that corpus, and its checkpoint generates (the
    ``extract_train`` path's launches)."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch import extract_features as cli
    from lets_face_it_tpu_torch.data.windows import WindowDataset, face_means_stds
    from lets_face_it_tpu_torch.features import audio_io, combine, flame_fit
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.render import flame
    from lets_face_it_tpu_torch.sample.generate import Generator
    from lets_face_it_tpu_torch.train import loop as train_loop
    from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager

    root = Path(tmp) / "extract"
    rng = np.random.default_rng(SEED + 17)
    n_frames = CLI_SECONDS * EXTRACT_FPS
    sessions = [root / "S1", root / "S2"]
    for sess in sessions:
        stereo = np.stack([session_audio(rng, CLI_FS, CLI_SECONDS, 140.0, 5.0, True),
                           session_audio(rng, CLI_FS, CLI_SECONDS, 210.0, 5.0, False)], 1)
        audio_io.write_wav(sess / "audio_c1_c2.wav", stereo, CLI_FS)
        for part in ("P1", "P2"):
            d = sess / part
            d.mkdir(parents=True)
            (d / f"frames_{EXTRACT_FPS}fps.txt").write_text(str(n_frames))
            shape = np.repeat(rng.normal(0, 0.3, (1, 300)), n_frames, 0)
            gt = {"trans": rng.normal(0, 0.03, (n_frames, 3)),
                  "rot": rng.normal(0, 0.1, (n_frames, 3)), "pose": np.zeros((n_frames, 12)),
                  "shape": shape, "exp": 0.3 * rng.standard_normal((n_frames, 100))}
            gt = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                  for k, v in gt.items()}
            with torch.no_grad():
                lm = (700.0 * flame_fit.model_landmarks(head, emb, gt)[..., :2]
                      + 512.0).cpu().numpy()
                neutral = flame.neutral_mesh_vertices(head, gt["shape"][:1])
            flame.write_ply(d / "neutral_mesh.ply", neutral, head.faces)
            with open(d / f"openface_{EXTRACT_FPS}fps.csv", "w") as f:
                f.write(",".join(f"c{i}" for i in range(436)) + "\n")
                for ts in range(n_frames):
                    full = np.zeros((68, 2), np.float32)
                    full[17:] = lm[ts]
                    full[17:, 1] = 1024.0 - full[17:, 1]
                    f.write(",".join(["0", str(ts), str(ts / EXTRACT_FPS), "0.99", "1"]
                                     + ["0"] * 294 + [str(v) for v in full[:, 0]]
                                     + [str(v) for v in full[:, 1]] + ["0"]) + "\n")
    span = [[40, CLI_SECONDS * 1000 - 40]]
    splits = root / "splits" / "train_val_test.json"
    splits.parent.mkdir()
    splits.write_text(json.dumps({"train": {"S1": span, "S2": span},
                                  "val": {"S2": span}, "test": {"S1": span}}))
    assets = (head, emb)
    print(f"extract: the CLI's ringnet, flame and combine stages write HDF5 (h5py "
          f"{'imports' if importlib.util.find_spec('h5py') else 'is not installed'} "
          "here); they run in tests/test_torch_extract_pipeline.py on the CPU, and "
          "here the fits and the combiner run in memory")
    stage_s = {}
    for name, run in (
            ("audio", lambda: cli.stage_audio(sessions, EXTRACT_FPS, device=dev)),
            ("voca", lambda: cli.stage_voca(root, EXTRACT_FPS, device=dev, assets=assets))):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        stage_s[name] = time.perf_counter() - t0
    fitted, rms = {}, []
    t0 = time.perf_counter()
    for sess in sessions:
        for part in ("P1", "P2"):
            d = sess / part
            for name, width in ((f"prosodic_features_{EXTRACT_FPS}fps.npy", 4),
                                (f"mfcc_{EXTRACT_FPS}fps.npy", 26)):
                a = np.load(d / name)
                if a.shape != (n_frames, width) or not np.isfinite(a).all():
                    fail(f"extract CLI: {d / name} is {a.shape}")
            n_params = len(list((root / "Sessions_50fps_voca" / sess.name / part
                                 / "flame_params").glob("*.npy")))
            if n_params != n_frames:
                fail(f"extract CLI: {n_params} voca flame_params files for {d}")
            # the fit is host-bound: one chunk of all the frames takes about
            # the time of a chunk of 256; CLI_FIT_STEPS (the fit's quality is
            # the B=256 fit's above, at the CLI's 30 + 60)
            tf = flame_fit.fit_participant(d, EXTRACT_FPS, head, emb, batch_frames=n_frames,
                                           stage1_steps=CLI_FIT_STEPS[0],
                                           stage2_steps=CLI_FIT_STEPS[1])
            fitted.setdefault(sess.name, {})[part] = tf
            params = {k[3:]: torch.as_tensor(v, device=dev) for k, v in tf.items()}
            targets = flame_fit.read_openface_targets(d, EXTRACT_FPS)
            with torch.no_grad():
                xy = flame_fit.model_landmarks(head, emb, params)[..., :2].cpu().numpy()
            scale = (xy * targets).sum((1, 2)) / (xy * xy).sum((1, 2))
            rms.append(np.sqrt(((scale[:, None, None] * xy - targets) ** 2)
                               .sum(-1).mean(-1)))
    torch.cuda.synchronize()
    stage_s["fit_participant"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.validate_splits_dir(splits)
    corpus = combine.combine_corpus(root, combine.load_split_spec(splits), EXTRACT_FPS,
                                    flame=fitted)
    stage_s["combine_corpus"] = time.perf_counter() - t0
    rms = np.concatenate(rms)
    print(f"extract CLI on {card}: stages {json.dumps(stage_s)} (two sessions of "
          f"{CLI_SECONDS} s, {n_frames} frames a participant); fitted landmarks RMS "
          f"median {np.median(rms):.3f} px  ok")

    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=str(root))
    n_windows = len(WindowDataset.from_chunks(corpus, "train", hp.Data, hp.Conditioning,
                                              hp.Train["seq_len"]))
    if n_windows < hp.batch_size:
        fail(f"extract_train: {n_windows} train windows in the extracted corpus, "
             f"fewer than final_model's B={hp.batch_size}")
    ckpt_dir = root / "ckpt"
    step_log = []
    reset_launches()
    t0 = time.perf_counter()
    train_loop.train(hp, seed=SEED, ckpt_dir=ckpt_dir, max_steps=3, device=dev,
                     corpus=corpus, verbose=False,
                     step_hook=lambda s, m: step_log.append(float(m["nll"])))
    gen = Generator.from_checkpoint(CheckpointManager(ckpt_dir).latest(),
                                    dataset_root=str(root), device=dev)
    gen.face_means, gen.face_stds = face_means_stds(corpus.means, corpus.stds,
                                                    hp.Data["expression_dim"])
    generated = gen.generate(frames, seed=SEED)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    require_launches("extract_train", launches,
                     ("cond_gates", "seq_fwd", "seq_bwd", "seq_rev"))
    if len(step_log) != 3 or not np.isfinite(step_log).all() \
            or not np.isfinite(generated).all():
        fail(f"extract_train: nll {step_log}, generated finite "
             f"{np.isfinite(generated).all()}")
    train = {"windows": n_windows, "batch": hp.batch_size, "nll": step_log,
             "wall_s": train_s, "generated_shape": list(generated.shape),
             "launches": launches}
    print(f"extract -> train: final_model 3 steps at B={hp.batch_size} from the "
          f"extracted corpus ({n_windows} train windows), its checkpoint generated "
          f"{tuple(generated.shape)}, {train_s:.3f} s on {card}; launches {launches}  ok")
    return {"sessions": 2, "seconds": CLI_SECONDS, "frames_per_participant": n_frames,
            "stage_wall_s": stage_s, "fitted_rms_px_median": float(np.median(rms)),
            "fitted_rms_px_p95": float(np.percentile(rms, 95)), "train": train}


def eager_flow_sequence(spec, flow_params, xs, cond_seq, states0):
    """The teacher-forced traversal as the eager ``flow.frame_fwd`` loop:
    (z_seq, logdet, new_states, scales), differentiable."""
    import torch

    from lets_face_it_tpu_torch.model import flow

    states, zs, lds, scs = states0, [], [], []
    for t in range(xs.shape[0]):
        z, ld, states, sc = flow.frame_fwd(spec, flow_params, xs[t], None, states,
                                           cond_projs=cond_seq[t],
                                           collect_scales=True)
        zs.append(z)
        lds.append(ld)
        scs.append(sc)
    return torch.stack(zs), torch.stack(lds), states, torch.stack(scs)


def sequence_objective(z, logdet, new_states):
    """The NLL in bits plus terms on z and the final states, so that every
    cotangent path of the traversal is exercised."""
    import math

    objective = logdet - 0.5 * (z ** 2 + math.log(2 * math.pi)).sum(-1)
    return ((-objective / math.log(2.0)).mean() + 0.05 * (new_states ** 2).sum()
            + 0.01 * (z ** 2).sum())


# ---------------------------------------------------------------------------
# Step 17: the matmul precision modes, k steps a dispatch, the bf16 wire,
# the profiler switch
# ---------------------------------------------------------------------------

MODES_CHECKED = ("high", "medium")
# Dense tensor-core peaks of an H100 SXM at 700 W (NVIDIA data sheet), the
# operations' rate the reduced modes' bounds use: TF32 and bf16.
PEAK_MODE_FLOP_S = {"high": 495e12, "medium": 989e12}
# A kernel against its plain twin at a reduced mode. Both round the same
# operands, but they sum in other orders, so an activation within a float32
# rounding of a TF32 or bf16 rounding boundary can round the other way and
# move by one step of that grid (2^-10 relative for TF32, 2^-7 for bf16),
# and the K steps spread it. The largest |difference| is held to
# MODE_MAX_STEPS steps of the output's largest |value|, the root mean square
# to MODE_RMS_STEPS steps of the output's or, where more, to SEQ_MODE_RATIO
# times the plain twin's own float32 - float64 spread at the same rounding:
# on these random weights the K steps amplify flips until at "high" they
# move many elements (frame_rev B=64: 0.47 steps rms on an H100, as the
# plain version against itself in float64), while the tests on the CPU hold
# the rounding sites on small inputs at 0.125 steps. The first probe on an
# H100 read at most 1.1 steps of the largest value (frame_rev B=512 at
# "high").
MODE_GRID = {"high": 2.0 ** -10, "medium": 2.0 ** -7}
MODE_MAX_STEPS, MODE_RMS_STEPS = 4.0, 0.25
# Whole sequences at a reduced mode: the 76 autoregressive frames amplify a
# flip until the kernel's sequence and the plain one part (the plain version
# in float32 against itself in float64 parts as much: 8.4 at "medium" on
# the first probe). The first frame is held as one frame; at B=128 the root
# mean square of kernel - plain over the whole sequence is held to
# SEQ_MODE_RATIO times the plain version's own float32 - float64.
SEQ_MODE_RATIO = 3.0
# The short A/B: 50 steps an epoch at B=256 (40 chunks of 400 frames give
# 12,840 windows), a validation at the end of each; the bf16 arm's val NLL
# within AB_REL of the f32 arm's at every shared validation. One epoch a
# arm (three until steps 18-20 needed the time, 100 steps until step 24
# did; the 5,000-step A/B is precision_ab.py's).
AB_STEPS, AB_CHUNKS, AB_REL = 50, 40, 0.02
# The limits above bound a kernel's whole outputs but do not tell the modes
# apart: after a few products a flip has spread as far as the other mode's
# rounding would. A kernel's first step is one product deep (seq_bwd's
# cotangent of the GRU state one past the head's), where a flip moves one
# operand and the other mode's rounding every one: its output's rms against the plain
# twin is held to MODE_SHALLOW_RMS steps of the grid, and the same kernel
# launched at each other mode must read above that (the control), or the
# check fails as blind to a kernel that ignores its mode. seq_rev and
# frame_rev are held bit for bit to their gates and chain kernels launched
# one by one through their wrappers. On an H100 (80GB HBM3, 700 W) this
# step read the kernels' first steps at most 0.0004 steps from their twins
# and the controls at least 0.163 (seq_bwd; the others 0.197-2.55): the
# limit sits between them on a log scale.
MODE_SHALLOW_RMS = 0.02
# Bytes of a product's weight in the bounds at each mode: a set rounded to
# bf16 holds its values in 2 bytes; TF32 has no narrower storage.
MODE_WEIGHT_BYTES = {"high": 4, "medium": 2}
# k steps a dispatch: 64 chunks of 160 frames give 20 steps of 256 an epoch.
# K_CHECK steps held against k = 1 at step 10's limits (the two differ only
# in how Adam rounds: capturable, its rate a device tensor): an eager block,
# the captured one, then three replays on fresh blocks, the last in the next
# epoch at the next rate (the check's schedule steps the rate every epoch),
# with a deranged step in a replay after the first required; then K_WARM
# steps (the eager block and the capture), K_WINDOW timed and K_WINDOW
# traced, each way once (windows of 10 until the script's time limit needed
# the time; a window is whole blocks of k).
K_DISPATCH, K_CHUNKS, K_CHECK, K_WARM, K_WINDOW = 5, 64, 25, 10, 5


def mode_check(name, got, ref, ref64, precision) -> tuple:
    """``got`` (the kernel) against ``ref`` (its plain twin) at
    ``precision``: the largest |d| within MODE_MAX_STEPS grid steps of
    max|ref|, the rms within MODE_RMS_STEPS steps of rms(ref) or
    SEQ_MODE_RATIO x rms(ref - ref64), ``ref64`` the plain twin in float64
    -> (largest |d| in steps, rms in steps, the plain's own rms in steps,
    largest |d|)."""
    import torch

    got, ref, ref64 = got.double(), ref.double(), ref64.double()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name} at {precision}: shape {tuple(got.shape)} or non-finite")
    step = MODE_GRID[precision]
    d = got - ref
    max_steps = d.abs().max().item() / (step * max(ref.abs().max().item(), 1.0))
    unit = step * max(ref.pow(2).mean().sqrt().item(), 1e-30)
    rms_steps = d.pow(2).mean().sqrt().item() / unit
    plain_steps = (ref - ref64).pow(2).mean().sqrt().item() / unit
    if max_steps > MODE_MAX_STEPS or rms_steps > max(MODE_RMS_STEPS,
                                                     SEQ_MODE_RATIO * plain_steps):
        fail(f"{name} at {precision}: largest |diff| {max_steps:.3f} steps of the "
             f"grid (limit {MODE_MAX_STEPS}), rms {rms_steps:.4f} steps (limit "
             f"{MODE_RMS_STEPS}, or {SEQ_MODE_RATIO} x the plain twin's float32 - "
             f"float64 {plain_steps:.4f})")
    return max_steps, rms_steps, plain_steps, d.abs().max().item()


def kernels_at_modes(spec, hp, model, dev, out) -> tuple:
    """Every kernel at each reduced mode against its plain twin at the same
    mode, with the launch counters of each call, the controls (the kernel at
    each other mode against the same twin) and the composition checks; then
    each kernel's times at each mode. -> (errs, rows, controls), readings
    added to ``out``."""
    import torch

    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk
    from lets_face_it_tpu_torch.utils.precision import matmul_precision

    k_steps, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    cond, p1 = spec.cond.cond_dim, spec.cond.p1_face.out_dim
    n_seq = hp.Validation["seq_len"] - spec.cond.longest_history
    b_tr, n_tr = hp.batch_size, hp.Train["seq_len"] - spec.cond.longest_history
    z1 = spec.z1_dim
    w = fk.prepare_sampling_weights(spec, model.flow)
    w_p1 = model.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2).contiguous().detach()
    w64 = weights64(w)
    gru = {kk: v.detach().contiguous() for kk, v in model.flow["rnn"].items()}
    tw = tk.TrainWeights(*(t.detach().contiguous()
                           for t in tk.prepare_train_weights(spec, model.flow)))
    tw64 = tk.TrainWeights(*(t.double() for t in tw))
    g = torch.Generator(device=dev).manual_seed(SEED + 17)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    print(f"mode tolerance: kernel vs plain twin at the same mode, largest |diff| "
          f"<= {MODE_MAX_STEPS} steps of the mode's grid (2^-10 TF32, 2^-7 bf16) "
          f"of max|value|, rms <= {MODE_RMS_STEPS} steps of rms(value); sequences: "
          f"frame 0 so, rms over all {n_seq} frames at B=128 <= {SEQ_MODE_RATIO} x "
          "the plain version's float32 - float64 (same rounding); each kernel's "
          f"first step's output rms <= {MODE_SHALLOW_RMS} steps, which the kernel at "
          "each other mode must exceed; seq_rev and frame_rev bit for bit as their "
          "gates and chain kernels launched one by one")
    errs, rows, controls = {}, {}, {}

    def note(name, prec, *readings):
        prev = errs.get((name, prec), (0.0, 0.0, 0.0, 0.0))
        for r in readings:
            prev = tuple(max(a_, b_) for a_, b_ in zip(prev, r))
        errs[name, prec] = prev

    first_steps = out.setdefault("first_steps", {})

    def shallow(label, prec, got, ref, others):
        """``got`` (a kernel's first-step output at ``prec``) against ``ref``
        (its plain twin's), and ``others`` {mode: the kernel's at that
        mode}, held by ``shallow_check``; the readings kept by kernel (the
        first word of ``label``) and by ``label``."""
        real, ctrl = shallow_check(label, prec, got, ref, others)
        first_steps[f"{label} at {prec}"] = {"rms": real, "controls": ctrl}
        key = (label.split()[0], prec)
        prev = controls.get(key, (0.0, math.inf))
        controls[key] = (max(prev[0], real), min(prev[1], min(ctrl.values())))

    def d64(*ts):
        return [t.double() for t in ts]

    def counted(call, expect):
        reset_launches()
        result = call()
        torch.cuda.synchronize()
        got = read_launches()
        for name, n in expect.items():
            if got[name] != n:
                fail(f"launch counters at a mode: {name} {got[name]}, expected {n}")
        return result

    def composed(prec, zs, fixed, hist, states):
        """The frames of ``sequence_rev_fused`` (``fixed`` [N, K, B, cond])
        as its two kernels launched one by one through their wrappers."""
        xs = []
        for t in range(zs.shape[0]):
            _, gc_t, gh_t = fk.sample_gates(spec, w, w_p1[:, :hist.shape[-1]], fixed[t],
                                            hist, states, precision=prec)
            x_t, states, hist_n = fk.sample_chain(spec, w, zs[t], gc_t, gh_t, states,
                                                  hist if hist.shape[-1] else None,
                                                  precision=prec)
            hist = hist_n if hist_n is not None else hist
            xs.append(x_t)
        return torch.stack(xs)

    with torch.no_grad():
        for prec in MODES_CHECKED:
            m = fk.MODES[prec]
            others = [p_ for p_ in ("highest",) + MODES_CHECKED if p_ != prec]
            for b in (1, 64, 512):
                z, pr, st = randn(b, c), randn(k_steps, b, cond), randn(k_steps, b, h, scale=0.5)
                x, s_new = counted(lambda: fk.frame_rev_fused(spec, w, z, pr, st, precision=prec),
                                   {"frame_rev": 1, "sample_gates": 1, "sample_chain": 1})
                xr, sr = fk.frame_rev_fused_ref(spec, w, z, pr, st, m)
                x6, s6 = fk.frame_rev_fused_ref(spec, w64, *d64(z, pr, st), m)
                note("frame_rev", prec,
                     mode_check(f"frame_rev B={b} x", x, xr, x6, prec),
                     mode_check(f"frame_rev B={b} states", s_new, sr, s6, prec))
                # the first reversed step's state: one product deep
                shallow(f"frame_rev B={b} states[K-1]", prec, s_new[-1], sr[-1],
                        {p_: fk.frame_rev_fused(spec, w, z, pr, st, precision=p_)[1][-1]
                         for p_ in others})
                xc = composed(prec, z[None], pr[None], z.new_zeros(b, 0), st)
                if not torch.equal(xc[0], x):
                    fail(f"frame_rev B={b} at {prec}: not bit for bit its gates and chain "
                         f"launched one by one (max|d| {(xc[0] - x).abs().max().item():.3e})")
            for b, own in ((1, True), (64, False), (128, True), (512, True)):
                z, pr, st = randn(b, c), randn(k_steps, b, cond), randn(k_steps, b, h, scale=0.5)
                p1_b = p1 if own else 0
                hist = randn(b, p1_b)
                got = counted(lambda: fk.sample_gates(spec, w, w_p1[:, :p1_b], pr, hist, st,
                                                      precision=prec),
                              {"sample_gates": 2 if own else 1, "sample_chain": 0})
                ref = fk.sample_gates_ref(spec, w, w_p1[:, :p1_b], pr, hist, st, m)
                r64 = fk.sample_gates_ref(spec, w64, *d64(w_p1[:, :p1_b], pr, hist, st), m)
                for nm, a_, r_, q_ in zip(("proj", "gc", "gh"), got, ref, r64):
                    note("sample_gates", prec,
                         mode_check(f"sample_gates B={b} {nm}", a_, r_, q_, prec))
                ctrl = {p_: fk.sample_gates(spec, w, w_p1[:, :p1_b], pr, hist, st, precision=p_)
                        for p_ in others}
                # one product deep: gh, and proj (own face) or gc (without)
                for i, nm in ((2, "gh"), (0, "proj") if own else (1, "gc")):
                    shallow(f"sample_gates B={b} {nm}", prec, got[i], ref[i],
                            {p_: v[i] for p_, v in ctrl.items()})
                _, gc, gh = ref
                hist_c = hist if own else None
                got = counted(lambda: fk.sample_chain(spec, w, z, gc, gh, st, hist_c,
                                                      precision=prec),
                              {"sample_chain": 1, "sample_gates": 0})
                ref = fk.sample_chain_ref(spec, w, z, gc, gh, st, hist_c, m)
                r64 = fk.sample_chain_ref(spec, w64, *d64(z, gc, gh, st),
                                          None if hist_c is None else hist_c.double(), m)
                for nm, a_, r_, q_ in zip(("x", "states", "hist"), got, ref, r64):
                    if r_ is not None:
                        note("sample_chain", prec,
                             mode_check(f"sample_chain B={b} {nm}", a_, r_, q_, prec))
                # the first step's state from zero gates and states: the z1
                # product alone (given gates would outweigh it)
                zero_g, zero_s = torch.zeros_like(gc), torch.zeros_like(st)
                shallow(f"sample_chain B={b} states[K-1] (zero gates)", prec,
                        fk.sample_chain(spec, w, z, zero_g, zero_g, zero_s, hist_c,
                                        precision=prec)[1][-1],
                        fk.sample_chain_ref(spec, w, z, zero_g, zero_g, zero_s, hist_c,
                                            m)[1][-1],
                        {p_: fk.sample_chain(spec, w, z, zero_g, zero_g, zero_s, hist_c,
                                             precision=p_)[1][-1] for p_ in others})
            for b in (1, 128):
                zs, fixed = randn(n_seq, b, c), randn(n_seq, k_steps, b, cond)
                hist0, st0 = randn(b, p1), torch.zeros(k_steps, b, h, device=dev)
                xs = counted(lambda: fk.sequence_rev_fused(spec, w, w_p1, zs, fixed, hist0, st0,
                                                           precision=prec),
                             {"seq_rev": 1, "sample_gates": 2 * n_seq, "sample_chain": n_seq})
                xr = fk.sequence_rev_fused_ref(spec, w, w_p1, zs, fixed, hist0, st0, m)
                x64 = fk.sequence_rev_fused_ref(spec, w64, *d64(w_p1, zs, fixed, hist0, st0),
                                                m)
                note("seq_rev", prec, mode_check(f"seq_rev B={b} frame 0", xs[0], xr[0],
                                                 x64[0], prec))
                # the sequence as its kernels launched one by one, which the
                # checks above hold at this mode; the kernel at another mode
                # must not match it
                xc = composed(prec, zs, fixed, hist0, st0)
                if not torch.equal(xc, xs):
                    fail(f"seq_rev B={b} at {prec}: not bit for bit its gates and chain "
                         f"launched one by one (max|d| {(xc - xs).abs().max().item():.3e})")
                for p_ in others:
                    if torch.equal(fk.sequence_rev_fused(spec, w, w_p1, zs, fixed, hist0, st0,
                                                         precision=p_), xc):
                        fail(f"seq_rev B={b}: the kernel at {p_} matches its kernels at "
                             f"{prec} bit for bit: the mode does not reach them")
                if b == 128:
                    rms_k = (xs.double() - xr.double()).pow(2).mean().sqrt().item()
                    rms_p = (xr.double() - x64).pow(2).mean().sqrt().item()
                    out[f"seq_rev_b128_{prec}"] = {"rms_kernel_vs_plain": rms_k,
                                                   "rms_plain32_vs_plain64": rms_p,
                                                   **drift(xs, xr)}
                    if rms_k > SEQ_MODE_RATIO * rms_p:
                        fail(f"seq_rev B=128 at {prec}: rms kernel - plain {rms_k:.3e} > "
                             f"{SEQ_MODE_RATIO} x plain float32 - float64 {rms_p:.3e}")
                    print(f"check seq_rev B=128 N={n_seq} at {prec}: rms kernel - plain "
                          f"{rms_k:.3e}, plain float32 - float64 {rms_p:.3e}; drift "
                          f"{json.dumps(drift(xs, xr))}  ok")
            xs_t, cs_t, st_t = randn(n_tr, b_tr, c), randn(n_tr, k_steps, b_tr, cond), \
                randn(k_steps, b_tr, h, scale=0.3)
            gc_k = counted(lambda: tk.cond_gates(spec, tw, cs_t, precision=prec),
                           {"cond_gates": 1})
            gc_r = tk.cond_gates_ref(spec, tw, cs_t, m)
            note("cond_gates", prec, mode_check(
                "cond_gates", gc_k, gc_r, tk.cond_gates_ref(spec, tw64, cs_t.double(), m), prec))
            shallow("cond_gates", prec, gc_k, gc_r,
                    {p_: tk.cond_gates(spec, tw, cs_t, precision=p_) for p_ in others})
            del gc_k, gc_r
            got = counted(lambda: tk.seq_fwd(spec, tw, xs_t, cs_t, st_t, precision=prec),
                          {"seq_fwd": 1, "cond_gates": 1})
            ref = tk.seq_fwd_ref(spec, tw, xs_t, cs_t, st_t, m)
            r64 = tk.seq_fwd_ref(spec, tw64, *d64(xs_t, cs_t, st_t), m)
            for nm, a_, r_, q_ in zip(("z", "scales", "zs_res", "states_res", "gc"), got,
                                      ref, r64):
                note("seq_fwd", prec, mode_check(f"seq_fwd {nm}", a_, r_, q_, prec))
            del r64
            # frame 0's first 1x1 product, the z1 half of step 1's input
            shallow("seq_fwd zs_res[0, 1, :, :Z1]", prec, got[2][0, 1, :, :z1],
                    ref[2][0, 1, :, :z1],
                    {p_: tk.seq_fwd(spec, tw, xs_t, cs_t, st_t, precision=p_)[2][0, 1, :, :z1]
                     for p_ in others})
            _, scales_r, zs_res, st_res, gc_r = ref
            hprev = torch.cat([st_t[None], st_res[:-1]])
            cot = (randn(*xs_t.shape), randn(*scales_r.shape), randn(*st_t.shape))
            got = counted(lambda: tk.seq_bwd(spec, tw, gc_r, zs_res, hprev, *cot,
                                             precision=prec), {"seq_bwd": 1})
            ref = tk.seq_bwd_ref(spec, tw, gc_r, zs_res, hprev, *cot, m)
            r64 = tk.seq_bwd_ref(spec, tw64, *d64(gc_r, zs_res, hprev, *cot), m)
            for nm, a_, r_, q_ in zip(("dx", "dstates0", "dgi", "dghn", "dhout", "dzb"),
                                      got, ref, r64):
                note("seq_bwd", prec, mode_check(f"seq_bwd {nm}", a_, r_, q_, prec))
            del r64
            # the backward's first step (the last frame's last): the cotangent
            # of the new GRU state is one product of the coupling head's deep
            shallow("seq_bwd dghn[N-1, K-1]", prec, got[3][-1, -1], ref[3][-1, -1],
                    {p_: tk.seq_bwd(spec, tw, gc_r, zs_res, hprev, *cot,
                                    precision=p_)[3][-1, -1] for p_ in others})
            print(f"check kernels at {prec} against their plain twins (largest |diff|, "
                  "rms, the plain twin's float32 - float64 rms, in steps of the grid): "
                  + ", ".join(f"{n} {e[0]:.3f}/{e[1]:.4f}/{e[2]:.4f}"
                              for (n, p), e in errs.items() if p == prec)
                  + "; first steps (rms in steps, the kernel's; the least at another "
                  "mode): " + ", ".join(f"{n[:-len(prec) - 4]} {v['rms']:.4f}/"
                                        f"{min(v['controls'].values()):.4f}"
                                        for n, v in first_steps.items()
                                        if n.endswith(f" at {prec}"))
                  + f" (limit {MODE_SHALLOW_RMS}); launch counters per call  ok")

            # -- times at the mode, beside the plain twin, the library call at
            # torch's same setting and the bound at the tensor cores' rate, the
            # weights of a set rounded to bf16 at 2 bytes
            peak = PEAK_MODE_FLOP_S[prec]
            wb = MODE_WEIGHT_BYTES[prec]
            z, pr, st = randn(1, c), randn(k_steps, 1, cond), randn(k_steps, 1, h, scale=0.5)
            zs, fixed = randn(n_seq, 1, c), randn(n_seq, k_steps, 1, cond)
            hist0, st0 = randn(1, p1), torch.zeros(k_steps, 1, h, device=dev)
            _, gc1, gh1 = fk.sample_gates_ref(spec, w, w_p1, pr, hist0, st, m)
            wm = fk.round_sampling_weights(spec, w, m)   # as their owners hold them
            cases = {
                "frame_rev": (lambda: fk.frame_rev_fused(spec, wm, z, pr, st, precision=prec),
                              lambda: fk.frame_rev_fused_ref(spec, wm, z, pr, st, m),
                              lambda: library_frame_rev(spec, w, gru, z, pr, st),
                              frame_bound_ms(spec, w, 1, peak, wb), "B=1", 20),
                "seq_rev": (lambda: fk.sequence_rev_fused(spec, wm, w_p1, zs, fixed, hist0,
                                                          st0, precision=prec),
                            lambda: fk.sequence_rev_fused_ref(spec, wm, w_p1, zs, fixed,
                                                              hist0, st0, m),
                            lambda: library_seq_rev(spec, w, gru, w_p1, zs, fixed, hist0, st0),
                            seq_bound_ms(spec, w, n_seq, 1, peak, wb), f"B=1, N={n_seq}", 3),
                "sample_gates": (lambda: fk.sample_gates(spec, wm, w_p1, pr, hist0, st,
                                                         precision=prec),
                                 lambda: fk.sample_gates_ref(spec, wm, w_p1, pr, hist0, st, m),
                                 lambda: library_gates(spec, w, w_p1, pr, hist0, st),
                                 gates_bound_ms(spec, 1, p1, peak, wb), "B=1, own face", 20),
                "sample_chain": (lambda: fk.sample_chain(spec, wm, z, gc1, gh1, st, hist0,
                                                         precision=prec),
                                 lambda: fk.sample_chain_ref(spec, wm, z, gc1, gh1, st, hist0, m),
                                 lambda: fk.sample_chain_ref(spec, wm, z, gc1, gh1, st, hist0, m),
                                 chain_bound_ms(spec, w, 1, p1, peak, wb), "B=1, own face", 20),
                "cond_gates": (lambda: tk.cond_gates(spec, tw, cs_t, precision=prec),
                               lambda: tk.cond_gates_ref(spec, tw, cs_t, m),
                               None, cond_gates_bound_ms(spec, n_tr, b_tr, peak),
                               f"B={b_tr}, N={n_tr}", 3),
                "seq_fwd": (lambda: tk.seq_fwd(spec, tw, xs_t, cs_t, st_t, precision=prec),
                            lambda: tk.seq_fwd_ref(spec, tw, xs_t, cs_t, st_t, m),
                            lambda: eager_flow_sequence(spec, model.flow, xs_t, cs_t, st_t),
                            train_fwd_bound_ms(spec, tw, n_tr, b_tr, peak),
                            f"B={b_tr}, N={n_tr}", 3),
                "seq_bwd": (lambda: tk.seq_bwd(spec, tw, gc_r, zs_res, hprev, *cot,
                                               precision=prec),
                            lambda: tk.seq_bwd_ref(spec, tw, gc_r, zs_res, hprev, *cot, m),
                            None, train_bwd_bound_ms(spec, tw, n_tr, b_tr, peak),
                            f"B={b_tr}, N={n_tr}", 3),
            }
            lib_a = torch.nn.functional.leaky_relu(cs_t, 0.01).permute(1, 0, 2, 3).reshape(
                k_steps, -1, cond).contiguous()
            lib_w = tw.w_ih_t[:, spec.z1_dim:].contiguous()
            lib_b = tw.b_ih[:, None, :].contiguous()
            # the gates at sequence_sample's B=128 (own face): the tile plan
            b_s = 128
            pr_s, st_s, hist_s = randn(k_steps, b_s, cond), randn(k_steps, b_s, h, scale=0.5), \
                randn(b_s, p1)
            cases["sample_gates B=128"] = (
                lambda: fk.sample_gates(spec, wm, w_p1, pr_s, hist_s, st_s, precision=prec),
                lambda: fk.sample_gates_ref(spec, wm, w_p1, pr_s, hist_s, st_s, m),
                lambda: library_gates(spec, w, w_p1, pr_s, hist_s, st_s),
                gates_bound_ms(spec, b_s, p1, peak, wb), f"B={b_s}, own face", 20)
            # the other plan of each gate kernel, forced: the plan it replaced
            other_plans = {
                "cond_gates": ("simt_original", lambda: tk.cond_gates(
                    spec, tw, cs_t, precision=prec, plan="simt", tile=0)),
                "sample_gates B=128": ("vector", lambda: fk.sample_gates(
                    spec, wm, w_p1, pr_s, hist_s, st_s, precision=prec, plan="vector"))}
            for key, (call, plain, lib, (bound, by), shape, reps) in cases.items():
                name = key.split()[0]
                if name == "cond_gates":
                    lib = lambda: torch.baddbmm(lib_b, lib_a, lib_w)  # noqa: E731
                # the checks above ran each plain twin at this mode and shape
                row = {"ms": time_ms(graphed(call), reps), "wrapper_ms": time_ms(call, reps),
                       "plain_ms": time_ms(plain, 1, warmup=0)}
                if lib is None:      # seq_bwd: the eager loop's autograd backward
                    row["library_ms"] = library_backward_ms(
                        spec, model.flow, (xs_t, cs_t, st_t), cot, prec, reps,
                        EAGER_RECAPTURE_WARMUP)
                else:
                    with matmul_precision(prec):
                        row["library_ms"] = time_ms(graphed(
                            lib, EAGER_RECAPTURE_WARMUP if name == "seq_fwd" else 2),
                            reps)
                other = ""
                if key in other_plans:
                    plan, fn = other_plans[key]
                    row["plan"] = (tk.cond_gates_plan(m)[0] if name == "cond_gates"
                                   else fk.gates_plan(b_s, mode=m))
                    row[f"{plan}_plan_ms"] = time_ms(graphed(fn), reps)
                    other = f" on the {row['plan']} plan ({plan} plan {row[f'{plan}_plan_ms']:.4f} ms)"
                row.update(bound_ms=bound, bound_by=by, shape=shape)
                if key == name:
                    rows[name, prec] = row
                else:
                    rows[name, prec].setdefault("by_batch", []).append(row)
                print(f"{name} at {prec} ({shape}): kernel {row['ms']:.4f} ms{other} (graph "
                      f"replay; {row['wrapper_ms']:.4f} ms through the wrapper), plain "
                      f"{row['plain_ms']:.4f} ms, library at torch's {prec} "
                      f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}, "
                      f"{peak / 1e12:.0f} TFLOP/s)")
            del lib_a
    return errs, rows, controls

# Warm-up calls before a CUDA graph captures the eager frame_fwd loop of a
# library yardstick. Each costs seconds of host time at B=256, N=56 (an
# eager forward and backward 8-15 s on the H100 machines' hosts). Step 11's
# first capture takes one, which makes the lazy state a capture needs; the
# later captures of the same loop (steps 17 and 18, other modes and shapes)
# take none. (graphed's default 2 until the script's time limit needed the
# time.)
EAGER_WARMUP, EAGER_RECAPTURE_WARMUP = 1, 0


def library_backward_ms(spec, flow, inputs, cot, prec, reps,
                        warmup=EAGER_WARMUP) -> float:
    """The library yardstick of ``seq_bwd``: the eager ``frame_fwd`` loop's
    autograd backward (inputs and flow weights) under torch's ``prec``,
    timed as a graphed forward + backward (``warmup`` eager calls before its
    capture) less the graphed forward with autograd recording (its ops warm
    by then)."""
    import torch

    from lets_face_it_tpu_torch.utils.precision import matmul_precision

    with torch.enable_grad(), matmul_precision(prec):
        lib_in = [x.clone().requires_grad_() for x in inputs]
        lib_w = [p for n, p in flow.named_parameters()
                 if p.requires_grad and not n.startswith("cond_proj")]

        def lib_forward():
            z, _, ns, sc = eager_flow_sequence(spec, flow, *lib_in)
            return z, sc, ns

        return (time_ms(graphed(lambda: torch.autograd.grad(
                    lib_forward(), lib_in + lib_w, cot), warmup), reps)
                - time_ms(graphed(lib_forward, 0), reps))


def shallow_check(name, prec, got, ref, others) -> tuple:
    """A kernel's first-step output ``got`` at ``prec`` against its plain
    twin's ``ref``: the rms in grid steps of rms(ref) within
    MODE_SHALLOW_RMS, and that of each of ``others`` ({mode: the kernel's
    output at that mode}, the controls) beyond it -> (rms, {mode: rms})."""
    import torch

    ref = ref.double()
    unit = MODE_GRID[prec] * max(ref.pow(2).mean().sqrt().item(), 1e-30)

    def rms(x):
        return (x.double() - ref).pow(2).mean().sqrt().item() / unit

    real, ctrl = rms(got), {p: rms(x) for p, x in others.items()}
    if not torch.isfinite(got).all() or real > MODE_SHALLOW_RMS:
        fail(f"{name} at {prec}: first-step rms {real:.4f} steps of the grid "
             f"(limit {MODE_SHALLOW_RMS})")
    for p, v in ctrl.items():
        if v <= MODE_SHALLOW_RMS:
            fail(f"{name}: the kernel at {p} reads {v:.4f} steps from the plain twin "
                 f"at {prec}, within the limit {MODE_SHALLOW_RMS}: the check cannot "
                 "tell the modes apart")
    return real, ctrl


def precision_step(tmp, dev, card, records) -> dict:
    """Step 17 (see the module docstring): returns the readings, appends a
    kernel record per kernel and reduced mode to ``records``."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch import precision_ab
    from lets_face_it_tpu_torch.data.prefetch import gather_host, receive
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk
    from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator
    from lets_face_it_tpu_torch.sample.weights import seeded_random_model
    from lets_face_it_tpu_torch.train import __main__ as train_cli
    from lets_face_it_tpu_torch.train import loop as train_loop
    from lets_face_it_tpu_torch.train import state as train_state
    from lets_face_it_tpu_torch.utils.precision import matmul_precision

    t17 = time.perf_counter()
    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
    spec = FlowSpec.build(hp)
    b_tr = hp.batch_size
    model = seeded_random_model(spec, SEED).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    out = {"card": card}

    # -- the eager products under "medium" on this card ------------------------
    a = torch.randn(256, 512, generator=g, device=dev)
    b = torch.randn(512, 384, generator=g, device=dev)
    exact = (a.double() @ b.double())
    eager = {}
    for prec in ("highest", "high", "medium"):
        with matmul_precision(prec):
            eager[prec] = (a @ b).double()
    tf32 = fk.round_tf32(a).double() @ fk.round_tf32(b).double()
    bf16 = fk.round_operand(a, 2).double() @ fk.round_operand(b, 2).double()
    eager_read = {p: {"vs_exact": (e - exact).abs().max().item(),
                      "vs_tf32_operands": (e - tf32).abs().max().item(),
                      "vs_bf16_operands": (e - bf16).abs().max().item()}
                  for p, e in eager.items()}
    out["eager_matmul"] = eager_read
    print(f"eager float32 matmul [256x512]@[512x384] on {card}: "
          + "; ".join(f"{p}: max|d| vs exact {r['vs_exact']:.3e}, vs TF32 operands "
                      f"{r['vs_tf32_operands']:.3e}, vs bf16 operands "
                      f"{r['vs_bf16_operands']:.3e}" for p, r in eager_read.items()))

    errs, rows, controls = kernels_at_modes(spec, hp, model, dev, out)

    # -- each mode's path: two training steps at B=256, a validation (NLL,
    # generation) and three pushes of a stream, under torch's setting -------
    train_ds, val_ds = train_loop.load_datasets(
        hp, train_loop.synthetic_corpus(hp, SEED, n_train_chunks=TRAIN_CHUNKS))
    mode_launches, mode_plans = {}, {}
    for prec in MODES_CHECKED:
        st_m = train_state.TrainState.create(seeded_random_model(spec, SEED).to(dev), hp,
                                             3, SEED)
        jb = train_loop.to_device(train_ds.get_batch(np.arange(b_tr)), dev)
        s = StreamingGenerator(spec, st_m.model, batch_size=1, seed=SEED, device="cuda")
        frame = {kk: jb[kk][:1, 0].cpu().numpy()
                 for kk in ("p2_face", "p1_speech", "p2_speech") if kk in jb}
        reset_launches()
        with matmul_precision(prec):
            for _ in range(2):
                mets = train_state.train_step(spec, hp, st_m, jb)
            val = train_loop.run_validation(spec, hp, st_m.model, val_ds, dev, 2, SEED)
            for _ in range(3):
                s.push(**frame)
        torch.cuda.synchronize()
        mode_launches[prec] = read_launches()
        mode_plans[prec] = read_plans()
        require_launches(f"the path at {prec}", mode_launches[prec],
                         ("cond_gates", "seq_fwd", "seq_bwd", "seq_rev", "frame_rev",
                          "sample_gates", "sample_chain"))
        require_plan(f"training at {prec}", mode_plans[prec], "cond_gates",
                     tk.cond_gates_plan(fk.MODES[prec])[0])
        require_plan(f"the validation at {prec}", mode_plans[prec], "sample_gates", "tile")
        if not (math.isfinite(float(mets["loss"])) and math.isfinite(val["val_loss"])):
            fail(f"the path at {prec}: loss {float(mets['loss'])}, val {val['val_loss']}")
        print(f"path at {prec}: 2 steps, a validation (val NLL {val['val_loss']:.3f}) and "
              f"3 pushes; launches {mode_launches[prec]}; gate plans {mode_plans[prec]}")
    for (name, prec), row in rows.items():
        src = {"frame_rev": ("csrc/frame_rev.cu", "pallas_flow.py:130"),
               "seq_rev": ("csrc/seq_rev.cu", "pallas_flow.py:346"),
               "sample_gates": ("csrc/sample_gates.cuh", "pallas_flow.py:172"),
               "sample_chain": ("csrc/sample_chain.cuh", "pallas_flow.py:152"),
               "cond_gates": ("csrc/cond_gates.cu", "pallas_train.py:241"),
               "seq_fwd": ("csrc/seq_fwd.cu", "pallas_train.py:182"),
               "seq_bwd": ("csrc/seq_bwd.cu", "pallas_train.py:330")}[name]
        records.append(dict(
            name=name, precision=prec, route="cuda",
            source=f"lets_face_it_tpu_torch/{src[0]}",
            replaces=f"lets_face_it_tpu/ops/{src[1]}",
            launches=mode_launches[prec][name], max_abs_err_grid_steps=errs[name, prec][0],
            max_abs_err=errs[name, prec][3],
            rms_err_grid_steps=errs[name, prec][1],
            plain_float64_rms_grid_steps=errs[name, prec][2],
            first_step_rms_grid_steps=controls.get((name, prec), (None,))[0],
            control_least_rms_grid_steps=controls.get((name, prec), (None, None))[1],
            **row))

    # -- the training step at precision 32 and 16 --------------------------------
    st_p = train_state.TrainState.create(seeded_random_model(spec, SEED).to(dev), hp, 3, SEED)
    jb = train_loop.to_device(train_ds.get_batch(np.arange(b_tr)), dev)
    step_ms = {}
    for bits, prec in ((32, "highest"), (16, "medium")):
        with matmul_precision(prec):
            step_ms[bits] = time_ms(lambda: train_state.train_step(spec, hp, st_p, jb),
                                    reps=3, warmup=1)
    with matmul_precision("medium"):
        step_trace = trace_window(f"train_step_b{b_tr}_precision16",
                                  lambda: train_state.train_step(spec, hp, st_p, jb), 3)
    out["train_step_ms"] = step_ms
    out["train_step_trace_precision16"] = step_trace
    print(f"training step B={b_tr}: precision 32 {step_ms[32]:.3f} ms, precision 16 "
          f"{step_ms[16]:.3f} ms ({step_ms[32] / step_ms[16]:.3f}x) on {card}")
    print(json.dumps(step_trace))

    # -- the short A/B ------------------------------------------------------------
    reset_launches()
    ab = precision_ab.run(max_steps=AB_STEPS, n_train_chunks=AB_CHUNKS,
                          frames_per_chunk=400, n_val_chunks=2, device=dev)
    ab_launches = read_launches()
    require_launches("the A/B (both arms)", ab_launches,
                     ("cond_gates", "seq_fwd", "seq_bwd", "seq_rev", "sample_gates",
                      "sample_chain"))
    rel = ab["summary"]["delta_relative_by_step"]
    if ab["summary"]["shared_val_steps"] != 1 or any(
            not math.isfinite(v) or abs(v) > AB_REL for v in rel.values()):
        fail(f"A/B: bf16 against f32 val NLL relative {rel} (limit {AB_REL})")
    out["ab"] = {k: ab[k] for k in ("summary", "arms", "fixture")}
    print(f"A/B {AB_STEPS} steps a arm at B={b_tr}: val NLL f32 "
          f"{[r['val_loss'] for r in ab['arms']['f32']['curve']]}, bf16 "
          f"{[r['val_loss'] for r in ab['arms']['bf16']['curve']]}, bf16 - f32 relative "
          f"{rel} (limit {AB_REL}); steps/s f32 {ab['arms']['f32']['steps_per_sec']:.3f}, "
          f"bf16 {ab['arms']['bf16']['steps_per_sec']:.3f}  ok")

    # -- k steps a dispatch as a CUDA graph, against k = 1 --------------------------
    hp_k = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
    hp_k.max_epochs, hp_k.check_val_every_n_epoch, hp_k.logger = 1000, 1000, False
    hp_k.device_data_cache = "on"
    corpus_k = train_loop.synthetic_corpus(hp_k, SEED, n_train_chunks=K_CHUNKS)
    hp_c = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
    hp_c.max_epochs, hp_c.check_val_every_n_epoch, hp_c.logger = 1000, 1000, False
    hp_c.device_data_cache = "on"
    hp_c.Optim["Schedule"]["args"]["step"]["step_size"] = 1
    checked = {}
    for k in (1, K_DISPATCH):
        hp_c.steps_per_dispatch = k
        mets = []
        replays0 = train_state.MultiStep.replays
        state_k, _ = train_loop.train(hp_c, seed=SEED, max_steps=K_CHECK, device="cuda",
                                      corpus=corpus_k, verbose=False,
                                      step_hook=lambda s_, m_: mets.append(m_))
        checked[k] = ([float(m_["nll"]) for m_ in mets],
                      [float(m_["deranged"]) for m_ in mets],
                      [p.detach().clone() for p in state_k.model.parameters()],
                      train_state.MultiStep.replays - replays0)
    (nll_1, der_1, w_1, _), (nll_k, der_k, w_k, replays_k) = checked[1], checked[K_DISPATCH]
    if len(nll_1) != K_CHECK or len(nll_k) != K_CHECK or der_k != der_1:
        fail(f"k={K_DISPATCH} vs k=1: {len(nll_k)} and {len(nll_1)} steps, deranged "
             f"steps {der_k} vs {der_1}")
    for i, (a_, b_) in enumerate(zip(nll_k, nll_1)):
        rtol = CPU_NLL_RTOL1 if i == 0 else CPU_NLL_RTOL
        if abs(a_ - b_) > rtol * abs(b_):
            fail(f"k={K_DISPATCH} vs k=1, step {i + 1}: nll {a_} vs {b_} (rtol {rtol})")
    e_w = max((p - q).abs().max().item() for p, q in zip(w_k, w_1))
    if e_w > CPU_PARAM_ATOL:
        fail(f"k={K_DISPATCH} vs k=1: weights max|d| {e_w:.3e} > {CPU_PARAM_ATOL}")
    deranged_steps = [i + 1 for i, v in enumerate(der_1) if v]
    rates = {state_k.schedule(0), state_k.schedule(K_CHECK - 1)}
    if (replays_k != K_CHECK // K_DISPATCH - 1 or len(rates) != 2
            or not any(s_ > 2 * K_DISPATCH for s_ in deranged_steps)):
        fail(f"k={K_DISPATCH} check: {replays_k} replays, rates {sorted(rates)}, deranged "
             f"steps {deranged_steps}: it must replay on fresh blocks, cross a rate "
             "change and derange in a replay after the first")
    print(f"check k={K_DISPATCH} (an eager block, the captured one, {replays_k - 1} more "
          f"replays) vs k=1: nll of {K_CHECK} steps within rtol {CPU_NLL_RTOL1}/"
          f"{CPU_NLL_RTOL} (largest relative "
          f"{max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(nll_k, nll_1)):.3e}), deranged "
          f"steps {deranged_steps} alike, rates {sorted(rates)}, weights max|d| "
          f"{e_w:.3e} <= {CPU_PARAM_ATOL}  ok")
    out["k_steps_weights_max_abs_diff"] = e_w
    out["k_steps_check"] = {"steps": K_CHECK, "replays": replays_k,
                            "deranged_steps": deranged_steps, "rates": sorted(rates),
                            "nll_max_rel_diff": max(abs(a_ - b_) / abs(b_)
                                                    for a_, b_ in zip(nll_k, nll_1))}
    k_runs = []
    for k in (1, K_DISPATCH):
        hp_k.steps_per_dispatch = k
        trace = LoopTrace(K_WARM, K_WINDOW)
        replays0 = train_state.MultiStep.replays
        reset_launches()
        train_loop.train(hp_k, seed=SEED, max_steps=trace.max_steps, device="cuda",
                         corpus=corpus_k, verbose=False, step_hook=trace)
        torch.cuda.synchronize()
        counts = read_launches()
        replays = train_state.MultiStep.replays - replays0
        if counts["seq_bwd"] != trace.max_steps:
            fail(f"k={k}: seq_bwd launched {counts['seq_bwd']} times in "
                 f"{trace.max_steps} steps (a replay must count its launches)")
        if replays != (trace.max_steps // k - 1 if k > 1 else 0):
            fail(f"k={k}: {replays} graph replays in {trace.max_steps} steps")
        window = trace.summary(f"train_loop_k{k}")
        k_runs.append({"k": k, "replays": replays, "launches": counts,
                       "loop_ms_per_step": window["untraced_wall_ms_per_step"],
                       "trace": window})
        print(f"train k={k} (device cache on): {trace.max_steps} steps, {replays} graph "
              f"replays; loop {window['untraced_wall_ms_per_step']:.3f} ms/step, traced "
              f"{window['wall_ms_per_call']:.3f} ms/step wall, "
              f"{window['device_ms_per_call']:.3f} ms/step on the card, idle share "
              f"{window['idle_share']:.3f}; launches {counts}")
    out["k_steps"] = k_runs

    # -- the bf16 wire, the device cache off ------------------------------------
    hp_k.steps_per_dispatch, hp_k.device_data_cache, hp_k.wire_dtype = 1, "off", "bf16"
    train_k, _ = train_loop.load_datasets(hp_k, corpus_k)
    wire = train_loop.batch_transfer(train_k, dev, None, wire_bf16=True)
    sels = list(train_k.epoch_index_batches(b_tr, rng=np.random.default_rng([SEED, 0]),
                                            shuffle=True, drop_last=True))[:4]
    for sel in sels:
        got = receive(wire(sel))
        for kk, v in gather_host(train_k, sel).items():
            ref = v.to(torch.bfloat16).float()
            if not torch.equal(got[kk].cpu().view(torch.int32), ref.view(torch.int32)):
                fail(f"bf16 wire: batch {kk} differs from the bf16-rounded host batch")
    trace = LoopTrace(3, 4)
    train_loop.train(hp_k, seed=SEED, max_steps=trace.max_steps, device="cuda",
                     corpus=corpus_k, verbose=False, step_hook=trace)
    window = trace.summary("train_loop_wire_bf16")
    out["wire_bf16"] = {"loop_ms_per_step": window["untraced_wall_ms_per_step"],
                        "trace": window}
    print(f"check bf16 wire: {len(sels)} batches bit-equal to the bf16-rounded host "
          f"batches  ok; loop (cache off, bf16 wire) "
          f"{window['untraced_wall_ms_per_step']:.3f} ms/step, idle share "
          f"{window['idle_share']:.3f}")

    # -- the CLI at precision 16 with --profile_dir ---------------------------------
    prof_dir = Path(tmp) / "profile"
    t0 = time.perf_counter()
    train_cli.main([str(REPO / "hparams" / "final_model.yaml"), "--synthetic-data",
                    "--max_steps", "3", "--precision", "16", "--dataset_root", tmp,
                    "--ckpt_dir", str(Path(tmp) / "ck_profile"),
                    "--profile_dir", str(prof_dir)])
    trace_file = prof_dir / "trace.json"
    events = json.loads(trace_file.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels or torch.get_float32_matmul_precision() != "highest":
        fail(f"--profile_dir: {len(kernels)} kernel events in {trace_file}, matmul "
             f"precision left at {torch.get_float32_matmul_precision()}")
    out["profile"] = {"events": len(events), "kernel_events": len(kernels),
                      "bytes": trace_file.stat().st_size,
                      "cli_s": time.perf_counter() - t0}
    print(f"check CLI --precision 16 --profile_dir: 3 steps, trace of "
          f"{trace_file.stat().st_size} bytes with {len(kernels)} kernel events; matmul "
          "precision restored  ok")
    out["step_s"] = time.perf_counter() - t17
    out["launches"] = {"high": mode_launches["high"], "medium": mode_launches["medium"],
                       "ab": ab_launches}
    out["plans"] = mode_plans
    return out


# ---------------------------------------------------------------------------
# Steps 18-20: the widened kernels, tuning, data parallelism
# ---------------------------------------------------------------------------

# Step 18: final_model at the widths of the JAX kernels' envelope that the
# kernels take on padded lanes (C = 54: expression 48, each half of the
# coupling split 27 -> 28) and whose chain weights overflow a cluster's
# shared memory (H = 512, K = 16: the chain's hidden split).
# Each spec's path (2 steps at B=WIDE_BATCH, a validation, 3 pushes) with
# its launches, then every kernel against its plain twin at the limits of
# the final_model checks above.
WIDE_SPECS = (("C=54", {"expression_dim": 48}),
              ("C=54, H=512", {"expression_dim": 48, "hidden_channels": 512}))
WIDE_BATCH = 64
# Step 18's final widths at H = 256 (C = 56, K = 16): the chain's weights
# resident in a cluster of 16, the training pair's hidden split.
WIDE_H256 = ("C=56, H=256", {"hidden_channels": 256})
# Step 18's final widths at H = 1024 (C = 56, K = 16), where both serial
# training kernels take their hidden split (no other plan holds a row): its
# path and its training kernels' rows at WIDE_BATCH; then the widest block,
# K = 32, at WIDE_K32_BATCH rows (kernel rows only). At C = 54, H = 512 both
# plans of both serial kernels are timed (WIDE_BOTH_PLANS).
WIDE_H1024 = ("C=56, H=1024", {"hidden_channels": 1024})
# (the K = 32 rows run half the training path's frames and time one
# replay: their plain twins and the eager loop's 1,800 steps a call are
# most of the step's time)
WIDE_K32, WIDE_K32_BATCH, WIDE_K32_FRAMES = 32, 16, 28
# Step 18's final widths on the sampling chain's hidden split (C = 56,
# K = 16: no cluster holds or streams a step's weights through one block from
# H = 1,152 on), each with its path, and the ceiling's block: the sampling
# kernels alone at the widest H the kernels take, at K = 4.
WIDE_HSPLIT = (("C=56, H=1152", {"hidden_channels": 1152}),
               ("C=56, H=2048", {"hidden_channels": 2048}))
WIDE_CEILING = ("C=56, H=8192, K=4", {"hidden_channels": 8192, "n_steps": 4})
WIDE_HSPLIT_FRAMES = 76
WIDE_BOTH_PLANS = "C=54, H=512"
FWD_OUTPUTS = ("z", "scales", "zs_res", "states_res", "gc")
BWD_OUTPUTS = ("dx", "dstates0", "dgi", "dghn", "dhout", "dzb")
# The whole generated sequence of a widened spec against its plain twin:
# SEQ_LOOSE_ATOL, or WIDE_SEQ_RATIO times the plain twin's own float32 -
# float64 drift where the random flow amplifies rounding more than
# final_model's does (its first SEQ_TIGHT frames are held at the one-frame
# limits either way).
WIDE_SEQ_RATIO = 3.0
# Step 19: the search on final_model over large_hparam_search: a pinned
# sampler seed and worker, so that the 3 trials are the same each run. Seed
# 35 proposes one spec outside the JAX kernels' envelope (H = 64, K = 4: the
# plain path, cheap at K x N = 52) and two inside it that need the widened
# kernels: C = 34 at K = 32, H = 128 (padded lanes, the chain's weights
# resident in a cluster of 16, the sequence kernel) and C = 54 at H = 512,
# K = 4 with an mlp own face (padded lanes, the chain's hidden split, the
# per-frame kernel).
# (Seed 1's three took 149 s, one plain trial at K x N = 1,024 83 s of it.)
# TUNE_STEPS steps each (25 on 40 chunks until the script's time limit
# needed the time; the sampler's first 8 proposals are uniform, so the
# trials' specs do not depend on their values) on a corpus of TUNE_CHUNKS
# train chunks of TUNE_FRAMES frames (at least TUNE_STEPS steps of 256 an
# epoch at every suggested seq_len, 30-90: 16 x 161 windows at 90, so each
# trial validates once, at its end).
TUNE_SEED, TUNE_TRIALS, TUNE_STEPS = 35, 3, 10
TUNE_CHUNKS, TUNE_FRAMES = 16, 250
# Step 20: data-parallel steps at final_model's B=256 against one process:
# world size 1 over NCCL, world size 2 over gloo on the one card (NCCL
# refuses two ranks on one device); step 10's limits.
DDP_STEPS = 5


def _wide_hp(tmp, overrides: dict):
    from lets_face_it_tpu_torch.hparams import load_hparams

    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
    if "expression_dim" in overrides:
        hp.Data["expression_dim"] = overrides["expression_dim"]
        c = hp.Data["expression_dim"] + hp.Data["jaw_dim"] + hp.Data["neck_dim"]
        hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = c
    if "hidden_channels" in overrides:
        hp.Glow["hidden_channels"] = overrides["hidden_channels"]
    if "n_steps" in overrides:
        hp.Glow["K"] = overrides["n_steps"]
    hp.batch_size = WIDE_BATCH
    return hp


def twin_check(name, names, got, ref, ref64, atol, rtol) -> tuple:
    """Each output of a kernel against its plain twin at ``atol`` /
    ``rtol``, or at WIDE_SEQ_RATIO times the twin's own float32 - float64
    distance where that is larger (a wide random flow amplifies rounding)
    -> (largest |diff|, largest own distance)."""
    worst = own_max = 0.0
    for nm, a, r, r64 in zip(names, got, ref, ref64):
        own = (r.double() - r64).abs().max().item()
        worst = max(worst, check_close(f"{name} {nm}", a, r,
                                       max(atol, WIDE_SEQ_RATIO * own), rtol))
        own_max = max(own_max, own)
    print(f"check {name}: max|d| {worst:.3e}, the plain twin's own float32 - "
          f"float64 distance {own_max:.3e}  ok")
    return worst, own_max


def serial_plans_ms(label, spec, tw, fwd_in, bwd_in, ref, ref64, bwd_ref,
                    bwd_ref64, b) -> dict:
    """``seq_fwd`` and ``seq_bwd`` on each of their plans, each against its
    plain twin (``twin_check``) and timed by CUDA-graph replay and through
    the wrapper."""
    from lets_face_it_tpu_torch.ops import train_kernels as tk

    out = {"launcher": {"seq_fwd": tk.seq_fwd_plan_name(spec),
                        "seq_bwd": tk.seq_bwd_plan_name(spec)}}
    cases = [("seq_fwd", p, lambda p=p: tk.seq_fwd(spec, tw, *fwd_in, plan=p),
              FWD_OUTPUTS, ref, ref64, TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)
             for p in tk.SEQ_FWD_PLANS]
    cases += [("seq_bwd", p, lambda p=p: tk.seq_bwd(spec, tw, *bwd_in, plan=p),
               BWD_OUTPUTS, bwd_ref, bwd_ref64, TRAIN_BWD_ATOL, TRAIN_BWD_RTOL)
              for p in tk.SEQ_BWD_PLANS]
    for which, plan, call, names, r, r64, atol, rtol in cases:
        err, own = twin_check(f"{label} {which} {plan}", names, call(), r, r64,
                              atol, rtol)
        out.setdefault(which, {})[plan] = {
            "max_abs_err": err, "own_f64_distance": own,
            "ms": time_ms(graphed(call), 3), "wrapper_ms": time_ms(call, 3),
            "plan": tk.serial_plan(which, spec, b, plan=plan)}
    print(f"{label} both plans at B={b} (the launcher's: seq_fwd "
          f"{out['launcher']['seq_fwd']}, seq_bwd {out['launcher']['seq_bwd']}): "
          + ", ".join(f"{w} {p} {v['ms']:.4f} ms" for w in ("seq_fwd", "seq_bwd")
                      for p, v in out[w].items()))
    return out


def widened_step(tmp, dev, card, records) -> dict:
    """Step 18: every kernel at the widened specs against its plain twin,
    timed beside the library call and its bound, after each spec's path."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk
    from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator
    from lets_face_it_tpu_torch.sample.weights import seeded_random_model
    from lets_face_it_tpu_torch.train import loop as train_loop
    from lets_face_it_tpu_torch.train import state as train_state

    t18 = time.perf_counter()
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    for label, overrides in WIDE_SPECS:
        t_spec = time.perf_counter()
        hp = _wide_hp(tmp, overrides)
        spec = FlowSpec.build(hp)
        ks = fk.kernel_spec(spec)
        if seqglow.training_path(spec) != "kernels" or \
                seqglow.sampling_path(spec) != "sequence":
            fail(f"{label}: outside the kernels' envelope")
        resident = fk.chain_resident(spec)
        placement = fk.chain_placement(spec)
        print(f"step 18, {label}: C={spec.channels} on the kernels' {ks.channels} "
              f"lanes, K={spec.n_steps} H={spec.hidden_channels} "
              f"cond={spec.cond.cond_dim}; chain weights "
              f"{fk.chain_step_bytes(spec) * spec.n_steps / 1e6:.2f} MB, "
              f"placed {placement[0]} in a cluster of {placement[1]}; seq_bwd's "
              f"{tk.seq_bwd_plan_name(spec)} plan")

        # the spec's path: 2 steps, a validation, 3 pushes
        corpus = train_loop.synthetic_corpus(hp, SEED, n_train_chunks=4,
                                             n_val_chunks=1)
        train_ds, val_ds = train_loop.load_datasets(hp, corpus)
        model = seeded_random_model(spec, SEED).to(dev)
        state = train_state.TrainState.create(model, hp, 3, SEED)
        jb = train_loop.to_device(train_ds.get_batch(np.arange(WIDE_BATCH)), dev)
        frame = {kk: jb[kk][:1, 0].cpu().numpy()
                 for kk in ("p2_face", "p1_speech", "p2_speech") if kk in jb}
        reset_launches()
        train_state.run_actnorm_init(spec, state, jb)
        for _ in range(2):
            mets = train_state.train_step(spec, hp, state, jb)
        val = train_loop.run_validation(spec, hp, model, val_ds, dev, 2, SEED)
        s = StreamingGenerator(spec, model, batch_size=1, seed=SEED, device=dev)
        for _ in range(3):
            s.push(**frame)
        torch.cuda.synchronize()
        launches = read_launches()
        require_launches(f"{label} path", launches, kernel_wrappers())
        require_plan(f"{label} path", read_plans(), "seq_bwd", tk.seq_bwd_plan_name(spec))
        require_plan(f"{label} path", read_plans(), "seq_fwd", tk.seq_fwd_plan_name(spec))
        if not (math.isfinite(float(mets["loss"])) and math.isfinite(val["val_loss"])):
            fail(f"{label} path: loss {float(mets['loss'])}, val {val['val_loss']}")
        print(f"{label} path: 2 steps B={WIDE_BATCH}, a validation (val NLL "
              f"{val['val_loss']:.3f}), 3 pushes; launches {launches}")
        del s, state

        k_steps, c, h = spec.n_steps, spec.channels, spec.hidden_channels
        cond, cp, p1 = spec.cond.cond_dim, ks.channels, spec.cond.p1_face.out_dim
        n_seq = hp.Validation["seq_len"] - spec.cond.longest_history
        n_tr = hp.Train["seq_len"] - spec.cond.longest_history
        rows = {}
        with torch.no_grad():
            w = fk.prepare_sampling_weights(spec, model.flow)
            w_p1_t = model.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2).contiguous()
            w_p1_k = fk.pad_history(spec, w_p1_t, 1)
            gru = {"w_ih": w.w_ih_t.transpose(1, 2).contiguous(),
                   "w_hh": w.w_hh_t.transpose(1, 2).contiguous(),
                   "b_ih": w.b_ih, "b_hh": w.b_hh}
            pad = lambda t: fk.pad_lanes(spec, t)  # noqa: E731
            unpad = lambda t: fk.unpad_lanes(spec, t)  # noqa: E731

            # frame_rev at B=1 (a push), through its logical wrapper
            z, projs, st = randn(1, c), randn(k_steps, 1, cond), randn(k_steps, 1, h, scale=0.5)
            x, st_new = fk.frame_rev_fused(spec, w, z, projs, st)
            x_r, st_r = fk.frame_rev_fused_ref(ks, w, pad(z), projs, st)
            err = max(check_close(f"{label} frame_rev x", x, unpad(x_r)),
                      check_close(f"{label} frame_rev states", st_new, st_r))
            call = lambda: fk.frame_rev_fused(spec, w, z, projs, st)  # noqa: E731
            rows["frame_rev"] = dict(
                batch=1, max_abs_err=err, chain_plan=fk.chain_plan(spec, 1),
                ms=time_ms(graphed(call), 20),
                wrapper_ms=time_ms(call, 20),
                plain_ms=time_ms(lambda: fk.frame_rev_fused_ref(ks, w, pad(z), projs, st), 3),
                library_ms=time_ms(graphed(lambda: library_frame_rev(
                    ks, w, gru, pad(z), projs, st)), 20),
                **dict(zip(("bound_ms", "bound_by"), frame_bound_ms(ks, w, 1))))

            # seq_rev at B=1 over a validation's frames
            zs, fixed = randn(n_seq, 1, c), randn(n_seq, k_steps, 1, cond)
            hist0, st0 = randn(1, p1), torch.zeros(k_steps, 1, h, device=dev)
            xs = fk.sequence_rev_fused(spec, w, w_p1_t, zs, fixed, hist0, st0)
            ref_args = (ks, w, w_p1_k, pad(zs), fixed, fk.pad_history(spec, hist0, 1), st0)
            xs_r, seq_plain = timed(lambda: fk.sequence_rev_fused_ref(*ref_args))
            xs_r = unpad(xs_r)
            xs_64 = unpad(fk.sequence_rev_fused_ref(
                ks, weights64(w), *(t.double() for t in ref_args[2:])))
            check_close(f"{label} seq_rev first {SEQ_TIGHT} frames", xs[:SEQ_TIGHT],
                        xs_r[:SEQ_TIGHT])
            own = (xs_r.double() - xs_64).abs().max().item()
            print(f"{label} seq_rev all {n_seq} frames: kernel vs plain "
                  f"{json.dumps(drift(xs, xs_r))}; plain float32 vs float64 "
                  f"{json.dumps(drift(xs_r, xs_64))}; max|x| "
                  f"{xs_64.abs().max().item():.2f}")
            err = check_close(f"{label} seq_rev all frames", xs, xs_r,
                              atol=max(SEQ_LOOSE_ATOL, WIDE_SEQ_RATIO * own), rtol=0.0)
            call = lambda: fk.sequence_rev_fused(  # noqa: E731
                spec, w, w_p1_t, zs, fixed, hist0, st0)
            rows["seq_rev"] = dict(
                batch=1, frames=n_seq, max_abs_err=err,
                ms=time_ms(graphed(call), 3, warmup=1), wrapper_ms=time_ms(call, 3, warmup=1),
                plain_ms=seq_plain,
                library_ms=time_ms(graphed(lambda: library_seq_rev(
                    ks, w, gru, w_p1_k, *ref_args[3:])), 3, warmup=1),
                **dict(zip(("bound_ms", "bound_by"), seq_bound_ms(ks, w, n_seq, 1))))

            # the gates and the chain alone, in the kernels' lanes, at B=1
            # with the own face (a generated frame)
            hist = fk.pad_history(spec, randn(1, p1), 1)
            z_k = pad(randn(1, c))
            gates = lambda: fk.sample_gates(ks, w, w_p1_k, projs, hist, st)  # noqa: E731
            got = gates()
            ref = fk.sample_gates_ref(ks, w, w_p1_k, projs, hist, st)
            err = max(check_close(f"{label} sample_gates {nm}", a_, r_)
                      for nm, a_, r_ in zip(("proj", "gc", "gh"), got, ref))
            rows["sample_gates"] = dict(
                batch=1, max_abs_err=err, ms=time_ms(graphed(gates), 20),
                wrapper_ms=time_ms(gates, 20),
                plain_ms=time_ms(lambda: fk.sample_gates_ref(ks, w, w_p1_k, projs, hist, st), 5),
                library_ms=time_ms(graphed(lambda: library_gates(
                    ks, w, w_p1_k, projs, hist, st)), 20),
                **dict(zip(("bound_ms", "bound_by"), gates_bound_ms(ks, 1, ks.cond.p1_face.out_dim))))
            _, gc, gh = ref
            # the launcher's plan (resident=None), and the streaming variant
            # beside it (resident=False)
            chain = {}
            for place in (None, False):
                call = lambda: fk.sample_chain(  # noqa: E731
                    ks, w, z_k, gc, gh, st, hist, resident=place)
                got = call()
                ref_c = fk.sample_chain_ref(ks, w, z_k, gc, gh, st, hist)
                err = max(check_close(f"{label} sample_chain resident={place} {nm}", a_, r_)
                          for nm, a_, r_ in zip(("x", "states", "hist"), got, ref_c))
                chain[place] = (err, time_ms(graphed(call), 20), time_ms(call, 20))
            plan = fk.chain_plan(spec, 1)
            print(f"{label} chain plan at B=1: {json.dumps(plan)}")
            chain_plain = time_ms(lambda: fk.sample_chain_ref(ks, w, z_k, gc, gh, st, hist), 5)
            rows["sample_chain"] = dict(
                batch=1, resident=resident, max_abs_err=chain[None][0],
                ms=chain[None][1], wrapper_ms=chain[None][2],
                plain_ms=chain_plain, library_ms=time_ms(graphed(
                    lambda: fk.sample_chain_ref(ks, w, z_k, gc, gh, st, hist)), 20),
                plan=plan, streaming_ms=chain[False][1],
                streaming_max_abs_err=chain[False][0],
                **dict(zip(("bound_ms", "bound_by"),
                           chain_bound_ms(ks, w, 1, ks.cond.p1_face.out_dim))))

            # the training kernels in the kernels' lanes at B=WIDE_BATCH
            b = WIDE_BATCH
            tw = tk.TrainWeights(*(t.detach() for t in tk.prepare_train_weights(
                spec, model.flow)))
            xs_t = pad(randn(n_tr, b, c))
            cs, st_t = randn(n_tr, k_steps, b, cond), randn(k_steps, b, h, scale=0.3)
            gates_err = check_close(f"{label} cond_gates", tk.cond_gates(ks, tw, cs),
                                    tk.cond_gates_ref(ks, tw, cs),
                                    TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)
            # cond_gates at every mode on its launcher's plan: at "highest"
            # against the float64 product, at the reduced modes against its
            # plain twin at the mode, one product deep (the controls too)
            tw64 = tk.TrainWeights(*(t.double() for t in tw))
            gates_rms = f64_rms_check(f"{label} cond_gates", tk.cond_gates(ks, tw, cs),
                                      tk.cond_gates_ref(ks, tw, cs),
                                      tk.cond_gates_ref(ks, tw64, cs.double()))
            gates_modes = {}
            for prec in MODES_CHECKED:
                m = fk.MODES[prec]
                got_m = tk.cond_gates(ks, tw, cs, precision=prec)
                ref_m = tk.cond_gates_ref(ks, tw, cs, m)
                reading = mode_check(f"{label} cond_gates", got_m, ref_m,
                                     tk.cond_gates_ref(ks, tw64, cs.double(), m), prec)
                real, ctrl = shallow_check(
                    f"{label} cond_gates", prec, got_m, ref_m,
                    {p_: tk.cond_gates(ks, tw, cs, precision=p_)
                     for p_ in ("highest",) + MODES_CHECKED if p_ != prec})
                gates_modes[prec] = {
                    "plan": tk.cond_gates_plan(m)[0], "max_abs_err_grid_steps": reading[0],
                    "rms_err_grid_steps": reading[1], "first_step_rms_grid_steps": real,
                    "control_least_rms_grid_steps": min(ctrl.values()),
                    "ms": time_ms(graphed(lambda: tk.cond_gates(ks, tw, cs,
                                                                precision=prec)), 3)}
                del got_m, ref_m
            del tw64
            print(f"check {label} cond_gates at the reduced modes (largest |diff|, rms "
                  "and first-step rms in grid steps; the least control): "
                  + ", ".join(f"{p_} {v['max_abs_err_grid_steps']:.3f}/"
                              f"{v['rms_err_grid_steps']:.4f}/"
                              f"{v['first_step_rms_grid_steps']:.4f}/"
                              f"{v['control_least_rms_grid_steps']:.4f} {v['ms']:.4f} ms"
                              for p_, v in gates_modes.items()) + "  ok")
            got = tk.seq_fwd(ks, tw, xs_t, cs, st_t)
            ref, fwd_plain = timed(lambda: tk.seq_fwd_ref(ks, tw, xs_t, cs, st_t))
            fwd_err = max(check_close(f"{label} seq_fwd {nm}", a_, r_,
                                      TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)
                          for nm, a_, r_ in zip(("z", "scales", "zs_res", "states_res",
                                                 "gc"), got, ref))
            _, scales_r, zs_res, st_res, gc_t = ref
            hprev = torch.cat([st_t[None], st_res[:-1]])
            # the padded lanes' cotangents are zero, as the Function's
            cot = (pad(randn(n_tr, b, c)),
                   torch.nn.functional.pad(randn(n_tr, k_steps, b, c // 2),
                                           (0, cp // 2 - c // 2)),
                   randn(k_steps, b, h))
            got = tk.seq_bwd(ks, tw, gc_t, zs_res, hprev, *cot)
            bwd_ref, bwd_plain = timed(lambda: tk.seq_bwd_ref(ks, tw, gc_t, zs_res,
                                                              hprev, *cot))
            bwd_err = max(check_close(f"{label} seq_bwd {nm}", a_, r_,
                                      TRAIN_BWD_ATOL, TRAIN_BWD_RTOL)
                          for nm, a_, r_ in zip(BWD_OUTPUTS, got, bwd_ref))
            gates_call = lambda: tk.cond_gates(ks, tw, cs)  # noqa: E731
            fwd_call = lambda: tk.seq_fwd(ks, tw, xs_t, cs, st_t)  # noqa: E731
            bwd_call = lambda: tk.seq_bwd(ks, tw, gc_t, zs_res, hprev, *cot)  # noqa: E731
            lib_a = torch.nn.functional.leaky_relu(cs, 0.01).permute(1, 0, 2, 3).reshape(
                k_steps, -1, cond).contiguous()
            lib_w = tw.w_ih_t[:, ks.z1_dim:].contiguous()
            lib_b = tw.b_ih[:, None, :].contiguous()
            xs_l = unpad(xs_t)
            rows["cond_gates"] = dict(
                batch=b, frames=n_tr, max_abs_err=gates_err, plan=tk.cond_gates_plan(0)[0],
                rms_from_float64=gates_rms, at_modes=gates_modes,
                plans_ms=cond_plans_ms(ks, tw, cs, "highest", 3),
                ms=time_ms(graphed(gates_call), 3), wrapper_ms=time_ms(gates_call, 3),
                plain_ms=time_ms(lambda: tk.cond_gates_ref(ks, tw, cs), 3),
                library_ms=time_ms(graphed(lambda: torch.baddbmm(lib_b, lib_a, lib_w)), 3),
                **dict(zip(("bound_ms", "bound_by"), cond_gates_bound_ms(ks, n_tr, b))))
            rows["seq_fwd"] = dict(
                batch=b, frames=n_tr, max_abs_err=fwd_err,
                ms=time_ms(graphed(fwd_call), 3), wrapper_ms=time_ms(fwd_call, 3),
                plain_ms=fwd_plain,
                library_ms=time_ms(graphed(lambda: eager_flow_sequence(
                    spec, model.flow, xs_l, cs, st_t), EAGER_RECAPTURE_WARMUP), 3),
                **dict(zip(("bound_ms", "bound_by"), train_fwd_bound_ms(ks, tw, n_tr, b))))
            bwd_ms, bwd_wrap = time_ms(graphed(bwd_call), 3), time_ms(bwd_call, 3)
            bwd_plan = tk.serial_plan("seq_bwd", ks, b)
            print(f"{label} seq_bwd plan at B={b}: {json.dumps(bwd_plan)}")
            both = None
            if label == WIDE_BOTH_PLANS:
                tw64 = tk.TrainWeights(*(t.double() for t in tw))
                fwd_in = (xs_t, cs, st_t)
                bwd_in = (gc_t, zs_res, hprev, *cot)
                both = serial_plans_ms(
                    label, ks, tw, fwd_in, bwd_in, ref, tk.seq_fwd_ref(
                        ks, tw64, *(t.double() for t in fwd_in)),
                    bwd_ref, tk.seq_bwd_ref(ks, tw64, *(t.double() for t in bwd_in)), b)
                del tw64
        # the library backward: the eager loop's autograd backward
        cot_l = (unpad(cot[0]), cot[1][..., :c // 2], cot[2])
        lib_bwd = library_backward_ms(spec, model.flow, (xs_l, cs, st_t), cot_l,
                                      "highest", 3, EAGER_RECAPTURE_WARMUP)
        rows["seq_bwd"] = dict(
            batch=b, frames=n_tr, max_abs_err=bwd_err, plan=bwd_plan, ms=bwd_ms,
            wrapper_ms=bwd_wrap,
            plain_ms=bwd_plain, library_ms=lib_bwd,
            **dict(zip(("bound_ms", "bound_by"), train_bwd_bound_ms(ks, tw, n_tr, b))))
        rows["seq_fwd"]["plan"] = tk.serial_plan("seq_fwd", ks, b)
        if both:
            rows["seq_fwd"]["plans"] = both["seq_fwd"]
            rows["seq_bwd"]["plans"] = both["seq_bwd"]
        for name, row in rows.items():
            records.append(dict(name=name, widened=label, route="cuda",
                                source=row_source(name, row),
                                replaces=f"lets_face_it_tpu/ops/{KERNEL_SOURCES[name][1]}",
                                launches=launches[name], **row))
            extra = (f", streaming variant {row['streaming_ms']:.4f} ms"
                     if "streaming_ms" in row else "")
            print(f"{label} {name} B={row['batch']}: max|d| {row['max_abs_err']:.3e}; "
                  f"kernel {row['ms']:.4f} ms (graph replay; {row['wrapper_ms']:.4f} "
                  f"through the wrapper){extra}, plain {row['plain_ms']:.4f} ms, "
                  f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})  ok")
        out[label] = {"launches": launches, "val_loss": val["val_loss"],
                      "chain_resident": resident, "chain_placement": list(placement),
                      "kernel_channels": ks.channels,
                      "spec_s": time.perf_counter() - t_spec}
        print(f"step 18, {label}: {out[label]['spec_s']:.1f} s")
        del model, w, tw
        torch.cuda.empty_cache()
    t_spec = time.perf_counter()
    out[WIDE_H256[0]] = wide_h256_rows(tmp, dev, records)
    print(f"step 18, {WIDE_H256[0]}: {time.perf_counter() - t_spec:.1f} s")
    t_spec = time.perf_counter()
    out[WIDE_H1024[0]] = wide_h1024_rows(tmp, dev, records)
    print(f"step 18, {WIDE_H1024[0]}: {time.perf_counter() - t_spec:.1f} s")
    for label, overrides in WIDE_HSPLIT:
        t_spec = time.perf_counter()
        out[label] = wide_hsplit_rows(tmp, dev, label, overrides, records)
        print(f"step 18, {label}: {time.perf_counter() - t_spec:.1f} s")
    t_spec = time.perf_counter()
    out[WIDE_CEILING[0]] = wide_ceiling_rows(tmp, dev, records)
    print(f"step 18, {WIDE_CEILING[0]}: {time.perf_counter() - t_spec:.1f} s")
    out["step_s"] = time.perf_counter() - t18
    return out


def wide_path(tmp, dev, label, overrides, n_steps: int, invert: bool = False,
              scaled_head: bool = False) -> tuple:
    """A widened spec's path on seeded random weights: ``run_actnorm_init``,
    ``n_steps`` training steps at B=WIDE_BATCH, a validation and 3 pushes at
    B=1, with every path kernel required among the launches, each serial
    training kernel on its launcher's plan, and a finite loss -> (hp, spec,
    model, the last step's metrics, the validation's, launches, plans).
    ``invert``: the validation checks the invertibility too
    (``sequence_invert``), which must launch ``frame_rev``; ``scaled_head``:
    the weights' coupling heads perturbed for the width
    (``seeded_random_model(width_scaled_head=True)``)."""
    import numpy as np
    import torch

    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk
    from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator
    from lets_face_it_tpu_torch.sample.weights import seeded_random_model
    from lets_face_it_tpu_torch.train import loop as train_loop
    from lets_face_it_tpu_torch.train import state as train_state

    hp = _wide_hp(tmp, overrides)
    hp.Validation["check_invertion"] = hp.Validation.get("check_invertion") or invert
    spec = FlowSpec.build(hp)
    corpus = train_loop.synthetic_corpus(hp, SEED, n_train_chunks=4, n_val_chunks=1)
    train_ds, val_ds = train_loop.load_datasets(hp, corpus)
    model = seeded_random_model(spec, SEED, width_scaled_head=scaled_head).to(dev)
    state = train_state.TrainState.create(model, hp, 3, SEED)
    jb = train_loop.to_device(train_ds.get_batch(np.arange(WIDE_BATCH)), dev)
    frame = {kk: jb[kk][:1, 0].cpu().numpy()
             for kk in ("p2_face", "p1_speech", "p2_speech") if kk in jb}
    reset_launches()
    train_state.run_actnorm_init(spec, state, jb)
    for _ in range(n_steps):
        mets = train_state.train_step(spec, hp, state, jb)
    before = fk.frame_rev_fused.launches
    val = train_loop.run_validation(spec, hp, model, val_ds, dev, n_steps, SEED)
    if invert and not (fk.frame_rev_fused.launches > before and math.isfinite(
            val["reconstruction/error_percentage"])):
        fail(f"{label} path: the validation's inversion launched frame_rev "
             f"{fk.frame_rev_fused.launches - before} times, error "
             f"{val.get('reconstruction/error_percentage')}")
    s = StreamingGenerator(spec, model, batch_size=1, seed=SEED, device=dev)
    for _ in range(3):
        s.push(**frame)
    torch.cuda.synchronize()
    launches, plans = read_launches(), read_plans()
    require_launches(f"{label} path", launches, ("frame_rev", "seq_rev", "cond_gates",
                                                 "seq_fwd", "seq_bwd"))
    require_plan(f"{label} path", plans, "seq_bwd", tk.seq_bwd_plan_name(spec))
    require_plan(f"{label} path", plans, "seq_fwd", tk.seq_fwd_plan_name(spec))
    if not (math.isfinite(float(mets["loss"])) and math.isfinite(val["val_loss"])):
        fail(f"{label} path: loss {float(mets['loss'])}, val {val['val_loss']}")
    return hp, spec, model, mets, val, launches, plans


def wide_h256_rows(tmp, dev, records) -> dict:
    """Step 18 at final widths and H = 256 (``WIDE_H256``): one training
    step, a validation and 3 pushes at B=1 (the launches), then the chain's
    wide plan (the weights resident in a cluster of 16) through
    ``frame_rev`` B=1 and 64 and ``seq_rev`` B=1 over a validation's
    frames, and ``seq_fwd`` and ``seq_bwd`` on their launchers' plans at
    B=WIDE_BATCH (``serial_kernel_rows``): each against its plain twin at
    step 18's limits, timed beside its library call and bound."""
    import torch

    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk

    label, overrides = WIDE_H256
    hp, spec, model, mets, val, launches, plans = wide_path(tmp, dev, label, overrides, 1)
    ks = fk.kernel_spec(spec)
    place, cluster = fk.chain_placement(spec)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    print(f"step 18, {label}: K={spec.n_steps} H={spec.hidden_channels}; the chain "
          f"{place} in a cluster of {cluster}, seq_fwd {tk.seq_fwd_plan_name(spec)}, "
          f"seq_bwd {tk.seq_bwd_plan_name(spec)}; "
          f"path: a step B={WIDE_BATCH}, a validation (val NLL {val['val_loss']:.3f}), "
          f"3 pushes; launches {launches}")

    k_steps, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    cond, p1 = spec.cond.cond_dim, spec.cond.p1_face.out_dim
    n_seq = hp.Validation["seq_len"] - spec.cond.longest_history
    n_tr = hp.Train["seq_len"] - spec.cond.longest_history
    rows = {}
    with torch.no_grad():
        w = fk.prepare_sampling_weights(spec, model.flow)
        w_p1_t = model.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2).contiguous()
        gru = {"w_ih": w.w_ih_t.transpose(1, 2).contiguous(),
               "w_hh": w.w_hh_t.transpose(1, 2).contiguous(),
               "b_ih": w.b_ih, "b_hh": w.b_hh}
        for b in (1, WIDE_BATCH):
            z, projs = randn(b, c), randn(k_steps, b, cond)
            st = randn(k_steps, b, h, scale=0.5)
            x, st_new = fk.frame_rev_fused(spec, w, z, projs, st)
            x_r, st_r = fk.frame_rev_fused_ref(ks, w, z, projs, st)
            err = max(check_close(f"{label} frame_rev B={b} x", x, x_r),
                      check_close(f"{label} frame_rev B={b} states", st_new, st_r))
            call = lambda: fk.frame_rev_fused(spec, w, z, projs, st)  # noqa: E731
            rows[f"frame_rev B={b}"] = ("frame_rev", dict(
                batch=b, max_abs_err=err, chain_plan=fk.chain_plan(spec, b),
                ms=time_ms(graphed(call), 20), wrapper_ms=time_ms(call, 20),
                plain_ms=time_ms(lambda: fk.frame_rev_fused_ref(ks, w, z, projs, st), 3),
                library_ms=time_ms(graphed(lambda: library_frame_rev(
                    ks, w, gru, z, projs, st)), 20),
                **dict(zip(("bound_ms", "bound_by"), frame_bound_ms(ks, w, b)))))

        zs, fixed = randn(n_seq, 1, c), randn(n_seq, k_steps, 1, cond)
        hist0, st0 = randn(1, p1), torch.zeros(k_steps, 1, h, device=dev)
        xs = fk.sequence_rev_fused(spec, w, w_p1_t, zs, fixed, hist0, st0)
        ref_args = (ks, w, w_p1_t, zs, fixed, hist0, st0)
        xs_r, seq_plain = timed(lambda: fk.sequence_rev_fused_ref(*ref_args))
        xs_64 = fk.sequence_rev_fused_ref(ks, weights64(w), *(t.double() for t in ref_args[2:]))
        check_close(f"{label} seq_rev first {SEQ_TIGHT} frames", xs[:SEQ_TIGHT],
                    xs_r[:SEQ_TIGHT])
        own = (xs_r.double() - xs_64).abs().max().item()
        print(f"{label} seq_rev all {n_seq} frames: kernel vs plain "
              f"{json.dumps(drift(xs, xs_r))}; plain float32 vs float64 "
              f"{json.dumps(drift(xs_r, xs_64))}")
        err = check_close(f"{label} seq_rev all frames", xs, xs_r,
                          atol=max(SEQ_LOOSE_ATOL, WIDE_SEQ_RATIO * own), rtol=0.0)
        call = lambda: fk.sequence_rev_fused(  # noqa: E731
            spec, w, w_p1_t, zs, fixed, hist0, st0)
        rows["seq_rev"] = ("seq_rev", dict(
            batch=1, frames=n_seq, max_abs_err=err, chain_plan=fk.chain_plan(spec, 1),
            ms=time_ms(graphed(call), 3, warmup=1), wrapper_ms=time_ms(call, 3, warmup=1),
            plain_ms=seq_plain,
            library_ms=time_ms(graphed(lambda: library_seq_rev(
                ks, w, gru, *ref_args[2:])), 3, warmup=1),
            **dict(zip(("bound_ms", "bound_by"), seq_bound_ms(ks, w, n_seq, 1)))))

    serial = serial_kernel_rows(label, spec, model, n_tr, WIDE_BATCH, randn, 3,
                                bwd_twin=False, walk_ms=True)
    rows.update((name, (name, row)) for name, row in serial.items())
    for key, (name, row) in rows.items():
        records.append(dict(name=name, widened=label, route="cuda",
                            source=row_source(name, row),
                            replaces=f"lets_face_it_tpu/ops/{KERNEL_SOURCES[name][1]}",
                            launches=launches[name], **row))
        extra = (f", the walk plan {row['walk_plan_ms']:.4f} ms"
                 if "walk_plan_ms" in row else "")
        print(f"{label} {key}: max|d| {row['max_abs_err']:.3e}; kernel {row['ms']:.4f} ms "
              f"(graph replay; {row['wrapper_ms']:.4f} through the wrapper){extra}, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  ok")
    del model, w
    torch.cuda.empty_cache()
    return {"launches": launches, "plans": plans, "val_loss": val["val_loss"],
            "chain_placement": [place, cluster]}


def serial_kernel_rows(label, spec, model, n_tr: int, b: int, randn, reps: int, *,
                       bwd_twin: bool = True, walk_ms: bool = False) -> dict:
    """``seq_fwd`` and ``seq_bwd`` on the launchers' plans at B=b, N=n_tr:
    the forward against its plain twin (``twin_check``: the training limits
    or WIDE_SEQ_RATIO times the twin's own float32 - float64 distance), the
    backward on the plain forward's residuals against its plain twin the
    same way at the backward's limits (``bwd_twin`` False: at those limits
    alone), each timed (``reps`` replays) beside the eager loop's forward
    and autograd backward and the bound; ``walk_ms``: each kernel's walk
    plan timed too."""
    import torch

    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk

    ks = fk.kernel_spec(spec)
    k_steps, c, h, cond = ks.n_steps, ks.channels, ks.hidden_channels, ks.cond.cond_dim
    rows = {}
    with torch.no_grad():
        tw = tk.TrainWeights(*(t.detach() for t in tk.prepare_train_weights(
            spec, model.flow)))
        tw64 = tk.TrainWeights(*(t.double() for t in tw))
        fwd_in = (randn(n_tr, b, c), randn(n_tr, k_steps, b, cond),
                  randn(k_steps, b, h, scale=0.3))
        got = tk.seq_fwd(ks, tw, *fwd_in)
        ref, fwd_plain = timed(lambda: tk.seq_fwd_ref(ks, tw, *fwd_in))
        fwd_err, fwd_own = twin_check(
            f"{label} K={k_steps} seq_fwd", FWD_OUTPUTS, got, ref,
            tk.seq_fwd_ref(ks, tw64, *(t.double() for t in fwd_in)),
            TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)
        _, _, zs_res, st_res, gc_t = ref
        hprev = torch.cat([fwd_in[2][None], st_res[:-1]])
        bwd_in = (gc_t, zs_res, hprev, randn(n_tr, b, c), randn(n_tr, k_steps, b, c // 2),
                  randn(k_steps, b, h))
        del got, ref
        got = tk.seq_bwd(ks, tw, *bwd_in)
        bwd_ref, bwd_plain = timed(lambda: tk.seq_bwd_ref(ks, tw, *bwd_in))
        if bwd_twin:
            bwd_err, bwd_own = twin_check(
                f"{label} K={k_steps} seq_bwd", BWD_OUTPUTS, got, bwd_ref,
                tk.seq_bwd_ref(ks, tw64, *(t.double() for t in bwd_in)),
                TRAIN_BWD_ATOL, TRAIN_BWD_RTOL)
        else:
            bwd_err = max(check_close(f"{label} seq_bwd {nm}", a_, r_,
                                      TRAIN_BWD_ATOL, TRAIN_BWD_RTOL)
                          for nm, a_, r_ in zip(BWD_OUTPUTS, got, bwd_ref))
            bwd_own = None
        del got, bwd_ref, tw64
        calls = {"seq_fwd": lambda plan=None: tk.seq_fwd(ks, tw, *fwd_in, plan=plan),
                 "seq_bwd": lambda plan=None: tk.seq_bwd(ks, tw, *bwd_in, plan=plan)}
        for name, err, own, plain, bound in (
                ("seq_fwd", fwd_err, fwd_own, fwd_plain,
                 train_fwd_bound_ms(ks, tw, n_tr, b)),
                ("seq_bwd", bwd_err, bwd_own, bwd_plain,
                 train_bwd_bound_ms(ks, tw, n_tr, b))):
            call = calls[name]
            rows[name] = dict(
                batch=b, frames=n_tr, n_steps=k_steps, max_abs_err=err,
                own_f64_distance=own, plan=tk.serial_plan(name, ks, b),
                ms=time_ms(graphed(call, 1), reps, warmup=1),
                wrapper_ms=time_ms(call, reps, warmup=1),
                plain_ms=plain, **dict(zip(("bound_ms", "bound_by"), bound)))
            if walk_ms:
                rows[name]["walk_plan_ms"] = time_ms(
                    graphed(lambda: call("walk"), 1), reps, warmup=1)
        rows["seq_fwd"]["library_ms"] = time_ms(graphed(lambda: eager_flow_sequence(
            spec, model.flow, *fwd_in), EAGER_RECAPTURE_WARMUP), reps, warmup=1)
    rows["seq_bwd"]["library_ms"] = library_backward_ms(
        spec, model.flow, fwd_in, bwd_in[3:], "highest", reps, EAGER_RECAPTURE_WARMUP)
    return rows


def row_source(name: str, row: dict) -> str:
    """The source a kernel row ran: the hidden split's where the row's
    launch plan is it (``HSPLIT_SOURCES``), else the kernel's own
    (``KERNEL_SOURCES``)."""
    plan = row.get("plan")
    hsplit = isinstance(plan, dict) and "hsplit" in (plan.get("plan"), plan.get("place"))
    return ("lets_face_it_tpu_torch/"
            + (HSPLIT_SOURCES[name] if hsplit else KERNEL_SOURCES[name][0]))


def wide_h1024_rows(tmp, dev, records) -> dict:
    """Step 18 at final widths and H = 1024 (``WIDE_H1024``), where both
    serial training kernels take the hidden split: the path (``wide_path``,
    2 training steps) on it, then ``seq_fwd`` and ``seq_bwd`` at
    B=WIDE_BATCH and at K = WIDE_K32, B=WIDE_K32_BATCH, N=WIDE_K32_FRAMES
    (``serial_kernel_rows``)."""
    import torch

    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk
    from lets_face_it_tpu_torch.sample.weights import seeded_random_model

    t0 = time.perf_counter()
    label, overrides = WIDE_H1024
    hp, spec, model, mets, val, launches, plans = wide_path(tmp, dev, label, overrides, 2)
    if tk.seq_fwd_plan_name(spec) != "hsplit" or tk.seq_bwd_plan_name(spec) != "hsplit":
        fail(f"{label}: the serial training kernels' plans are not the hidden split")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    place, cluster = fk.chain_placement(spec)
    print(f"step 18, {label}: K={spec.n_steps} H={spec.hidden_channels}; seq_fwd "
          f"{tk.seq_fwd_plan_name(spec)}, seq_bwd {tk.seq_bwd_plan_name(spec)}, the "
          f"chain {place} in a cluster of {cluster}; path: 2 steps B={WIDE_BATCH} "
          f"(loss {float(mets['loss']):.3f}), a validation (val NLL "
          f"{val['val_loss']:.3f}), 3 pushes ({time.perf_counter() - t0:.1f} s); "
          f"launches {launches}, plans {plans}")
    n_tr = hp.Train["seq_len"] - spec.cond.longest_history
    t0 = time.perf_counter()
    rows = [(serial_kernel_rows(label, spec, model, n_tr, WIDE_BATCH, randn, 3),
             launches)]
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    hp32 = _wide_hp(tmp, {**overrides, "n_steps": WIDE_K32})
    spec32 = FlowSpec.build(hp32)
    model32 = seeded_random_model(spec32, SEED).to(dev)
    # no path runs at K = 32: its rows count the launches of their own calls
    reset_launches()
    rows.append((serial_kernel_rows(label, spec32, model32, WIDE_K32_FRAMES,
                                    WIDE_K32_BATCH, randn, 1), read_launches()))
    del model32
    torch.cuda.empty_cache()
    print(f"step 18, {label}: kernel rows K={spec.n_steps} {t1 - t0:.1f} s, "
          f"K={WIDE_K32} {time.perf_counter() - t1:.1f} s")
    for part, counts in rows:
        for name, row in part.items():
            records.append(dict(name=name, widened=label, route="cuda",
                                source=row_source(name, row),
                                replaces=f"lets_face_it_tpu/ops/{KERNEL_SOURCES[name][1]}",
                                launches=counts[name],
                                launches_of="the path" if counts is launches
                                else "these kernel rows (no path at this spec)",
                                **row))
            print(f"{label} K={row['n_steps']} {name} B={row['batch']} on "
                  f"{row['plan']['plan']} (rows {row['plan']['rows_per_block']}, "
                  f"cluster {row['plan']['cluster']}): max|d| {row['max_abs_err']:.3e}; "
                  f"kernel {row['ms']:.4f} ms (graph replay; {row['wrapper_ms']:.4f} "
                  f"through the wrapper), plain {row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})  ok")
    return {"launches": launches, "plans": plans, "loss": float(mets["loss"]),
            "val_loss": val["val_loss"], "chain_placement": [place, cluster]}


def hsplit_sampling_rows(label, spec, model, randn, frame_reps: int) -> dict:
    """The sampling kernels at a spec whose chain's plan is the hidden
    split, on ``model``'s weights, each through its wrapper against its
    plain twin, timed by graph replay and through the wrapper beside the
    library call and the bound, the launcher's plan required to be the
    hidden split: ``frame_rev`` B=1 and WIDE_BATCH (``frame_reps`` replays;
    the one-frame limits), ``seq_rev`` B=1 over WIDE_HSPLIT_FRAMES frames
    (its first SEQ_TIGHT frames at the one-frame limits, all of them at
    max(SEQ_LOOSE_ATOL, WIDE_SEQ_RATIO x the twin's own float32 - float64
    distance)) and the chain alone at B=1 -> {key: (kernel, row)}."""
    import torch

    from lets_face_it_tpu_torch.ops import flow_kernels as fk

    ks = fk.kernel_spec(spec)
    k_steps, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    cond, p1, n_seq = spec.cond.cond_dim, spec.cond.p1_face.out_dim, WIDE_HSPLIT_FRAMES
    w = fk.prepare_sampling_weights(spec, model.flow)
    w_p1_t = model.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2).contiguous()
    gru = {"w_ih": w.w_ih_t.transpose(1, 2).contiguous(),
           "w_hh": w.w_hh_t.transpose(1, 2).contiguous(), "b_ih": w.b_ih, "b_hh": w.b_hh}

    def hsplit_plan(what, b):
        plan = fk.chain_plan(spec, b)
        if plan["place"] != "hsplit":
            fail(f"{label} {what}: the chain's plan is {plan}")
        return plan

    rows = {}
    for b in (1, WIDE_BATCH):
        z, projs = randn(b, c), randn(k_steps, b, cond)
        st = randn(k_steps, b, h, scale=0.5)
        plan = hsplit_plan(f"frame_rev B={b}", b)
        x, st_new = fk.frame_rev_fused(spec, w, z, projs, st)
        (x_r, st_r), plain = timed(lambda: fk.frame_rev_fused_ref(ks, w, z, projs, st))
        err = max(check_close(f"{label} frame_rev B={b} x", x, x_r),
                  check_close(f"{label} frame_rev B={b} states", st_new, st_r))
        del x, st_new, x_r, st_r
        call = lambda: fk.frame_rev_fused(spec, w, z, projs, st)  # noqa: E731
        rows[f"frame_rev B={b}"] = ("frame_rev", dict(
            batch=b, max_abs_err=err, chain_plan=plan,
            ms=time_ms(graphed(call), frame_reps), wrapper_ms=time_ms(call, frame_reps),
            plain_ms=plain,
            library_ms=time_ms(graphed(lambda: library_frame_rev(
                ks, w, gru, z, projs, st)), frame_reps),
            **dict(zip(("bound_ms", "bound_by"), frame_bound_ms(ks, w, b)))))

    zs, fixed = randn(n_seq, 1, c), randn(n_seq, k_steps, 1, cond)
    hist0, st0 = randn(1, p1), torch.zeros(k_steps, 1, h, device=zs.device)
    xs = fk.sequence_rev_fused(spec, w, w_p1_t, zs, fixed, hist0, st0)
    ref_args = (ks, w, w_p1_t, zs, fixed, hist0, st0)
    xs_r, seq_plain = timed(lambda: fk.sequence_rev_fused_ref(*ref_args))
    xs_64 = fk.sequence_rev_fused_ref(ks, weights64(w), *(t.double() for t in ref_args[2:]))
    check_close(f"{label} seq_rev first {SEQ_TIGHT} frames", xs[:SEQ_TIGHT],
                xs_r[:SEQ_TIGHT])
    own = (xs_r.double() - xs_64).abs().max().item()
    print(f"{label} seq_rev all {n_seq} frames: kernel vs plain "
          f"{json.dumps(drift(xs, xs_r))}; plain float32 vs float64 "
          f"{json.dumps(drift(xs_r, xs_64))}")
    err = check_close(f"{label} seq_rev all frames", xs, xs_r,
                      atol=max(SEQ_LOOSE_ATOL, WIDE_SEQ_RATIO * own), rtol=0.0)
    del xs_64
    call = lambda: fk.sequence_rev_fused(  # noqa: E731
        spec, w, w_p1_t, zs, fixed, hist0, st0)
    rows["seq_rev"] = ("seq_rev", dict(
        batch=1, frames=n_seq, max_abs_err=err, own_f64_distance=own,
        chain_plan=hsplit_plan("seq_rev", 1),
        ms=time_ms(graphed(call), 3, warmup=1), wrapper_ms=time_ms(call, 3, warmup=1),
        plain_ms=seq_plain,
        library_ms=time_ms(graphed(lambda: library_seq_rev(
            ks, w, gru, *ref_args[2:])), 3, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), seq_bound_ms(ks, w, n_seq, 1)))))

    # the chain alone at B=1, its gates given
    z, st = randn(1, c), randn(k_steps, 1, h, scale=0.5)
    hist = randn(1, p1)
    _, gc, gh = fk.sample_gates_ref(ks, w, w_p1_t, randn(k_steps, 1, cond), hist, st)
    chain = lambda: fk.sample_chain(ks, w, z, gc, gh, st, hist)  # noqa: E731
    ref_c, chain_plain = timed(lambda: fk.sample_chain_ref(ks, w, z, gc, gh, st, hist))
    err = max(check_close(f"{label} sample_chain {nm}", a_, r_)
              for nm, a_, r_ in zip(("x", "states", "hist"), chain(), ref_c))
    plan = hsplit_plan("sample_chain", 1)
    rows["sample_chain"] = ("sample_chain", dict(
        batch=1, max_abs_err=err, plan=plan,
        ms=time_ms(graphed(chain), 20), wrapper_ms=time_ms(chain, 20),
        plain_ms=chain_plain,
        library_ms=time_ms(graphed(lambda: fk.sample_chain_ref(
            ks, w, z, gc, gh, st, hist)), 20),
        **dict(zip(("bound_ms", "bound_by"), chain_bound_ms(ks, w, 1, p1)))))
    print(f"{label} chain plan at B=1: {json.dumps(plan)}")
    return rows


def record_rows(label, rows, counts, records, launches_of=None) -> None:
    """Each (name, row) of ``rows`` into the kernels' records, with its
    launches from ``counts``, and printed."""
    for key, (name, row) in rows.items():
        records.append(dict(name=name, widened=label, route="cuda",
                            source=row_source(name, row),
                            replaces=f"lets_face_it_tpu/ops/{KERNEL_SOURCES[name][1]}",
                            launches=counts[name],
                            **({"launches_of": launches_of} if launches_of else {}),
                            **row))
        print(f"{label} {key}: max|d| {row['max_abs_err']:.3e}; kernel {row['ms']:.4f} ms "
              f"(graph replay; {row['wrapper_ms']:.4f} through the wrapper), plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  ok")


def wide_hsplit_rows(tmp, dev, label, overrides, records) -> dict:
    """Step 18 at final widths on the sampling chain's hidden split
    (``WIDE_HSPLIT``): the path (``wide_path``, 2 training steps, a
    validation whose inversion launches ``frame_rev``, 3 pushes; the chain's
    "hsplit" plan required), then the sampling kernels against their plain
    twins (``hsplit_sampling_rows``)."""
    import torch

    from lets_face_it_tpu_torch.ops import flow_kernels as fk

    t0 = time.perf_counter()
    hp, spec, model, mets, val, launches, plans = wide_path(
        tmp, dev, label, overrides, 2, invert=True, scaled_head=True)
    require_plan(f"{label} path", plans, "sample_chain", "hsplit")
    place, cluster = fk.chain_placement(spec)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    print(f"step 18, {label}: K={spec.n_steps} H={spec.hidden_channels}; the chain "
          f"{place} in a cluster of {cluster}; path: 2 steps B={WIDE_BATCH} (loss "
          f"{float(mets['loss']):.3f}), a validation (val NLL {val['val_loss']:.3f}, "
          f"inversion error {val['reconstruction/error_percentage']:.3f} %), 3 pushes "
          f"({time.perf_counter() - t0:.1f} s); launches {launches}, plans {plans}")
    with torch.no_grad():
        rows = hsplit_sampling_rows(label, spec, model, randn, 10)
    record_rows(label, rows, launches, records)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "plans": plans, "loss": float(mets["loss"]),
            "val_loss": val["val_loss"],
            "inversion_error_percentage": val["reconstruction/error_percentage"],
            "chain_placement": [place, cluster]}


def wide_ceiling_rows(tmp, dev, records) -> dict:
    """Step 18 at the widest H the kernels take (``WIDE_CEILING``, K = 4):
    the sampling kernels on the chain's hidden split against their plain
    twins (``hsplit_sampling_rows``). No path runs at this spec: its rows
    count the launches of their own calls."""
    import torch

    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.sample.weights import seeded_random_model

    label, overrides = WIDE_CEILING
    t0 = time.perf_counter()
    spec = FlowSpec.build(_wide_hp(tmp, overrides))
    model = seeded_random_model(spec, SEED, width_scaled_head=True).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    print(f"step 18, {label}: the chain {fk.chain_placement(spec)}; weights "
          f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    with torch.no_grad():
        rows = hsplit_sampling_rows(label, spec, model, randn, 5)
    launches, plans = read_launches(), read_plans()
    require_plan(label, plans, "sample_chain", "hsplit")
    record_rows(label, rows, launches, records,
                "these kernel rows (no path at this spec)")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "plans": plans,
            "chain_placement": list(fk.chain_placement(spec))}


# The hidden split's sources (step 18's rows on that plan, ``row_source``).
HSPLIT_SOURCES = {"seq_fwd": "csrc/seq_fwd_hsplit.cu",
                  "seq_bwd": "csrc/seq_bwd_hsplit.cu",
                  "sample_chain": "csrc/sample_chain_hsplit.cuh"}

# The kernels' sources and the TPU kernels they replace.
KERNEL_SOURCES = {
    "frame_rev": ("csrc/frame_rev.cu", "pallas_flow.py:130"),
    "seq_rev": ("csrc/seq_rev.cu", "pallas_flow.py:346"),
    "sample_gates": ("csrc/sample_gates.cuh", "pallas_flow.py:172"),
    "sample_chain": ("csrc/sample_chain.cuh", "pallas_flow.py:152"),
    "cond_gates": ("csrc/cond_gates.cu", "pallas_train.py:241"),
    "seq_fwd": ("csrc/seq_fwd.cu", "pallas_train.py:182"),
    "seq_bwd": ("csrc/seq_bwd.cu", "pallas_train.py:330")}


def tuning_step(tmp, dev, card) -> dict:
    """Step 19: ``Study.optimize`` on final_model over large_hparam_search,
    trials in spawned subprocesses on the card."""
    from hparam_tuning_configs import large_hparam_search

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.train import loop as train_loop
    from lets_face_it_tpu_torch.train.tuning import Study

    t19 = time.perf_counter()
    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
    corpus = train_loop.synthetic_corpus(hp, SEED, n_train_chunks=TUNE_CHUNKS,
                                         n_val_chunks=1, frames_per_chunk=TUNE_FRAMES)
    study = Study("final_model", Path(tmp) / "studies")
    study.optimize(hp, large_hparam_search.hparam_options, n_trials=TUNE_TRIALS,
                   max_steps=TUNE_STEPS, seed=TUNE_SEED, device=str(dev),
                   corpus=corpus, worker=0)
    trials = []
    for t in study.trials:
        trial_hp = large_hparam_search.hparam_options(
            load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp),
            _Replay(t["params"]))
        spec = FlowSpec.build(trial_hp)
        inside = fk.jax_envelope(spec)
        attrs = t.get("user_attrs", {})
        row = {"number": t["number"], "state": t["state"], "value": t.get("value"),
               "note": t.get("note"), "seconds": attrs.get("seconds"),
               "batch_size": attrs.get("batch_size"), "launches": attrs.get("launches"),
               "spec": {"K": spec.n_steps, "H": spec.hidden_channels,
                        "cond": spec.cond.cond_dim, "C": spec.channels,
                        "p1_face": spec.cond.p1_face.enc, "optim": trial_hp.Optim["name"],
                        "seq_len": trial_hp.Train["seq_len"]},
               "jax_envelope": inside}
        trials.append(row)
        print(f"step 19 trial #{t['number']}: {row['spec']} (JAX kernels' envelope: "
              f"{inside}), {t['state']}"
              f"{'' if t.get('note') is None else ' (' + str(t['note'])[:120] + ')'}, "
              f"{row['seconds'] if row['seconds'] is None else round(row['seconds'], 1)} s, "
              f"launches {row['launches']}")
        if t["state"] not in ("complete", "pruned"):
            fail(f"tuning trial #{t['number']} {t['state']}: {t.get('note')}\n"
                 f"{t.get('traceback', '')}")
        if inside:
            counts = row["launches"] or {}
            require_launches(f"tuning trial #{t['number']}", counts,
                             ("cond_gates", "seq_fwd", "seq_bwd"))
            if not (counts["seq_rev"] or counts["frame_rev"]):
                fail(f"tuning trial #{t['number']} launched no sampling kernel")
    return {"trials": trials, "best": study.best_trial and study.best_trial["number"],
            "step_s": time.perf_counter() - t19}


class _Replay:
    """A trial that suggests recorded values (to rebuild a trial's hparams)."""

    def __init__(self, params):
        self.params = params

    def _get(self, name, *args, **kwargs):
        return self.params[name]

    suggest_categorical = suggest_uniform = suggest_loguniform = suggest_int = _get


def _ddp_rank(rank, world, backend, port, inputs_path, out_path):
    """One rank of step 20: DDP_STEPS steps on its rows of each batch."""
    import os

    import torch

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lets_face_it_tpu_torch.parallel.mesh import make_mesh
    from lets_face_it_tpu_torch.sample.weights import seeded_random_model
    from lets_face_it_tpu_torch.train import state as train_state

    mesh = make_mesh("cuda", backend)
    inp = torch.load(inputs_path, weights_only=False)
    spec, hp = inp["spec"], inp["hp"]
    state = train_state.TrainState.create(seeded_random_model(spec, SEED).to(mesh.device),
                                          hp, 10, SEED, mesh=mesh)
    batches = [{k: mesh.local(v).to(mesh.device) for k, v in b.items()}
               for b in inp["batches"]]
    reset_launches()
    train_state.run_actnorm_init(spec, state, batches[0])
    nlls = [float(train_state.train_step(spec, hp, state, b)["nll"]) for b in batches]
    torch.cuda.synchronize()
    if mesh.is_main:
        torch.save({"nll": nlls, "launches": read_launches(),
                    "params": {k: v.detach().cpu() for k, v in
                               state.model.state_dict().items()}}, out_path)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def ddp_start(tmp, dev) -> dict:
    """Step 20: DDP_STEPS data-parallel steps at B=256 against one process:
    the process's own steps here, then both worlds' ranks started (they run
    beside step 19's last trials; ``ddp_finish`` waits for them)."""
    import socket

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.sample.weights import seeded_random_model
    from lets_face_it_tpu_torch.train import loop as train_loop
    from lets_face_it_tpu_torch.train import state as train_state

    t20 = time.perf_counter()
    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
    spec = FlowSpec.build(hp)
    b = hp.batch_size
    # 20 chunks: 1,620 windows of 80, enough for DDP_STEPS distinct batches
    train_ds, _ = train_loop.load_datasets(hp, train_loop.synthetic_corpus(
        hp, SEED, n_train_chunks=20))
    order = np.random.default_rng(SEED).permutation(len(train_ds.window_starts))
    batches = [{k: torch.as_tensor(v) for k, v in
                train_ds.get_batch(order[i * b:(i + 1) * b]).items()}
               for i in range(DDP_STEPS)]
    state = train_state.TrainState.create(seeded_random_model(spec, SEED).to(dev),
                                          hp, 10, SEED)
    on_dev = [{k: v.to(dev) for k, v in bt.items()} for bt in batches]
    train_state.run_actnorm_init(spec, state, on_dev[0])
    want = [float(train_state.train_step(spec, hp, state, bt)["nll"]) for bt in on_dev]
    want_params = {k: v.detach() for k, v in state.model.state_dict().items()}
    inputs = Path(tmp) / "ddp_inputs.pt"
    torch.save({"spec": spec, "hp": hp, "batches": batches}, inputs)
    out = {"reference_nll": want}
    ctx = mp.get_context("spawn")
    # both worlds at once (one after the other until the script's time limit
    # needed the time), each on a port of its own
    worlds, spawned_at = {}, time.time()
    for world, backend in ((1, "nccl"), (2, "gloo")):
        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        result = Path(tmp) / f"ddp_{world}_{backend}.pt"
        procs = [ctx.Process(target=_ddp_rank,
                             args=(r, world, backend, port, str(inputs), str(result)))
                 for r in range(world)]
        for p in procs:
            p.start()
        worlds[world, backend] = (procs, result)
    return {"t20": t20, "worlds": worlds, "want": want, "want_params": want_params,
            "out": out, "b": b, "spawned_at": spawned_at}


def ddp_finish(runs, dev, card) -> dict:
    """Step 20's check: each world's NLL and weights against one process's."""
    import torch

    worlds, want, want_params = runs["worlds"], runs["want"], runs["want_params"]
    out, b = runs["out"], runs["b"]
    deadline = runs["spawned_at"] + 600
    for p in (p for procs, _ in worlds.values() for p in procs):
        p.join(timeout=max(0.0, deadline - time.time()))
        if p.is_alive():
            p.kill()
            p.join()
    for (world, backend), (procs, result) in worlds.items():
        if any(p.exitcode != 0 for p in procs):
            fail(f"data parallel, world size {world} over {backend}: a rank exited "
                 f"{[p.exitcode for p in procs]}")
        got = torch.load(result, weights_only=False)
        require_launches(f"data parallel, world size {world}", got["launches"],
                         ("cond_gates", "seq_fwd", "seq_bwd"))
        for i, (a_, r_) in enumerate(zip(got["nll"], want)):
            tol = CPU_NLL_RTOL1 if i == 0 else CPU_NLL_RTOL
            if abs(a_ - r_) > tol * abs(r_):
                fail(f"data parallel world size {world}: step {i + 1} NLL {a_} "
                     f"against one process's {r_} (rtol {tol})")
        worst = max((got["params"][k].to(dev) - v).abs().max().item()
                    for k, v in want_params.items())
        if worst > CPU_PARAM_ATOL:
            fail(f"data parallel world size {world}: weights {worst:.3e} from one "
                 f"process's after {DDP_STEPS} steps (atol {CPU_PARAM_ATOL})")
        out[f"world{world}_{backend}"] = {
            "nll": got["nll"], "max_weight_diff": worst,
            "launches": got["launches"],
            # from the spawn to the result's write (the ranks' clock)
            "seconds": result.stat().st_mtime - runs["spawned_at"]}
        print(f"step 20, world size {world} over {backend}: {DDP_STEPS} steps of "
              f"B={b} ({b // world} a rank) on {card}; NLL {got['nll']} against one "
              f"process's {want}; weights within {worst:.3e}; launches "
              f"{got['launches']}  ok")
    out["step_s"] = time.perf_counter() - runs["t20"]
    return out


# Step 21: the benchmark (``python -m lets_face_it_tpu_torch.bench``) in
# process at a cut of its sizes: its every section, the full capacity
# ladder (each rung's first push against frame_rev's plain twin, then 16
# chained pushes a rung where the bench times 64), the B=1024 step at its
# 2 iterations.
BENCH_SIZES = dict(sampling_iters=3, pushes=50, session_frames=100, sessions=1,
                   train_iters=2, train_repeats=1, e2e_steps=10, e2e_warm=16,
                   ladder_iters=16)
# The keys the root bench.py prints (bench.py:617-681, with its ladder and
# without --scaling), then the two the port's adds (its `device` is the
# card's name).
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "sampling_batch",
    "sampling_fps_batch1", "realtime_factor_batch1",
    "streaming_frame_latency_ms_p50", "streaming_frame_latency_ms_p99",
    "streaming_frame_device_ms_chained", "streaming_session_lateness_ms_p50",
    "streaming_session_lateness_ms_p99", "streaming_session_lateness_ms_max",
    "streaming_session_max_catchup_dispatch",
    "streaming_session_underruns_at_depth2", "streaming_session_min_buffer_depth",
    "streaming_sessions_per_chip_within_frame_budget",
    "streaming_realtime_headroom", "train_steps_per_sec_b256_T80",
    "train_steps_per_sec_b256_e2e", "train_steps_per_sec_b256_e2e_k8",
    "train_steps_per_sec_b256_T80_bf16matmul", "sampling_fps_batch1_bf16matmul",
    "sampling_fps_batched_bf16matmul", "train_windows_per_sec",
    "train_windows_per_sec_b1024", "nll_parity_rel_err_vs_torch_f64", "device",
    "bands", "streaming_capacity_ladder")
BENCH_PORT_KEYS = ("power_limit_w", "host")
# NLL against the float64 plain path: the training forward's limit (step 8)
BENCH_NLL_RTOL = 1e-5
# The bench's shapes no earlier step holds: the training kernels at its
# B=512 and B=1024 rows (4 and 8 rows a block; step 8 holds B=256), and
# seq_rev at its sampling call (B=128, 100 generated frames; step 3 holds
# 76). Held against the plain routes at step 8's limits, the sequence at
# step 18's (its plain twin drifts 2.6e-02 from itself in float64 over the
# 100 frames on the CPU, more than SEQ_LOOSE_ATOL).
BENCH_TRAIN_CHECK = (512, 1024)
BENCH_SAMPLE_BATCH, BENCH_GEN_FRAMES = 128, 100


def _numbers(x):
    """Every number in a nested JSON value."""
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def bench_train_check(spec, hp, params, b: int, dev) -> dict:
    """The training kernels at B=``b`` on the bench's model and batch:
    ``sequence_nll``'s loss, its per-frame losses and the gradient on every
    leaf, the encoders' dropout drawn alike, against the plain route
    (``plain_paths``): losses at the training forward's limit, each leaf at
    GRAD_ATOL + GRAD_LEAF_RTOL * its largest |entry|."""
    import torch

    from lets_face_it_tpu_torch import bench
    from lets_face_it_tpu_torch.model import seqglow

    batch = bench.on_device(bench.example_batch(hp, b, hp.Train["seq_len"]), dev)
    names, leaves = zip(*[(n, p) for n, p in params.named_parameters()
                          if p.requires_grad])

    def nll_and_grads():
        reset_launches()
        _, loss, losses = seqglow.sequence_nll(
            spec, params, batch, training=True,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        return loss.detach(), losses.detach(), grads, read_launches()

    loss, losses, grads, launches = nll_and_grads()
    require_launches(f"sequence_nll B={b}", launches, ("cond_gates", "seq_fwd", "seq_bwd"))
    with plain_paths(seqglow):
        loss_r, losses_r, grads_r, plain_launches = nll_and_grads()
    if any(plain_launches.values()):
        fail(f"sequence_nll B={b} on the plain route launched {plain_launches}")
    what = f"sequence_nll B={b} T={hp.Train['seq_len']} vs the plain route"
    err = {"nll": check_close(f"{what}: NLL", loss, loss_r, TRAIN_VAL_ATOL, TRAIN_VAL_RTOL),
           "losses": check_close(f"{what}: per-frame losses", losses, losses_r,
                                 TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)}
    ratio = 0.0
    for name, g, g_r in zip(names, grads, grads_r):
        if g is None or g_r is None:
            if (g is None) != (g_r is None):
                fail(f"{what}: gradient {name} on one route only")
            continue
        scale = g_r.abs().max().item()
        diff = (g.double() - g_r.double()).abs().max().item()
        limit = GRAD_ATOL + GRAD_LEAF_RTOL * scale
        if not torch.isfinite(g).all() or diff > limit:
            fail(f"{what}: gradient {name} max|diff| {diff:.3e} > {limit:.3e} "
                 f"(max|ref| {scale:.3e})")
        ratio = max(ratio, diff / limit)
    err["largest_grad_diff_over_limit"] = ratio
    print(f"check {what} (dropout alike; losses atol {TRAIN_VAL_ATOL} rtol "
          f"{TRAIN_VAL_RTOL}, gradients {GRAD_ATOL} + {GRAD_LEAF_RTOL} * max|leaf|): "
          f"NLL {loss.item():.6f} vs {loss_r.item():.6f}, {json.dumps(err)}; "
          f"launches {launches}  ok")
    return err


def bench_sample_check(spec, params, dev) -> dict:
    """seq_rev at the bench's sampling shape (B=BENCH_SAMPLE_BATCH,
    BENCH_GEN_FRAMES frames) on the bench's weights against its plain twin:
    the first SEQ_TIGHT frames at the one-frame limits, all frames at
    max(SEQ_LOOSE_ATOL, WIDE_SEQ_RATIO x the twin's own float32 - float64
    drift)."""
    import torch

    from lets_face_it_tpu_torch.ops import flow_kernels as fk

    b, n = BENCH_SAMPLE_BATCH, BENCH_GEN_FRAMES
    p1 = spec.cond.p1_face.out_dim
    w = fk.prepare_sampling_weights(spec, params.flow)
    w_p1_t = params.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2).contiguous().detach()
    g = torch.Generator(device=dev).manual_seed(SEED)
    args = (torch.randn(n, b, spec.channels, generator=g, device=dev),
            torch.randn(n, spec.n_steps, b, spec.cond.cond_dim, generator=g, device=dev),
            torch.randn(b, p1, generator=g, device=dev),
            torch.zeros(spec.n_steps, b, spec.hidden_channels, device=dev))
    with torch.no_grad():
        reset_launches()
        xs = fk.sequence_rev_fused(spec, w, w_p1_t, *args)
        require_launches(f"seq_rev B={b} N={n}", read_launches(), ("seq_rev",))
        xs_r = fk.sequence_rev_fused_ref(spec, w, w_p1_t, *args)
        xs_64 = fk.sequence_rev_fused_ref(spec, weights64(w), w_p1_t.double(),
                                          *(a.double() for a in args))
        torch.cuda.synchronize()
    what = f"seq_rev B={b} N={n} (the bench's sampling call)"
    check_close(f"{what} first {SEQ_TIGHT} frames", xs[:SEQ_TIGHT], xs_r[:SEQ_TIGHT])
    own = (xs_r.double() - xs_64).abs().max().item()
    limit = max(SEQ_LOOSE_ATOL, WIDE_SEQ_RATIO * own)
    check_close(f"{what} all frames", xs, xs_r, atol=limit, rtol=0.0)
    out = {"kernel_vs_plain": drift(xs, xs_r), "plain32_vs_plain64": drift(xs_r, xs_64),
           "kernel_vs_plain64": drift(xs, xs_64), "all_frames_limit": limit}
    print(f"check {what} against its plain twin: {json.dumps(out)}; max|x| "
          f"{xs_64.abs().max().item():.2f}  ok")
    return out


def bench_step(dev, card) -> dict:
    """Step 21: the benchmark's sections through ``bench.run`` at
    BENCH_SIZES, on the bench's model and seeded weights; launches and plans
    of the run, the line's keys and numbers held; then the bench's shapes
    no other step holds (``bench_train_check``, ``bench_sample_check``) and
    a profile of its B=128 sampling call."""
    import torch

    from lets_face_it_tpu_torch import bench
    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.ops import flow_kernels as fk

    t21 = time.perf_counter()
    hp, spec, params = bench.build_full_model(dev)
    reset_launches()
    line = bench.run(hp, spec, params, device=dev, sizes=bench.Sizes(**BENCH_SIZES),
                     machine=bench.machine(dev))
    launches, plans = read_launches(), read_plans()
    require_launches("bench", launches, kernel_wrappers())
    wrong = set(BENCH_KEYS + BENCH_PORT_KEYS) ^ set(line)
    if wrong:
        fail(f"bench: keys missing or extra against the root bench's: {sorted(wrong)}")
    # only an out-of-memory B=1024 step may read null
    nulls = [k for k, v in line.items() if v is None and k != "train_windows_per_sec_b1024"]
    if nulls:
        fail(f"bench: {nulls} read null on the card")
    bad = [x for x in _numbers(line) if not math.isfinite(x)]
    if bad:
        fail(f"bench: non-finite numbers {bad}")
    if line["nll_parity_rel_err_vs_torch_f64"] > BENCH_NLL_RTOL:
        fail(f"bench: NLL {line['nll_parity_rel_err_vs_torch_f64']:.3e} from the "
             f"float64 plain path (limit {BENCH_NLL_RTOL})")
    ladder = line["streaming_capacity_ladder"]
    checked = [b for b, row in ladder.items() if "max_abs_err_vs_plain" in row]
    if [b for b in ladder if "error" not in ladder[b]] != checked:
        fail(f"bench: a ladder rung went unchecked: {ladder}")
    if not any(int(b) > 512 for b in checked):
        fail(f"bench: no ladder rung above B=512 ran: {ladder}")
    train_checks = {b: bench_train_check(spec, hp, params, b, dev)
                    for b in BENCH_TRAIN_CHECK}
    sample_check = bench_sample_check(spec, params, dev)
    # where a sampling call's device time goes: seq_rev's kernels and the rest
    data = bench.on_device(bench.example_batch(
        hp, BENCH_SAMPLE_BATCH, spec.cond.longest_history + BENCH_GEN_FRAMES), dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    sample_trace = trace_window(
        f"sequence_sample_b{BENCH_SAMPLE_BATCH}_{BENCH_GEN_FRAMES}_generated",
        lambda: seqglow.sequence_sample(
            spec, params, data, spec.cond.longest_history + BENCH_GEN_FRAMES,
            eps_std=float(hp.Infer["eps"]), generator=g),
        calls=5, groups={"seq_rev": ("gates_mma_kernel", "sample_gates_kernel",
                                     "sample_chain_kernel")})
    print(json.dumps(sample_trace))
    step_s = time.perf_counter() - t21
    rows = fk.frame_max_rows(spec, torch.cuda.current_device())
    print(f"step 21, the bench at a cut ({BENCH_SIZES}) on {card}: sampling B=128 "
          f"{line['value']} frames/s, push p50/p99 "
          f"{line['streaming_frame_latency_ms_p50']}/"
          f"{line['streaming_frame_latency_ms_p99']} ms, {line['streaming_sessions_per_chip_within_frame_budget']} "
          f"sessions within 40 ms (rungs {checked} held against frame_rev's plain "
          f"twin; one frame_rev launch plans for {rows} rows), B=256 {line['train_steps_per_sec_b256_T80']} steps/s, k=8 "
          f"{line['train_steps_per_sec_b256_e2e_k8']}; NLL "
          f"{line['nll_parity_rel_err_vs_torch_f64']:.3e} from float64; launches "
          f"{launches}; {step_s:.1f} s  ok")
    return {"line": line, "launches": launches, "plans": plans,
            "frame_rev_max_rows": rows, "train_checks": train_checks,
            "sample_check": sample_check, "sample_trace": sample_trace,
            "step_s": step_s}


# Step 22: the Table-1 path (``ablation_table1.py``, ``trick_gate_probe.py``,
# ``device_cache_scale_probe.py``) at a cut: final_model and no_nll_trick for
# TABLE1_STEPS steps each, validating every TABLE1_VAL_EVERY epochs (5 steps
# an epoch: steps 20 and 40), the gate probe's loop for GATE_STEPS steps (seed
# 1234's coins fall below 0.1 at steps 0, 2, 3, 14, 22, 25 and 28), the scale
# probe on SCALE_CUT (a tenth of the corpus). The wrong-context probes on the
# trained weights against the plain route at the training forward's limit
# (step 8's); a fired step of train_step on them (the coin handed in) against
# the plain route, its NLL at that limit and every gradient leaf at step 8's
# GRAD_ATOL + GRAD_LEAF_RTOL * max|leaf|; the gate variable and the loss of a
# fired step at GATE_RTOL.
TABLE1_STEPS, TABLE1_VAL_EVERY, GATE_STEPS = 40, 4, 40
SCALE_CUT = dict(n_train_chunks=290, steps=10, big_steps=2)
GATE_RTOL = 1e-6


def table1_probe_check(hp, model, corpus, dev) -> dict:
    """The first val batch's NLL and each configured deranged NLL on
    ``model`` through the kernels and through ``plain_paths``, at
    "highest", the same permutations both ways: each NLL at the training
    forward's limit, each gap (matched - deranged) at the sum of its two
    NLLs' limits."""
    import torch

    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.train.loop import load_datasets, to_device
    from lets_face_it_tpu_torch.train.metrics import wrong_context_probes

    spec = FlowSpec.build(hp)
    _, val_ds = load_datasets(hp, corpus)
    batch = to_device(next(val_ds.epoch_batches(hp.batch_size, shuffle=False)), dev)

    @torch.no_grad()
    def nlls():
        _, loss, _ = seqglow.sequence_nll(spec, model, batch)
        gaps = wrong_context_probes(spec, model, batch, loss, hp.Mismatch,
                                    torch.Generator().manual_seed(SEED))
        return loss, gaps

    reset_launches()
    loss, gaps = nlls()
    require_launches("the wrong-context probes", read_launches(), ("cond_gates", "seq_fwd"))
    with plain_paths(seqglow):
        reset_launches()
        loss_r, gaps_r = nlls()
        plain_launches = read_launches()
    if any(plain_launches.values()):
        fail(f"step 22: the plain route launched {plain_launches}")
    err = {"val_nll": check_close("step 22: first val batch NLL vs the plain route",
                                  loss, loss_r, TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)}
    ratio = 0.0
    for key in gaps:
        mis, mis_r = loss - gaps[key], loss_r - gaps_r[key]
        err[key] = check_close(f"step 22: {key} deranged NLL vs the plain route",
                               mis, mis_r, TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)
        limit = (2 * TRAIN_VAL_ATOL
                 + TRAIN_VAL_RTOL * (abs(float(loss_r)) + abs(float(mis_r))))
        diff = abs(float(gaps[key]) - float(gaps_r[key]))
        if diff > limit:
            fail(f"step 22: {key} gap {float(gaps[key]):+.6f} vs the plain route's "
                 f"{float(gaps_r[key]):+.6f}: |diff| {diff:.3e} > {limit:.3e}")
        ratio = max(ratio, diff / limit)
    err["largest_gap_diff_over_limit"] = ratio
    return err


def table1_fired_step_check(hp, model, corpus, dev) -> dict:
    """One fired step of ``train_step`` (coin 0, the gate open) from
    ``model``'s weights on the first training batch, through the kernels and
    through ``plain_paths`` at "highest", the same draws both ways: the
    deranged NLL at the training forward's limit, the loss -0.1 nll and the
    gate variable -nll (GATE_RTOL), the gradient norm at GRAD_LEAF_RTOL and
    every gradient leaf the optimizer took (clipped) at GRAD_ATOL +
    GRAD_LEAF_RTOL * max|leaf|. Read beside it, with no limit: the kernels'
    fired and unfired (coin 1) steps at precision 16 against the plain
    route's at "highest", as the largest leaf's max|diff| / max|leaf|."""
    import copy

    import torch

    from lets_face_it_tpu_torch.ablation_table1 import SEED as TABLE1_SEED
    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.train import state as train_state
    from lets_face_it_tpu_torch.train.loop import load_datasets, to_device
    from lets_face_it_tpu_torch.utils.precision import matmul_precision

    spec = FlowSpec.build(hp)
    train_ds, _ = load_datasets(hp, corpus)
    spe = train_ds.num_batches(hp.batch_size, drop_last=True)
    sel = next(train_ds.epoch_index_batches(hp.batch_size, shuffle=False))
    batch = to_device(train_ds.get_batch(sel), dev)
    fresh = lambda: train_state.TrainState.create(copy.deepcopy(model), hp, spe,
                                                  TABLE1_SEED)
    d = train_state.draw_step(spec, fresh(), hp.batch_size,
                              batch["p1_face"].shape[1] - spec.cond.longest_history)

    def step(coin, precision):
        st = fresh()
        st.last_mismatched_nll = 1.0
        reset_launches()
        with matmul_precision(precision):
            m = train_state.train_step(spec, hp, st, batch, draws=train_state.StepDraws(
                coin, d.perm, d.dropout_masks))
        torch.cuda.synchronize()
        m = {k: float(v) for k, v in m.items()}
        grads = [None if p.grad is None else p.grad.detach().clone() for p in st.trained]
        return m, float(st.last_mismatched_nll), grads, read_launches()

    def leaf_diffs(grads, grads_r):
        for g, g_r in zip(grads, grads_r):
            if (g is None) != (g_r is None):
                fail("step 22: a fired step's gradient leaf on one route only")
            if g is not None:
                yield (g.double() - g_r.double()).abs().max().item(), \
                    g_r.abs().max().item(), bool(torch.isfinite(g).all())

    m, last, grads, launches = step(0.0, "highest")
    require_launches("a fired step", launches, ("cond_gates", "seq_fwd", "seq_bwd"))
    with plain_paths(seqglow):
        refs = {coin: step(coin, "highest") for coin in (0.0, 1.0)}
    m_r, last_r, grads_r, plain_launches = refs[0.0]
    if any(n for *_, l in refs.values() for n in l.values()):
        fail(f"step 22: the plain route's steps launched {plain_launches}")
    what = "step 22: a fired step vs the plain route"
    if m["deranged"] != 1.0 or m_r["deranged"] != 1.0:
        fail(f"{what}: deranged {m['deranged']} / {m_r['deranged']} with coin 0 "
             "and the gate open")
    err = {"nll": check_close(f"{what}: NLL", torch.tensor(m["nll"]),
                              torch.tensor(m_r["nll"]), TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)}
    for got, gate in ((m, last), (m_r, last_r)):
        nll = got["nll"]
        if (abs(got["loss"] + 0.1 * nll) > GATE_RTOL * abs(0.1 * nll)
                or abs(gate + nll) > GATE_RTOL * abs(nll)):
            fail(f"{what}: loss {got['loss']}, nll {nll}, gate variable {gate}")
    norm_diff = abs(m["grad_norm"] - m_r["grad_norm"])
    if norm_diff > GRAD_LEAF_RTOL * abs(m_r["grad_norm"]):
        fail(f"{what}: gradient norm {m['grad_norm']} vs {m_r['grad_norm']}")
    ratio = 0.0
    for diff, scale, finite in leaf_diffs(grads, grads_r):
        limit = GRAD_ATOL + GRAD_LEAF_RTOL * scale
        if not finite or diff > limit:
            fail(f"{what}: a gradient leaf max|diff| {diff:.3e} > {limit:.3e} "
                 f"(max|ref| {scale:.3e})")
        ratio = max(ratio, diff / limit)
    err["grad_norm"] = norm_diff
    err["largest_grad_diff_over_limit"] = ratio
    # precision 16 beside the plain route at "highest": a reading
    for coin, key in ((0.0, "fired"), (1.0, "unfired")):
        m16, _, grads16, _ = step(coin, "medium")
        ref_m, _, ref_grads, _ = refs[coin]
        if m16["deranged"] != ref_m["deranged"]:
            fail(f"step 22: the {key} step at precision 16 deranged {m16['deranged']}")
        err[f"p16_{key}_nll_rel"] = abs(m16["nll"] - ref_m["nll"]) / abs(ref_m["nll"])
        err[f"p16_{key}_grad_rel"] = max(diff / scale for diff, scale, _
                                         in leaf_diffs(grads16, ref_grads) if scale > 0)
    return err


def table1_step(dev, card) -> tuple:
    """Step 22: the Table-1 path at a cut, with its launches (path
    ``table1``): (a) ``cond_gates``, ``seq_fwd`` and ``seq_bwd`` launched by
    each run; (b) ``table1_probe_check`` on final_model's trained weights;
    (c) every fired step of the gate probe set ``last_mismatched_nll`` to
    -nll and its loss to -0.1 nll (GATE_RTOL), every other step left both
    alone, and a step fired iff its coin was below 0.1 with the gate read
    open before it; ``table1_fired_step_check`` on final_model's trained
    weights; (d) ``auto`` cached both splits of the cut corpus, and every
    loss is finite. -> (the readings, the checks against the plain route:
    (b) and the fired step of (c), which time nothing and so run later,
    beside step 19's trials; they complete the readings)."""
    from lets_face_it_tpu_torch import ablation_table1 as table1
    from lets_face_it_tpu_torch import device_cache_scale_probe as scale
    from lets_face_it_tpu_torch import trick_gate_probe as gate
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus

    t22 = time.perf_counter()
    final_yaml = REPO / "hparams" / "final_model.yaml"
    corpus = synthetic_corpus(load_hparams(final_yaml), table1.SEED)
    scale_corpus = scale.scale_corpus(SCALE_CUT["n_train_chunks"],
                                      SCALE_CUT["n_train_chunks"] // 10)
    corpus_s = time.perf_counter() - t22
    reset_launches()
    runs, states = {}, {}
    for name in table1.PAIR:
        runs[name], states[name] = table1.run_config(
            name, max_steps=TABLE1_STEPS, device=dev, corpus=corpus,
            val_every=TABLE1_VAL_EVERY)
    per_step, validations, _ = gate.gate_steps(max_steps=GATE_STEPS, device=dev,
                                               corpus=corpus, val_every=GATE_STEPS // 2)
    scaled = scale.run(load_hparams(final_yaml), scale_corpus, device=dev,
                       steps=SCALE_CUT["steps"], big_steps=SCALE_CUT["big_steps"])
    launches = read_launches()
    # (a) the training kernels on the path, and in each run
    require_launches("table1", launches, table1.TRAINED_KERNELS)
    for what, counts in [*((n, r["launches"]) for n, r in runs.items()),
                         ("scale probe", scaled["launches"])]:
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            fail(f"step 22: {what} never launched {missing}")
    steps = {n: [row["step"] for row in r["curve"]] for n, r in runs.items()}
    want = list(range(5 * TABLE1_VAL_EVERY, TABLE1_STEPS + 1, 5 * TABLE1_VAL_EVERY))
    if any(s != want for s in steps.values()):
        fail(f"step 22: validations at {steps}, expected {want} for every config")
    # (c) the gate
    fired, last = 0, math.inf
    for i, row in enumerate(per_step):
        nll = row["nll"]
        if row["deranged"] == 1.0:
            fired += 1
            if (abs(row["last"] + nll) > GATE_RTOL * abs(nll)
                    or abs(row["loss"] + 0.1 * nll) > GATE_RTOL * abs(0.1 * nll)):
                fail(f"step 22: fired step {i}: nll {nll}, last_mismatched_nll "
                     f"{row['last']}, loss {row['loss']}")
        elif row["last"] != last or row["loss"] != nll:
            fail(f"step 22: step {i} did not fire but moved last_mismatched_nll "
                 f"({last} -> {row['last']}) or scaled its loss ({row['loss']} vs {nll})")
        if (row["deranged"] == 1.0) != (row["coin"] < 0.1 and row["gate_open"]):
            fail(f"step 22: step {i} deranged {row['deranged']} with coin "
                 f"{row['coin']} and the gate {'open' if row['gate_open'] else 'closed'}")
        last = row["last"]
    if fired == 0:
        fail(f"step 22: no step of the gate probe fired in {GATE_STEPS}")
    # (d) the cut corpus cached by auto (scale.run raises otherwise), losses finite
    losses = ([r["val_loss"] for run in runs.values() for r in run["curve"]]
              + [r["gap_p2"] for run in runs.values() for r in run["curve"]]
              + [r["nll"] for r in per_step] + [v["val_loss"] for v in validations]
              + [scaled[k] for k in ("b256_nll_final", "b1024_nll_final", "val_nll")])
    if not all(math.isfinite(x) for x in losses):
        fail("step 22: a non-finite loss on the Table-1 path")
    step_s = time.perf_counter() - t22
    out = {"launches": launches, "corpus_s": corpus_s,
           "configs": {n: {k: r[k] for k in ("wall_s", "curve", "launches")}
                       for n, r in runs.items()},
           "gate": {"fired_steps": fired, "steps": len(per_step),
                    "validations": validations},
           "scale": {k: v for k, v in scaled.items() if not k.startswith("mem_")},
           "step_s": step_s}
    hp = table1.table1_hparams(load_hparams(final_yaml), TABLE1_VAL_EVERY)
    trained = states["final_model"].model
    del states, scaled
    return out, lambda: table1_checks(out, hp, trained, corpus, dev, card, runs, want,
                                      fired, launches)


def table1_checks(out, hp, model, corpus, dev, card, runs, want, fired, launches):
    """Step 22's checks against the plain route on final_model's trained
    weights: (b) the probes, (c) a fired step; added to ``out``."""
    t0 = time.perf_counter()
    probe_err = table1_probe_check(hp, model, corpus, dev)
    fired_err = table1_fired_step_check(hp, model, corpus, dev)
    out.update(probe_check=probe_err, fired_step_check=fired_err,
               checks_s=time.perf_counter() - t0)
    scaled, corpus_s, step_s = out["scale"], out["corpus_s"], out["step_s"]
    print(f"step 22, the Table-1 path at a cut on {card}: {TABLE1_STEPS} steps of "
          f"final_model {runs['final_model']['wall_s']} s, no_nll_trick "
          f"{runs['no_nll_trick']['wall_s']} s (validations at {want}); the gate "
          f"fired {fired} of {GATE_STEPS} steps, each setting last_mismatched_nll "
          f"= -nll and its loss -0.1 nll (rtol {GATE_RTOL}); the probes on the "
          f"trained weights within the forward's limit of the plain route "
          f"({json.dumps(probe_err)}); a fired step within step 8's limits of the "
          f"plain route ({json.dumps(fired_err)}); the scale cut ({SCALE_CUT}) cached "
          f"{scaled['train_split_gb']:.3f} + {scaled['val_split_gb']:.3f} GB by auto, "
          f"B=256 k=8 {scaled['b256_k8_steps_per_sec']:.3f} steps/s, peak reserved "
          f"{scaled['peak_gb']:.3f} GB of {scaled['hbm_limit_gb']:.3f}; launches {launches}; "
          f"corpora {corpus_s:.1f} s; {step_s:.1f} s and the checks "
          f"{out['checks_s']:.1f} s  ok")


# Step 24: the small replay fixture (tests/fixtures/torch_table1_replay_small.npz,
# written by tests/test_torch_table1_replay.py --fixture): the JAX package's
# seed-1234 start at a small width (C=16, K=3, H=16, cond 32; the tool's
# settings, B=64), its draws for 24 steps (two fired: 21 and 22, 0-based),
# its probe permutations at the validations of steps 18 and 24, and the JAX
# package's own per-step NLL and gradient norm on the CPU, replayed through
# ``train(replay=)`` on the card and on the CPU. Against the JAX record: the
# branch of every step equal; the first step, which starts from the same
# weights, at the three-step trajectory test's limits (NLL rtol 1e-5,
# gradient norm rtol 1e-4); every later step at those limits or at
# REPLAY_DRIFT times the port's own CPU replay's distance from the record
# at that step, whichever is larger: the NLL here (about -60 bits) is a
# small difference of terms of thousands of bits, so float32 rounding
# carried through Adam (learning rate 1e-3 at this width) moves it by about
# 2e-6 relative a step (4.9e-5 at step 24 on the CPU). Against the CPU
# replay: step 10's limits (NLL rtol 1e-5 at the first step, then 1e-4;
# gradient norm rtol 1e-4), each validation's val_loss at rtol 1e-4 and
# each probe's gap at the sum of its two NLLs' limits.
REPLAY_FIXTURE = REPO / "tests" / "fixtures" / "torch_table1_replay_small.npz"
REPLAY_NLL_RTOL, REPLAY_GRAD_RTOL, REPLAY_DRIFT = 1e-5, 1e-4, 3.0


def replay_step(dev, card) -> dict:
    """Step 24 (path ``replay``): the fixture through ``train(replay=)`` on
    the card (``cond_gates``, ``seq_fwd``, ``seq_bwd`` launched) and on the
    CPU (one thread: small products), each step and validation held as the
    comment above says."""
    import copy

    import numpy as np
    import torch

    from lets_face_it_tpu_torch import ablation_table1 as table1
    from lets_face_it_tpu_torch.hparams import HParams
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus, train
    from lets_face_it_tpu_torch.train.replay import Replay

    t24 = time.perf_counter()
    rep = Replay(REPLAY_FIXTURE)
    ref = rep.reference()
    if ref is None:
        fail("step 24: the replay fixture holds no JAX record")
    corpus = synthetic_corpus(HParams(**rep.meta["hparams"]), rep.seed)

    def run(device):
        rows, vals = [], {}
        hp = HParams(**copy.deepcopy(rep.meta["hparams"]))
        train(hp, seed=rep.seed, max_steps=rep.steps, device=device, corpus=corpus,
              verbose=False, replay=rep,
              step_hook=lambda s, m: rows.append([float(m[k]) for k in
                                                  ("nll", "grad_norm", "deranged")]),
              val_hook=lambda s, m: vals.setdefault(int(s), dict(m)))
        return np.asarray(rows, np.float64), vals

    reset_launches()
    t_card = time.perf_counter()
    gpu, gpu_vals = run(dev)
    card_s = time.perf_counter() - t_card
    launches = read_launches()
    require_launches("replay", launches, table1.TRAINED_KERNELS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t_cpu = time.perf_counter()
        cpu, cpu_vals = run(torch.device("cpu"))
        cpu_s = time.perf_counter() - t_cpu
    finally:
        torch.set_num_threads(threads)
    if gpu.shape != (rep.steps, 3) or not np.isfinite(gpu).all():
        fail(f"step 24: {gpu.shape[0]} steps of {rep.steps}, or a non-finite metric")
    fired = np.flatnonzero(ref["deranged"]).tolist()
    if (not fired or gpu[:, 2].tolist() != ref["deranged"].tolist()
            or cpu[:, 2].tolist() != ref["deranged"].tolist()):
        fail(f"step 24: branches card {np.flatnonzero(gpu[:, 2]).tolist()}, CPU "
             f"{np.flatnonzero(cpu[:, 2]).tolist()}, the JAX record {fired}")
    err = {}
    for col, key, rtol in ((0, "nll", REPLAY_NLL_RTOL), (1, "grad_norm", REPLAY_GRAD_RTOL)):
        want = ref[key]
        d_gpu = np.abs(gpu[:, col] - want) / np.abs(want)
        d_cpu = np.abs(cpu[:, col] - want) / np.abs(want)
        limit = np.maximum(rtol, REPLAY_DRIFT * d_cpu)
        limit[0] = rtol
        bad = np.flatnonzero(d_gpu > limit)
        if bad.size:
            i = int(bad[0])
            fail(f"step 24: step {i + 1} {key} {gpu[i, col]} against the JAX "
                 f"record's {want[i]}: {d_gpu[i]:.3e} relative, limit {limit[i]:.3e}")
        step10 = np.full(rep.steps, CPU_NLL_RTOL if key == "nll" else REPLAY_GRAD_RTOL)
        step10[0] = CPU_NLL_RTOL1 if key == "nll" else REPLAY_GRAD_RTOL
        d_card_cpu = np.abs(gpu[:, col] - cpu[:, col]) / np.abs(cpu[:, col])
        bad = np.flatnonzero(d_card_cpu > step10)
        if bad.size:
            i = int(bad[0])
            fail(f"step 24: step {i + 1} {key} {gpu[i, col]} on the card against "
                 f"{cpu[i, col]} on the CPU ({d_card_cpu[i]:.3e}, rtol {step10[i]})")
        err[key] = {"jax_max_rel": float(d_gpu.max()), "jax_first_rel": float(d_gpu[0]),
                    "cpu_jax_max_rel": float(d_cpu.max()),
                    "card_cpu_max_rel": float(d_card_cpu.max())}
    if sorted(gpu_vals) != sorted(cpu_vals) or sorted(gpu_vals) != rep.val_steps:
        fail(f"step 24: validations {sorted(gpu_vals)} on the card, "
             f"{sorted(cpu_vals)} on the CPU, the file's {rep.val_steps}")
    val_err = 0.0
    for step, want in cpu_vals.items():
        got = gpu_vals[step]
        scale = abs(want["val_loss"])
        val_err = max(val_err, check_close(f"step 24: val_loss at {step}",
                                           torch.tensor(got["val_loss"]),
                                           torch.tensor(want["val_loss"]),
                                           atol=0.0, rtol=CPU_NLL_RTOL))
        for key in rep.meta["probes"]:
            if abs(got[key] - want[key]) > 2 * CPU_NLL_RTOL * scale:
                fail(f"step 24: {key} at {step}: {got[key]} on the card, "
                     f"{want[key]} on the CPU (limit {2 * CPU_NLL_RTOL * scale})")
    step_s = time.perf_counter() - t24
    out = {"launches": launches, "fired": fired, "err": err, "val_err": val_err,
           "validations": {s: {k: gpu_vals[s][k] for k in ["val_loss", table1.GAP_KEY]}
                           for s in sorted(gpu_vals)},
           "card_s": card_s, "cpu_s": cpu_s, "step_s": step_s}
    print(f"step 24, the JAX start replayed ({rep.steps} steps at B={rep.batch_size}, "
          f"fired {fired}, validations {rep.val_steps}) on {card}: the card against "
          f"the JAX record {json.dumps(err)} (first step at NLL rtol {REPLAY_NLL_RTOL}, "
          f"gradient norm {REPLAY_GRAD_RTOL}; later steps at {REPLAY_DRIFT} x the CPU "
          f"replay's distance where larger); the card against the CPU replay at step "
          f"10's limits, val_loss {val_err:.3e}; launches {launches}; card {card_s:.1f} s, "
          f"CPU {cpu_s:.1f} s; {step_s:.1f} s  ok")
    return out


# Step 23: the kill and resume on the card at a cut (``long_run.py`` under
# ``supervise_train.py``, ``extract_val_curve.py``): final_model at full
# width, B=256, precision 32, k=8, the device data cache on, on
# RESUME_CHUNKS train chunks of 400 frames (2,568 windows of 80: 10 steps an
# epoch) and RESUME_VAL_CHUNKS val chunks, for RESUME_EPOCHS epochs. One
# parent runs its worker uninterrupted; beside it, another SIGTERMs its
# worker at the first logged step past RESUME_KILL_AT (a block's end in
# epoch 2, after epoch 1's checkpoint) and resumes it under supervise_train.
# Every block is logged (log_every 1). The two runs start before step 19
# and run beside its trials (their own processes on the one card; the
# step's seconds count from their start to their check).
RESUME_CHUNKS, RESUME_VAL_CHUNKS, RESUME_EPOCHS, RESUME_KILL_AT = 8, 2, 3, 12
RESUME_RUNS = {"whole": [], "killed": ["--kill_at_step", str(RESUME_KILL_AT)]}


def start_resume_runs(tmp) -> dict:
    """Step 23's two runs of the cut rehearsal, started at once in the
    background (they run beside step 19's trials; ``resume_step`` waits
    for them) -> {"procs": {name: (run_dir, log, parent process)}, "t0":
    their start, "held": what this process reserved on the card then}."""
    import gc

    import torch

    # the two workers take about 21 GiB each: hand back what the earlier
    # steps left in this process's allocator cache
    gc.collect()
    torch.cuda.empty_cache()
    held, t0 = torch.cuda.memory_reserved(), time.perf_counter()
    common = ["--n_train_chunks", str(RESUME_CHUNKS), "--n_val_chunks",
              str(RESUME_VAL_CHUNKS), "--max_epochs", str(RESUME_EPOCHS),
              "--log_every", "1"]
    procs = {}
    for name, extra in RESUME_RUNS.items():
        run_dir = Path(tmp) / f"resume_{name}"
        log = open(Path(tmp) / f"resume_{name}.log", "w")
        procs[name] = (run_dir, log, subprocess.Popen(
            [sys.executable, "-m", "lets_face_it_tpu_torch.long_run", "--run_dir",
             str(run_dir), "--ckpt_dir", str(run_dir / "ckpt"), "--out",
             str(run_dir / "curve.json"), *common, *extra],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO, start_new_session=True))
    return {"procs": procs, "t0": t0, "held": held}


def stop_resume_runs(runs) -> None:
    """Kill what is left of step 23's runs (a parent and its worker)."""
    for _, log, proc in runs["procs"].values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()


def resume_step(tmp, card, runs) -> dict:
    """Step 23: waits for the two runs ``start_resume_runs`` started, then
    (a) both parents exit 0, the killed run's first segment was killed in
    the middle of epoch 2 and its second resumed from epoch 1's checkpoint;
    (b) the two final checkpoints equal bit for bit (the model, Adam's
    state and rates, the step generator, the meta); (c) the resumed
    segment's validation rows equal the uninterrupted run's at the same
    steps; (d) ``extract_val_curve`` gives the segments expected; (e)
    ``cond_gates``, ``seq_fwd``, ``seq_bwd`` and (the validations'
    generation) ``seq_rev`` launched in the resumed segment (its worker's
    counters, path ``resume``)."""
    from lets_face_it_tpu_torch import long_run

    procs = runs["procs"]
    try:
        for _, _, proc in procs.values():
            proc.wait(timeout=600)
    finally:
        stop_resume_runs(runs)
    curves, summaries = {}, {}
    for name, (run_dir, log, proc) in procs.items():
        if proc.returncode != 0:
            tail = Path(log.name).read_text()[-3000:]
            fail(f"step 23: the {name} run exited {proc.returncode}:\n{tail}")
        curves[name] = json.loads((run_dir / "curve.json").read_text())
        summaries[name] = curves[name]["segments_summary"]
    whole, killed = summaries["whole"], summaries["killed"]
    spe = whole[0]["steps_per_epoch"]
    last = RESUME_EPOCHS * spe
    # (a) one segment uninterrupted; the kill in epoch 2, the resume from epoch 1
    if len(whole) != 1 or whole[0]["last_step"] != last or len(killed) != 2:
        fail(f"step 23: segments {whole} and {killed}")
    kill_at, resumed_from = killed[0]["killed_at_step"], killed[1]["resume_from_step"]
    if (kill_at is None or kill_at // spe != 1 or kill_at % spe == 0
            or resumed_from != spe or killed[1]["last_step"] != last):
        fail(f"step 23: killed at step {kill_at}, resumed from step {resumed_from} "
             f"({spe} steps an epoch), ended at {killed[1]['last_step']}")
    # (b) the final checkpoints
    ckpts = [Path(tmp) / f"resume_{name}" / "ckpt" / str(last) / "checkpoint.pt"
             for name in RESUME_RUNS]
    diffs = long_run.checkpoint_differences(*ckpts)
    if diffs:
        fail(f"step 23: the resumed run's final checkpoint differs from the "
             f"uninterrupted run's in {diffs[:10]} ({len(diffs)} entries)")
    # (c) the validation rows after the kill; (d) the segments
    rows_whole = curves["whole"]["segments"][0]["rows"]
    segs = curves["killed"]["segments"]
    after = segs[1]["rows"]
    if [r for r in rows_whole if r["step"] > resumed_from] != after:
        fail("step 23: the resumed segment's validation rows differ from the "
             "uninterrupted run's")
    want = [("segment_1.log", [spe]), ("segment_2.log", [2 * spe, last])]
    got = [(sg["log"], [r["step"] for r in sg["rows"]]) for sg in segs]
    if got != want or [r["step"] for r in rows_whole] != list(range(spe, last + 1, spe)):
        fail(f"step 23: extract_val_curve gave segments {got}, expected {want}")
    notes = " ".join(curves["killed"]["notes"]).lower()
    if "kill" not in notes or "resume" not in notes:
        fail(f"step 23: the curve's notes say nothing of the kill: {notes}")
    # (e) the resumed segment's launches
    events = long_run.read_events(Path(tmp) / "resume_killed" / "segment_2.log")
    launches = next(e["launches"] for e in events if e["long_run"] == "done")
    require_launches("resume", launches, ("cond_gates", "seq_fwd", "seq_bwd", "seq_rev"))
    step_s = time.perf_counter() - runs["t0"]
    out = {"steps_per_epoch": spe, "steps": last, "killed_at_step": kill_at,
           "resumed_from_step": resumed_from, "launches": launches,
           "segments": {name: summaries[name] for name in RESUME_RUNS},
           "val_after_kill": [{k: r[k] for k in ("step", "val_loss")} for r in after],
           "reserved_by_this_process_gib": runs["held"] / 1024**3, "step_s": step_s}
    print(f"step 23, kill and resume at a cut on {card}: final_model B=256, precision "
          f"32, k=8, {spe} steps an epoch, {RESUME_EPOCHS} epochs; SIGTERM at step "
          f"{kill_at}, resumed under supervise_train from step {resumed_from}; the final "
          f"checkpoint (weights, Adam's state, generator, meta) equal bit for bit to the "
          f"uninterrupted run's, validations after the kill equal; curve segments {got}; "
          f"resumed segment's launches {launches}; {step_s:.1f} s  ok")
    return out


def main() -> int:
    import numpy as np
    import torch

    build = BUILD or in_thread(timed_build)
    if not torch.cuda.is_available():
        with contextlib.suppress(BaseException):
            build()         # lets the nvcc processes it started end first
        fail("torch.cuda.is_available() is False; this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lets_face_it_tpu_torch import run_test as run_test_cli
    from lets_face_it_tpu_torch.core.ops import gaussian_logp
    from lets_face_it_tpu_torch.data import device_cache
    from lets_face_it_tpu_torch.data.prefetch import receive
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.model.encoders import (MODALITY_ORDER,
                                                       frame_dropout_mask)
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk
    from lets_face_it_tpu_torch.sample.generate import Generator
    from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator
    from lets_face_it_tpu_torch.sample.weights import (seeded_random_model,
                                                       state_dict_reference)
    from lets_face_it_tpu_torch.train import loop as train_loop
    from lets_face_it_tpu_torch.train import evaluate as evaluation
    from lets_face_it_tpu_torch.train import state as train_state
    from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # -- 1. the card ------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build ---------------------------------------------------------
    paths, build_s = build()
    print(f"build: {build_s:.2f} s for {len(paths)} libraries (started before the "
          "imports)")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    lap("1-2")

    with tempfile.TemporaryDirectory() as tmp:
        hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
        spec = FlowSpec.build(hp)
        if seqglow.sampling_path(spec) != "sequence":
            fail("final_model is outside the sequence kernel's envelope")

        k_steps, c, h = spec.n_steps, spec.channels, spec.hidden_channels
        cond, p1 = spec.cond.cond_dim, spec.cond.p1_face.out_dim
        n_seq = hp.Validation["seq_len"] - spec.cond.longest_history

        def sampling_weights(model):
            """-> (SamplingWeights, own-face projection slice [K, P1, cond])."""
            w_p1 = model.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2)
            return (fk.prepare_sampling_weights(spec, model.flow),
                    w_p1.contiguous().detach())

        model_gpu = seeded_random_model(spec, SEED).to(dev)
        w, w_p1_t = sampling_weights(model_gpu)
        gru = {k: v.detach().contiguous() for k, v in model_gpu.flow["rnn"].items()}
        g = torch.Generator(device=dev).manual_seed(SEED)

        def frame_inputs(b):
            return (torch.randn(b, c, generator=g, device=dev),
                    torch.randn(k_steps, b, cond, generator=g, device=dev),
                    0.5 * torch.randn(k_steps, b, h, generator=g, device=dev))

        def seq_inputs(b, n, p1_dim=p1):
            return (torch.randn(n, b, c, generator=g, device=dev),
                    torch.randn(n, k_steps, b, cond, generator=g, device=dev),
                    torch.randn(b, p1_dim, generator=g, device=dev),
                    torch.zeros(k_steps, b, h, device=dev))

        # -- 3. kernels against their plain versions ----------------------
        print(f"tolerance: one frame allclose(atol={ATOL}, rtol={RTOL}) "
              "(float32 FMA vs cuBLAS float32, other summation order); "
              f"sequences: first {SEQ_TIGHT} frames at that tolerance, all "
              f"frames |diff| <= {SEQ_LOOSE_ATOL} (rounding grows through the "
              "autoregressive own-face history)")
        with torch.no_grad():
            frame_err = {}
            for b in (1, 64, 512):
                z, projs, st = frame_inputs(b)
                x, st_new = fk.frame_rev_fused(spec, w, z, projs, st)
                x_ref, st_ref = fk.frame_rev_fused_ref(spec, w, z, projs, st)
                torch.cuda.synchronize()
                e1 = check_close(f"frame_rev B={b} x", x, x_ref)
                e2 = check_close(f"frame_rev B={b} states", st_new, st_ref)
                frame_err[b] = max(e1, e2)
                print(f"check frame_rev B={b}: max|dx| {e1:.3e} "
                      f"max|dstates| {e2:.3e}  ok")
            seq_err = {}
            for seed in SEQ_SEEDS:
                model_s = model_gpu if seed == SEED else \
                    seeded_random_model(spec, seed).to(dev)
                w_s, w_p1_s = (w, w_p1_t) if seed == SEED else sampling_weights(model_s)
                for b in (1, 128) if seed == SEED else (128,):
                    zs, fixed, hist0, st0 = seq_inputs(b, n_seq)
                    reset_launches()
                    xs = fk.sequence_rev_fused(spec, w_s, w_p1_s, zs, fixed, hist0, st0)
                    if seed == SEED and b == 128:
                        # sequence_sample's shape: the gates' many-row plan
                        seq_plans = read_plans()
                        require_plan("sequence_sample B=128", seq_plans,
                                     "sample_gates", "tile")
                    xs_ref = fk.sequence_rev_fused_ref(spec, w_s, w_p1_s, zs, fixed,
                                                       hist0, st0)
                    torch.cuda.synchronize()
                    what = f"seq_rev weights seed {seed} B={b}"
                    e_tight = check_close(f"{what} first {SEQ_TIGHT} frames",
                                          xs[:SEQ_TIGHT], xs_ref[:SEQ_TIGHT])
                    e_all = check_close(f"{what} all frames", xs, xs_ref,
                                        atol=SEQ_LOOSE_ATOL, rtol=0.0)
                    seq_err[seed, b] = e_all
                    print(f"check {what} N={n_seq}: max|dx| first {SEQ_TIGHT} "
                          f"frames {e_tight:.3e}, all frames {e_all:.3e} "
                          f"(max|x| {xs_ref.abs().max().item():.2f})  ok")
                del model_s

            # Not held, printed: why the weights leave the invconv's LU factors
            # unperturbed. With 0.05*N(0,1) added to them too, float32 rounding
            # alone (the plain version against itself in float64) changes
            # whole frames of the sequence.
            model_lu = seeded_random_model(spec, SEED).to(dev)
            g_lu = torch.Generator(device=dev).manual_seed(SEED)
            for name in ("l", "u"):
                leaf = model_lu.flow["perm"][name]
                leaf.add_(0.05 * torch.randn(leaf.shape, generator=g_lu, device=dev))
            for label, model_r in (("LU as initialised", model_gpu),
                                   ("LU perturbed", model_lu)):
                w_r, w_p1_r = sampling_weights(model_r)
                args = seq_inputs(128, n_seq)
                xs = fk.sequence_rev_fused(spec, w_r, w_p1_r, *args)
                ref32 = fk.sequence_rev_fused_ref(spec, w_r, w_p1_r, *args)
                ref64 = fk.sequence_rev_fused_ref(
                    spec, weights64(w_r),
                    w_p1_r.double(), *(t.double() for t in args))
                print(f"drift, not held ({label}, B=128 N={n_seq}): kernel vs "
                      f"plain {json.dumps(drift(xs, ref32))}; plain float32 vs "
                      f"float64 {json.dumps(drift(ref32, ref64))}; max|x| "
                      f"{ref64.abs().max().item():.2f}")
            del model_lu

            # the two kernels of a frame alone, and both wrappers at odd
            # batches (partial row tiles and clusters)
            frame_gates_err, frame_chain_err = {}, {}
            for b in (1, 5, 33, 64, 128, 512):
                z, projs, st = frame_inputs(b)
                hist = torch.randn(b, p1, generator=g, device=dev)
                for label, hist_b, w_p1_b in (("own face", hist, w_p1_t),
                                              ("cond_projs", hist[:, :0],
                                               w_p1_t[:, :0])):
                    ref = fk.sample_gates_ref(spec, w, w_p1_b, projs, hist_b, st)
                    # each plan forced (the launcher's is one of them)
                    e_g = 0.0
                    for plan in ("vector", "tile"):
                        got = fk.sample_gates(spec, w, w_p1_b, projs, hist_b, st,
                                              plan=plan)
                        torch.cuda.synchronize()
                        e_g = max([e_g] + [
                            check_close(f"sample_gates {label} B={b} {plan} plan {nm}",
                                        a_, r_)
                            for nm, a_, r_ in zip(("proj", "gc", "gh"), got, ref)])
                    if b == 128 and label == "own face":
                        # the tile plan's 3xTF32 at "highest" is no farther from
                        # the float64 product than the plain float32 version
                        ref64 = fk.sample_gates_ref(spec, weights64(w), w_p1_b.double(),
                                                    projs.double(), hist_b.double(),
                                                    st.double())
                        gates_rms = f64_rms_check(
                            "sample_gates B=128 tile plan",
                            fk.sample_gates(spec, w, w_p1_b, projs, hist_b, st,
                                            plan="tile"), ref, ref64)
                    _, gc, gh = ref
                    hist_c = hist_b if hist_b.shape[-1] else None
                    got = fk.sample_chain(spec, w, z, gc, gh, st, hist_c)
                    ref = fk.sample_chain_ref(spec, w, z, gc, gh, st, hist_c)
                    torch.cuda.synchronize()
                    e_c = max(check_close(f"sample_chain {label} B={b} {nm}", a_, r_)
                              for nm, a_, r_ in zip(("x", "states", "hist"), got, ref)
                              if r_ is not None)
                    frame_gates_err[b] = max(frame_gates_err.get(b, 0.0), e_g)
                    frame_chain_err[b] = max(frame_chain_err.get(b, 0.0), e_c)
                print(f"check sample_gates / sample_chain B={b} (own face and given "
                      f"cond_projs; the gates on both plans, the launcher's "
                      f"{fk.gates_plan(b)}): max|d| "
                      f"{frame_gates_err[b]:.3e} / {frame_chain_err[b]:.3e}  ok")
            for b in (5, 33):
                z, projs, st = frame_inputs(b)
                x, st_new = fk.frame_rev_fused(spec, w, z, projs, st)
                x_ref, st_ref = fk.frame_rev_fused_ref(spec, w, z, projs, st)
                torch.cuda.synchronize()
                e1 = max(check_close(f"frame_rev B={b} x", x, x_ref),
                         check_close(f"frame_rev B={b} states", st_new, st_ref))
                zs, fixed, hist0, st0 = seq_inputs(b, n_seq)
                xs = fk.sequence_rev_fused(spec, w, w_p1_t, zs, fixed, hist0, st0)
                xs_ref = fk.sequence_rev_fused_ref(spec, w, w_p1_t, zs, fixed, hist0, st0)
                torch.cuda.synchronize()
                e_tight = check_close(f"seq_rev B={b} first {SEQ_TIGHT} frames",
                                      xs[:SEQ_TIGHT], xs_ref[:SEQ_TIGHT])
                e_all = check_close(f"seq_rev B={b} all frames", xs, xs_ref,
                                    atol=SEQ_LOOSE_ATOL, rtol=0.0)
                print(f"check odd batch B={b}: frame_rev max|d| {e1:.3e}; seq_rev "
                      f"N={n_seq} first {SEQ_TIGHT} frames {e_tight:.3e}, all "
                      f"{e_all:.3e}  ok")

            hp_nf = load_hparams(REPO / "hparams" / "no_face.yaml", dataset_root=tmp)
            spec_nf = FlowSpec.build(hp_nf)
            model_nf = seeded_random_model(spec_nf, SEED + 1).to(dev)
            w_nf = fk.prepare_sampling_weights(spec_nf, model_nf.flow)
            zs, fixed, hist0, st0 = seq_inputs(4, n_seq, p1_dim=0)
            w_p1_nf = torch.zeros(k_steps, 0, cond, device=dev)
            xs = fk.sequence_rev_fused(spec_nf, w_nf, w_p1_nf, zs, fixed, hist0, st0)
            xs_ref = fk.sequence_rev_fused_ref(spec_nf, w_nf, w_p1_nf, zs, fixed,
                                               hist0, st0)
            torch.cuda.synchronize()
            e_nf = check_close("seq_rev no_face (P1=0)", xs, xs_ref)
            print(f"check seq_rev no_face P1=0 B=4 N={n_seq}: max|dx| {e_nf:.3e}  ok")
            del model_nf, w_nf

        lap("3")

        # -- 4. the main path ---------------------------------------------
        ckpt = Path(tmp) / "final_model_random.pt"
        torch.save(state_dict_reference(model_gpu), ckpt)
        gen = Generator.from_checkpoint(ckpt, hparams_file=REPO / "hparams" /
                                        "final_model.yaml", dataset_root=tmp,
                                        device="cuda")
        rng = np.random.default_rng(SEED)
        frames = rng.standard_normal((hp.Validation["seq_len"], 273)).astype(np.float32)
        z_gen = torch.as_tensor(rng.standard_normal((n_seq, 1, c)).astype(np.float32))
        sc = hp.Data["speech_dim"]

        def stream_frames(b, n):
            return [{"p2_face": rng.standard_normal((b, c)).astype(np.float32),
                     "p1_speech": rng.standard_normal((b, sc)).astype(np.float32),
                     "p2_speech": rng.standard_normal((b, sc)).astype(np.float32)}
                    for _ in range(n)]

        s1_frames = stream_frames(1, 58)
        s1_z = torch.as_tensor(rng.standard_normal((58, 1, c)).astype(np.float32))
        s64_frames = stream_frames(64, 10)

        def run_stream(stream_model, device, z):
            """50 pushes and one push_many of 8 at B=1 -> [58, C] on the CPU."""
            s = StreamingGenerator(spec, stream_model, batch_size=1, seed=SEED,
                                   device=device)
            outs = [s.push(**f, z=z[i]) for i, f in enumerate(s1_frames[:50])]
            many = {n: np.stack([f[n] for f in s1_frames[50:]], 1)
                    for n in s1_frames[0]}
            outs.append(s.push_many(**many, z=z[50:].transpose(0, 1)))
            return torch.cat([o.reshape(-1, c) for o in outs]).cpu()

        reset_launches()
        t0 = time.perf_counter()
        out = gen.generate(frames, seed=SEED, z=z_gen)
        s1_out = run_stream(gen.model, "cuda", s1_z)
        s64 = StreamingGenerator(spec, gen.model, batch_size=64, seed=SEED,
                                 device="cuda")
        s64_out = torch.stack([s64.push(**f) for f in s64_frames], 1)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        launches = {"frame_rev": fk.frame_rev_fused.launches,
                    "seq_rev": fk.sequence_rev_fused.launches,
                    "sample_gates": fk.sample_gates.launches,
                    "sample_chain": fk.sample_chain.launches}
        serving_plans = read_plans()
        print(f"main path: {t_main:.3f} s (includes first-use costs); "
              f"launches {launches}; gates plans {serving_plans['sample_gates']} "
              "(B=1 vector, the B=64 pushes tile)")
        require_plan("serving (B=64 pushes)", serving_plans, "sample_gates", "tile")
        require_plan("serving (B=1)", serving_plans, "sample_gates", "vector")

        # -- 5. the path went through the kernels, and its outputs are right
        for name, count in launches.items():
            if count == 0:
                fail(f"{name} kernel was never launched on the main path")
        if out.shape != (1, n_seq, 106) or not np.isfinite(out).all():
            fail(f"generate: bad output {out.shape}")
        if s64_out.shape != (64, 10, c) or not torch.isfinite(s64_out).all():
            fail(f"streaming B=64: bad output {tuple(s64_out.shape)}")
        gen_ref = Generator.from_checkpoint(ckpt, hparams_file=REPO / "hparams" /
                                            "final_model.yaml", dataset_root=tmp,
                                            device="cpu")
        out_ref = gen_ref.generate(frames, seed=SEED, z=z_gen)
        e_t = check_close(f"generate vs CPU plain path, first {SEQ_TIGHT} frames",
                          torch.as_tensor(out[:, :SEQ_TIGHT]),
                          torch.as_tensor(out_ref[:, :SEQ_TIGHT]))
        e_a = check_close("generate vs CPU plain path, all frames",
                          torch.as_tensor(out), torch.as_tensor(out_ref),
                          atol=SEQ_LOOSE_ATOL, rtol=0.0)
        print(f"check generate [1, {n_seq}, 106] vs CPU plain path: max|d| first "
              f"{SEQ_TIGHT} frames {e_t:.3e}, all {e_a:.3e}  ok")
        s1_ref = run_stream(gen_ref.model, "cpu", s1_z)
        e_s = check_close("streaming B=1 (50 push + push_many 8) vs CPU plain path",
                          s1_out, s1_ref, atol=SEQ_LOOSE_ATOL, rtol=0.0)
        e_s8 = check_close("streaming B=1 first 8 pushes vs CPU plain path",
                           s1_out[:SEQ_TIGHT], s1_ref[:SEQ_TIGHT])
        print(f"check streaming B=1 58 frames vs CPU plain path: max|d| first "
              f"{SEQ_TIGHT} {e_s8:.3e}, all {e_s:.3e}  ok")

        lap("4-5")

        # -- 6. timings -----------------------------------------------------
        print(f"timings on {card} (CUDA events / host clock around "
              "synchronised work; weights warm in L2)")
        t_gen = time_ms(lambda: gen.generate(frames, seed=SEED), reps=5)
        print(f"offline generate B=1 N={n_seq}: {t_gen:.3f} ms/sequence = "
              f"{n_seq / t_gen * 1e3:.1f} frames/s (Generator.generate, "
              "host to host)")
        data128 = {k: torch.as_tensor(rng.standard_normal((128, hp.Validation["seq_len"], d))
                                      .astype(np.float32), device=dev)
                   for k, d in (("p1_face", c), ("p2_face", c),
                                ("p1_speech", sc), ("p2_speech", sc))}
        t128 = time_ms(lambda: seqglow.sequence_sample(
            spec, gen.model, data128, hp.Validation["seq_len"], generator=g), reps=3)
        print(f"offline sequence_sample B=128 N={n_seq}: {t128:.3f} ms = "
              f"{128 * n_seq / t128 * 1e3:.1f} frames/s")
        for b, frs in ((1, s1_frames[:1]), (64, s64_frames[:1])):
            s = StreamingGenerator(spec, gen.model, batch_size=b, seed=SEED,
                                   device="cuda")
            t_push = time_ms(lambda: s.push(**frs[0]), reps=20)
            print(f"streaming push B={b}: {t_push:.3f} ms/push")

        records = []
        with torch.no_grad():
            rows = []
            for b in (1, 64, 512):
                z, projs, st = frame_inputs(b)
                call = lambda: fk.frame_rev_fused(spec, w, z, projs, st)  # noqa: E731
                ms = time_ms(graphed(call), 20)
                wrapper = time_ms(call, 20)
                plain = time_ms(lambda: fk.frame_rev_fused_ref(spec, w, z, projs, st), 5)
                lib = time_ms(graphed(lambda: library_frame_rev(spec, w, gru, z, projs,
                                                                st)), 20)
                bound, by = frame_bound_ms(spec, w, b)
                rows.append({"batch": b, "ms": ms, "wrapper_ms": wrapper,
                             "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                             "library_ms": lib})
                print(f"frame_rev B={b}: kernel {ms:.4f} ms (graph replay; "
                      f"{wrapper:.4f} ms through the wrapper), plain {plain:.4f} ms, "
                      f"library (graphed gru_cell/addmm) {lib:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})")
            records.append(dict(
                name="frame_rev", route="cuda",
                source="lets_face_it_tpu_torch/csrc/frame_rev.cu",
                replaces="lets_face_it_tpu/ops/pallas_flow.py:130",
                launches=launches["frame_rev"],
                max_abs_err=frame_err[1],
                **{k: v for k, v in rows[0].items() if k != "batch"},
                by_batch=rows))
            rows = []
            for b in (1, 128):
                zs, fixed, hist0, st0 = seq_inputs(b, n_seq)
                call = lambda: fk.sequence_rev_fused(  # noqa: E731
                    spec, w, w_p1_t, zs, fixed, hist0, st0)
                ms = time_ms(graphed(call), 3, warmup=1)
                wrapper = time_ms(call, 3, warmup=1)
                plain = time_ms(lambda: fk.sequence_rev_fused_ref(
                    spec, w, w_p1_t, zs, fixed, hist0, st0), 1, warmup=1)
                lib = time_ms(graphed(lambda: library_seq_rev(
                    spec, w, gru, w_p1_t, zs, fixed, hist0, st0)), 3, warmup=1)
                bound, by = seq_bound_ms(spec, w, n_seq, b)
                rows.append({"batch": b, "frames": n_seq, "ms": ms,
                             "wrapper_ms": wrapper, "plain_ms": plain,
                             "bound_ms": bound, "bound_by": by, "library_ms": lib})
                print(f"seq_rev B={b} N={n_seq}: kernel {ms:.4f} ms (graph replay; "
                      f"{wrapper:.4f} ms through the wrapper), plain {plain:.4f} ms, "
                      f"library (graphed) {lib:.4f} ms, bound {bound:.4f} ms ({by})")
            records.append(dict(
                name="seq_rev", route="cuda",
                source="lets_face_it_tpu_torch/csrc/seq_rev.cu",
                replaces="lets_face_it_tpu/ops/pallas_flow.py:346",
                launches=launches["seq_rev"], max_abs_err=seq_err[SEED, 1],
                **{k: v for k, v in rows[0].items() if k not in ("batch", "frames")},
                by_batch=rows))

            # the two kernels of a frame alone, at the shapes the main paths
            # give them: generate B=1 and sequence_sample B=128 (own face,
            # proj with gh then gc), a push at B=64 (cond_projs given, gc with
            # gh in one launch)
            gate_rows, chain_rows = [], []
            for b, own in ((1, True), (64, False), (128, True)):
                z, projs, st = frame_inputs(b)
                p1_b = p1 if own else 0
                hist = torch.randn(b, p1_b, generator=g, device=dev)
                w_p1_b = w_p1_t[:, :p1_b]
                gates_call = lambda: fk.sample_gates(  # noqa: E731
                    spec, w, w_p1_b, projs, hist, st)
                _, gc, gh = gates_call()
                hist_c = hist if own else None
                chain_call = lambda: fk.sample_chain(  # noqa: E731
                    spec, w, z, gc, gh, st, hist_c)
                for rows_, name, call, plain_fn, lib_fn, (bound, by) in (
                        (gate_rows, "sample_gates", gates_call,
                         lambda: fk.sample_gates_ref(spec, w, w_p1_b, projs, hist, st),
                         lambda: library_gates(spec, w, w_p1_b, projs, hist, st),
                         gates_bound_ms(spec, b, p1_b)),
                        (chain_rows, "sample_chain", chain_call,
                         lambda: fk.sample_chain_ref(spec, w, z, gc, gh, st, hist_c),
                         lambda: fk.sample_chain_ref(spec, w, z, gc, gh, st, hist_c),
                         chain_bound_ms(spec, w, b, p1_b))):
                    row = {"batch": b, "own_face": own,
                           "ms": time_ms(graphed(call), 20),
                           "wrapper_ms": time_ms(call, 20),
                           "plain_ms": time_ms(plain_fn, 5),
                           "library_ms": time_ms(graphed(lib_fn), 20),
                           "bound_ms": bound, "bound_by": by}
                    other = ""
                    if name == "sample_gates":
                        # the launcher's plan, beside the other plan forced
                        row["plan"] = fk.gates_plan(b)
                        other_plan = "vector" if row["plan"] == "tile" else "tile"
                        row[f"{other_plan}_plan_ms"] = time_ms(graphed(
                            lambda: fk.sample_gates(spec, w, w_p1_b, projs, hist, st,
                                                    plan=other_plan)), 20)
                        other = (f" on the {row['plan']} plan ({other_plan} plan "
                                 f"{row[f'{other_plan}_plan_ms']:.4f} ms)")
                    rows_.append(row)
                    print(f"{name} B={b} ({'own face' if own else 'cond_projs given'}): "
                          f"kernel {row['ms']:.4f} ms{other} (graph replay; "
                          f"{row['wrapper_ms']:.4f} ms through the wrapper), plain "
                          f"{row['plain_ms']:.4f} ms, library (graphed ATen) "
                          f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
            for name, source, replaces, rows_, err in (
                    ("sample_gates", "lets_face_it_tpu_torch/csrc/sample_gates.cuh",
                     "lets_face_it_tpu/ops/pallas_flow.py:172", gate_rows, frame_gates_err),
                    ("sample_chain", "lets_face_it_tpu_torch/csrc/sample_chain.cuh",
                     "lets_face_it_tpu/ops/pallas_flow.py:152", chain_rows, frame_chain_err)):
                records.append(dict(
                    name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=err[1],
                    **{k: v for k, v in rows_[0].items()
                       if k not in ("batch", "own_face")},
                    by_batch=rows_))

        lap("6")

        # -- 7. where the time goes ------------------------------------------
        print(f"profile on {card}: host wall per call without the profiler, "
              "device time from a torch.profiler trace of as many calls")
        for b, frs in ((1, s1_frames[:1]), (64, s64_frames[:1])):
            s = StreamingGenerator(spec, gen.model, batch_size=b, seed=SEED,
                                   device="cuda")
            print(json.dumps(trace_window(f"push_b{b}", lambda: s.push(**frs[0]),
                                          PROFILE_CALLS)))
        print(json.dumps(trace_window(
            "generate_b1", lambda: gen.generate(frames, seed=SEED),
            PROFILE_CALLS // 3)))

        lap("7")

        # -- 8. training kernels against their plain versions; gradients --
        # (checks only: they run beside steps 19 and 23, training_kernel_checks)
        if seqglow.training_path(spec) != "kernels":
            fail("final_model is outside the training kernels' envelope")
        b_tr = hp.batch_size
        n_tr = hp.Train["seq_len"] - spec.cond.longest_history

        def train_inputs(b, n):
            return (torch.randn(n, b, c, generator=g, device=dev),
                    torch.randn(n, k_steps, b, cond, generator=g, device=dev),
                    0.3 * torch.randn(k_steps, b, h, generator=g, device=dev))

        def training_kernel_checks():
            """Step 8 -> (gates_err, fwd_err, bwd_err, gates_rms) by weight seed."""
            print(f"training tolerances: seq_fwd vs plain atol {TRAIN_VAL_ATOL} rtol "
                  f"{TRAIN_VAL_RTOL}; seq_bwd vs plain atol {TRAIN_BWD_ATOL} rtol "
                  f"{TRAIN_BWD_RTOL}; Function gradients vs eager autograd |diff| <= "
                  f"{GRAD_ATOL} + {GRAD_LEAF_RTOL} * max|leaf| (sums over N*B rows "
                  "in another order)")

            def flow_gradients(run, model_t, dtype, inputs):
                """Loss and gradients on every trained flow leaf (but the unused
                cond_proj) and on the three inputs, of ``run`` in ``dtype``."""
                tree = {gn: {ln: p.detach().to(dtype).requires_grad_(p.requires_grad)
                             for ln, p in grp.items()}
                        for gn, grp in model_t.flow.items()}
                names = [(gn, ln) for gn, grp in tree.items() for ln, p in grp.items()
                         if p.requires_grad and gn != "cond_proj"]
                xs_, cs_, st_ = (x.detach().to(dtype).requires_grad_() for x in inputs)
                z, ld, ns, _ = run(spec, tree, xs_, cs_, st_)
                loss = sequence_objective(z, ld, ns)
                grads = torch.autograd.grad(loss, [tree[gn][ln] for gn, ln in names]
                                            + [xs_, cs_, st_])
                keys = [f"{gn}.{ln}" for gn, ln in names] + ["xs", "cond_seq", "states0"]
                return loss.item(), dict(zip(keys, grads))

            gates_err, fwd_err, bwd_err, grad_ratio, gates_rms = {}, {}, {}, {}, {}
            for seed in TRAIN_SEEDS:
                model_t = (model_gpu if seed == SEED
                           else seeded_random_model(spec, seed).to(dev))
                xs, cs, st0 = train_inputs(b_tr, n_tr)
                with torch.no_grad():
                    tw = tk.prepare_train_weights(spec, model_t.flow)
                    gc_ref = tk.cond_gates_ref(spec, tw, cs)
                    gc_tc = tk.cond_gates(spec, tw, cs)
                    gates_err[seed] = max(check_close(
                        f"cond_gates seed {seed} {plan} plan",
                        tk.cond_gates(spec, tw, cs, plan=plan), gc_ref,
                        TRAIN_VAL_ATOL, TRAIN_VAL_RTOL) for plan in tk.COND_GATES_PLANS)
                    gates_err[seed] = max(gates_err[seed], check_close(
                        f"cond_gates seed {seed} launcher's plan", gc_tc, gc_ref,
                        TRAIN_VAL_ATOL, TRAIN_VAL_RTOL))
                    # the launcher's plan against the float64 product (the simt
                    # plan gives the plain version's bits; the tc plan's 3xTF32,
                    # not taken at "highest", is read beside it)
                    gc_64 = tk.cond_gates_ref(spec, tk.TrainWeights(*(t.double() for t in tw)),
                                              cs.double())
                    gates_rms[seed] = f64_rms_check(
                        f"cond_gates seed {seed} {tk.cond_gates_plan(0)[0]} plan", gc_tc, gc_ref,
                        gc_64)
                    gates_rms[seed]["tc_plan_3xtf32"] = f64_rms_check(
                        f"cond_gates seed {seed} tc plan (3xTF32, not the launcher's)",
                        tk.cond_gates(spec, tw, cs, plan="tc"), gc_ref, gc_64)["kernel"]
                    del gc_ref, gc_tc, gc_64
                    got = tk.seq_fwd(spec, tw, xs, cs, st0)
                    ref = tk.seq_fwd_ref(spec, tw, xs, cs, st0)
                    torch.cuda.synchronize()
                    fwd_err[seed] = max(
                        check_close(f"seq_fwd seed {seed} {nm}", a, r,
                                    TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)
                        for nm, a, r in zip(("z", "scales", "zs_res", "states_res",
                                             "gc"), got, ref))
                    _, scales_r, zs_res, st_res, gc = ref
                    hprev = torch.cat([st0[None], st_res[:-1]])
                    cot = (torch.randn(xs.shape, generator=g, device=dev),
                           torch.randn(scales_r.shape, generator=g, device=dev),
                           torch.randn(st0.shape, generator=g, device=dev))
                    got = tk.seq_bwd(spec, tw, gc, zs_res, hprev, *cot)
                    ref = tk.seq_bwd_ref(spec, tw, gc, zs_res, hprev, *cot)
                    torch.cuda.synchronize()
                    bwd_err[seed] = max(
                        check_close(f"seq_bwd seed {seed} {nm}", a, r,
                                    TRAIN_BWD_ATOL, TRAIN_BWD_RTOL)
                        for nm, a, r in zip(("dx", "dstates0", "dgi", "dghn", "dhout",
                                             "dzb"), got, ref))
                print(f"check cond_gates / seq_fwd / seq_bwd weights seed {seed} B={b_tr} "
                      f"N={n_tr}: max|d| {gates_err[seed]:.3e} / {fwd_err[seed]:.3e} / "
                      f"{bwd_err[seed]:.3e}  ok")
                l_k, g_k = flow_gradients(tk.flow_sequence_fused, model_t,
                                          torch.float32, (xs, cs, st0))
                l_e, g_e = flow_gradients(eager_flow_sequence, model_t,
                                          torch.float32, (xs, cs, st0))
                l_64, g_64 = flow_gradients(eager_flow_sequence, model_t,
                                            torch.float64, (xs, cs, st0))
                grad_drift = {}
                for name, ref in g_e.items():
                    scale = ref.abs().max().item()
                    err = (g_k[name].double() - ref.double()).abs().max().item()
                    limit = GRAD_ATOL + GRAD_LEAF_RTOL * scale
                    if not torch.isfinite(g_k[name]).all() or err > limit:
                        fail(f"Function gradient {name} (weights seed {seed}): max|diff| "
                             f"{err:.3e} > {limit:.3e} (max|ref| {scale:.3e})")
                    grad_ratio[seed, name] = err / limit
                    truth = g_64[name]
                    grad_drift[name] = [
                        round((g_k[name].double() - truth).abs().max().item()
                              / truth.abs().max().item(), 9),
                        round((ref.double() - truth).abs().max().item()
                              / truth.abs().max().item(), 9)]
                print(f"check Function gradients vs eager autograd, weights seed {seed} "
                      f"B={b_tr} N={n_tr}: loss {l_k:.6f} vs {l_e:.6f} (float64 "
                      f"{l_64:.6f}); largest max|diff| / limit "
                      f"{max(v for (s_, _), v in grad_ratio.items() if s_ == seed):.3f}  ok")
                print("drift, not held (max|diff| / max|grad| against eager float64; "
                      f"[kernels, eager float32]) seed {seed}: {json.dumps(grad_drift)}")
                del model_t
            return gates_err, fwd_err, bwd_err, gates_rms

        # -- 9. the training main path --------------------------------------
        corpus = train_loop.synthetic_corpus(hp, SEED, n_train_chunks=TRAIN_CHUNKS)
        ckpt_dir = Path(tmp) / "train_ckpt"
        step_log, val_log = [], []
        reset_launches()
        t0 = time.perf_counter()
        state, best_val = train_loop.train(
            hp, seed=SEED, ckpt_dir=ckpt_dir, max_steps=TRAIN_STEPS, device="cuda",
            corpus=corpus,
            step_hook=lambda s, m: step_log.append({k: float(v) for k, v in m.items()}),
            val_hook=lambda s, m: val_log.append(m))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        train_launches = {"cond_gates": tk.cond_gates.launches,
                          "seq_fwd": tk.seq_fwd.launches,
                          "seq_bwd": tk.seq_bwd.launches,
                          "seq_rev": fk.sequence_rev_fused.launches}
        train_plans = read_plans()
        print(f"training main path: {TRAIN_STEPS} steps at B={b_tr} and one "
              f"validation in {t_train:.3f} s (includes first-use costs); "
              f"launches {train_launches}; gate plans {train_plans}")
        require_plan("training", train_plans, "cond_gates", tk.cond_gates_plan(0)[0])
        require_plan("training (the validation's generation)", train_plans,
                     "sample_gates", "tile")
        for name, count in train_launches.items():
            if count == 0:
                fail(f"{name} kernel was never launched on the training path")
        if len(step_log) != TRAIN_STEPS or len(val_log) != 1:
            fail(f"training took {len(step_log)} steps and {len(val_log)} validations")
        for m in step_log + val_log:
            if not all(np.isfinite(v) for v in m.values()):
                fail(f"non-finite training metrics {m}")
        print(f"check training metrics finite: steps {json.dumps(step_log)}; "
              f"validation {json.dumps(val_log[0])}  ok")
        gen_t = Generator.from_checkpoint(CheckpointManager(ckpt_dir).latest(),
                                          dataset_root=tmp, device="cuda")
        out_t = gen_t.generate(frames, seed=SEED)
        if out_t.shape != (1, n_seq, 106) or not np.isfinite(out_t).all():
            fail(f"generate from the training checkpoint: bad output {out_t.shape}")
        print(f"check training checkpoint -> Generator.from_checkpoint -> generate "
              f"{out_t.shape}  ok")

        lap("9")

        # -- 10. GPU steps against the CPU plain path ------------------------
        train_ds, _ = train_loop.load_datasets(hp, corpus)
        batch_np = train_ds.get_batch(np.arange(CPU_BATCH))
        g_draws = torch.Generator().manual_seed(SEED)
        draws = []
        for _ in range(CPU_STEPS):
            coin = float(torch.rand((), generator=g_draws))
            perm = torch.randperm(CPU_BATCH, generator=g_draws)
            masks = {m: frame_dropout_mask(es, (CPU_BATCH, n_tr, es.history), g_draws)
                     for m in MODALITY_ORDER
                     if (es := getattr(spec.cond, m)) is not None
                     and es.dropout > 0 and es.out_dim > 0}
            draws.append(train_state.StepDraws(coin, perm, masks))

        def run_steps(device):
            model_s = seeded_random_model(spec, SEED).to(device)
            st = train_state.TrainState.create(model_s, hp, 3, SEED)
            jb = train_loop.to_device(batch_np, device)
            train_state.run_actnorm_init(spec, st, jb)
            logs = [{k: float(v) for k, v in
                     train_state.train_step(spec, hp, st, jb, draws=d).items()}
                    for d in draws]
            return logs, {n: p.detach().cpu() for n, p in model_s.named_parameters()}

        t0 = time.perf_counter()
        gpu_logs, gpu_params = run_steps(dev)
        cpu_logs, cpu_params = run_steps(torch.device("cpu"))
        print(f"GPU and CPU plain path, {CPU_STEPS} steps at B={CPU_BATCH}: "
              f"{time.perf_counter() - t0:.1f} s; GPU {json.dumps(gpu_logs)}; "
              f"CPU {json.dumps(cpu_logs)}")
        for i, (a, b) in enumerate(zip(gpu_logs, cpu_logs)):
            rtol = CPU_NLL_RTOL1 if i == 0 else CPU_NLL_RTOL
            if abs(a["nll"] - b["nll"]) > rtol * abs(b["nll"]) or a["deranged"] != b["deranged"]:
                fail(f"step {i + 1}: GPU nll {a['nll']} vs CPU {b['nll']} (rtol {rtol})")
        e_p = max(check_close(f"weights after {CPU_STEPS} steps, {n}", gpu_params[n],
                              cpu_params[n], CPU_PARAM_ATOL, 0.0) for n in cpu_params)
        print(f"check GPU vs CPU plain path: nll rtol {CPU_NLL_RTOL1} (step 1) / "
              f"{CPU_NLL_RTOL}, weights max|d| {e_p:.3e} <= {CPU_PARAM_ATOL}  ok")

        lap("10")

        # -- 11. training timings and profile ---------------------------------
        jb = train_loop.to_device(train_ds.get_batch(np.arange(b_tr)), dev)
        t_step = time_ms(lambda: train_state.train_step(spec, hp, state, jb), reps=3,
                         warmup=1)
        print(f"training step B={b_tr}: {t_step:.3f} ms/step = "
              f"{b_tr / t_step * 1e3:.1f} windows/s (train_step, host to host, "
              f"on {card})")
        xs, cs, st0 = train_inputs(b_tr, n_tr)
        flow_t = state.model.flow
        with torch.no_grad():
            tw = tk.prepare_train_weights(spec, flow_t)
            fwd_call = lambda: tk.seq_fwd(spec, tw, xs, cs, st0)  # noqa: E731
            _, scales_r, zs_res, st_res, gc = fwd_call()
            hprev = torch.cat([st0[None], st_res[:-1]])
            cot = (torch.randn(xs.shape, generator=g, device=dev),
                   torch.randn(scales_r.shape, generator=g, device=dev),
                   torch.randn(st0.shape, generator=g, device=dev))
            bwd_call = lambda: tk.seq_bwd(spec, tw, gc, zs_res, hprev, *cot)  # noqa: E731
            gates_call = lambda: tk.cond_gates(spec, tw, cs)  # noqa: E731
            fwd_ms, bwd_ms = time_ms(graphed(fwd_call), 3), time_ms(graphed(bwd_call), 3)
            gemm_ms = time_ms(graphed(gates_call), 3)
            serial_ms = time_ms(graphed(
                lambda: tk.seq_fwd_serial(spec, tw, xs, gc, st0)), 3)
            fwd_wrap, bwd_wrap = time_ms(fwd_call, 3), time_ms(bwd_call, 3)
            gates_wrap = time_ms(gates_call, 3)
            fwd_plain = time_ms(lambda: tk.seq_fwd_ref(spec, tw, xs, cs, st0), 1, warmup=1)
            bwd_plain = time_ms(lambda: tk.seq_bwd_ref(spec, tw, gc, zs_res, hprev,
                                                       *cot), 1, warmup=1)
            gates_plain = time_ms(lambda: tk.cond_gates_ref(spec, tw, cs), 3)
            plans_ms = cond_plans_ms(spec, tw, cs, "highest", 3)
            # the library GEMM: one cuBLAS call, on operands laid out for it
            lib_a = torch.nn.functional.leaky_relu(cs, 0.01).permute(1, 0, 2, 3).reshape(
                k_steps, -1, cond).contiguous()
            lib_w = tw.w_ih_t[:, spec.z1_dim:].contiguous()
            lib_b = tw.b_ih[:, None, :].contiguous()
            lib_gates = time_ms(graphed(lambda: torch.baddbmm(lib_b, lib_a, lib_w)), 3)
            del lib_a
            lib_fwd = time_ms(graphed(lambda: eager_flow_sequence(
                spec, flow_t, xs, cs, st0), EAGER_WARMUP), 3)
        # the library backward: the eager loop's autograd backward (inputs and
        # flow weights)
        lib_bwd = library_backward_ms(spec, flow_t, (xs, cs, st0), cot, "highest", 3)
        fwd_bound, fwd_by = train_fwd_bound_ms(spec, tw, n_tr, b_tr)
        bwd_bound, bwd_by = train_bwd_bound_ms(spec, tw, n_tr, b_tr)
        gates_bound, gates_by = cond_gates_bound_ms(spec, n_tr, b_tr)
        serial_bound, serial_by = train_serial_bound_ms(spec, n_tr, b_tr)
        print(f"seq_fwd B={b_tr} N={n_tr}: whole route {fwd_ms:.4f} ms = cond_gates "
              f"{gemm_ms:.4f} ms + serial kernel {serial_ms:.4f} ms (graph replay; "
              f"the serial kernel's bound {serial_bound:.4f} ms, {serial_by}); "
              f"pair fwd + bwd {fwd_ms + bwd_ms:.4f} ms against bounds "
              f"{fwd_bound + bwd_bound:.4f} ms")
        print(f"cond_gates B={b_tr} N={n_tr}: kernel {gemm_ms:.4f} ms on the "
              f"{tk.cond_gates_plan(0)[0]} plan (plans: "
              + ", ".join(f"{k_} {v:.4f} ms" for k_, v in plans_ms.items())
              + f"; graph replay; "
              f"{gates_wrap:.4f} ms through the wrapper), plain {gates_plain:.4f} ms, "
              f"library (graphed cuBLAS baddbmm) {lib_gates:.4f} ms, bound "
              f"{gates_bound:.4f} ms ({gates_by})")
        for name, ms, wrap, plain, lib, bound, by in (
                ("seq_fwd", fwd_ms, fwd_wrap, fwd_plain, lib_fwd, fwd_bound, fwd_by),
                ("seq_bwd", bwd_ms, bwd_wrap, bwd_plain, lib_bwd, bwd_bound, bwd_by)):
            lib_what = "its autograd backward" if name == "seq_bwd" else "forward"
            print(f"{name} B={b_tr} N={n_tr}: kernel {ms:.4f} ms (graph replay; "
                  f"{wrap:.4f} ms through the wrapper), plain {plain:.4f} ms, "
                  f"library (graphed frame_fwd loop, {lib_what}) {lib:.4f} ms, "
                  f"bound {bound:.4f} ms ({by})")
        # their max_abs_err (and the gates' rms_from_float64) come from step 8,
        # which runs beside step 19
        train_records = {
            "seq_fwd": dict(
                name="seq_fwd", route="cuda", source="lets_face_it_tpu_torch/csrc/seq_fwd.cu",
                replaces="lets_face_it_tpu/ops/pallas_train.py:182",
                launches=train_launches["seq_fwd"], max_abs_err=None, ms=fwd_ms,
                gemm_ms=gemm_ms, serial_ms=serial_ms, serial_bound_ms=serial_bound,
                wrapper_ms=fwd_wrap, plain_ms=fwd_plain, bound_ms=fwd_bound,
                bound_by=fwd_by, library_ms=lib_fwd, batch=b_tr, frames=n_tr),
            "seq_bwd": dict(
                name="seq_bwd", route="cuda", source="lets_face_it_tpu_torch/csrc/seq_bwd.cu",
                replaces="lets_face_it_tpu/ops/pallas_train.py:330",
                launches=train_launches["seq_bwd"], max_abs_err=None, ms=bwd_ms,
                wrapper_ms=bwd_wrap, plain_ms=bwd_plain, bound_ms=bwd_bound,
                bound_by=bwd_by, library_ms=lib_bwd, batch=b_tr, frames=n_tr),
            "cond_gates": dict(
                name="cond_gates", route="cuda",
                source="lets_face_it_tpu_torch/csrc/cond_gates.cu",
                replaces="lets_face_it_tpu/ops/pallas_train.py:241",
                launches=train_launches["cond_gates"], max_abs_err=None,
                plan=tk.cond_gates_plan(0)[0], plans_ms=plans_ms, rms_from_float64=None,
                ms=gemm_ms, wrapper_ms=gates_wrap, plain_ms=gates_plain,
                bound_ms=gates_bound, bound_by=gates_by, library_ms=lib_gates,
                batch=b_tr, frames=n_tr)}
        records.extend(train_records.values())
        print(json.dumps(trace_window(
            f"train_step_b{b_tr}", lambda: train_state.train_step(spec, hp, state, jb),
            3)))

        lap("11")

        # -- 12. sequence_invert ---------------------------------------------
        t_inv = hp.Validation["seq_len"]
        n_inv = t_inv - spec.cond.longest_history
        start = spec.cond.longest_history
        print(f"sequence_invert tolerance: kernel route vs plain route and the "
              f"reconstruction vs the encoded frames allclose(atol={ATOL}, "
              f"rtol={RTOL}); invertibility error vs its closed form rtol "
              f"{INVERT_ERR_RTOL}")
        invert_summary, invert_launches = [], None
        for seed in INVERT_SEEDS:
            model_i = (model_gpu if seed == SEED
                       else seeded_random_model(spec, seed).to(dev))
            g_i = torch.Generator(device=dev).manual_seed(seed)
            data_i = {k: torch.randn((INVERT_BATCH, t_inv, d), generator=g_i, device=dev)
                      for k, d in (("p1_face", c), ("p2_face", c),
                                   ("p1_speech", hp.Data["speech_dim"]),
                                   ("p2_speech", hp.Data["speech_dim"]))}
            with torch.no_grad():
                z_i, loss_i, _ = seqglow.sequence_nll(spec, model_i, data_i)
            torch.cuda.synchronize()
            reset_launches()
            x_k, back_k = seqglow.sequence_invert(spec, model_i, z_i, data_i,
                                                  route="kernel")
            torch.cuda.synchronize()
            counts = read_launches()
            if seed == SEED:
                invert_launches = counts
                invert_plans = read_plans()
                require_plan(f"sequence_invert B={INVERT_BATCH}", invert_plans,
                             "sample_gates", "tile")
            for name in ("frame_rev", "sample_gates", "sample_chain"):
                if counts[name] != n_inv:
                    fail(f"sequence_invert launched {name} {counts[name]} times, "
                         f"expected one a frame ({n_inv})")
            x_p, back_p = seqglow.sequence_invert(spec, model_i, z_i, data_i,
                                                  route="plain")
            torch.cuda.synchronize()
            e_x = check_close(f"sequence_invert seed {seed}: kernel vs plain route",
                              x_k, x_p)
            e_l = check_close(f"sequence_invert seed {seed}: backward loss", back_k,
                              back_p)
            e_r = check_close(f"sequence_invert seed {seed}: reconstruction vs "
                              "encoded frames", x_k, data_i["p1_face"][:, start:])
            err = (torch.abs((back_k + loss_i) / loss_i) * 100.0).item()
            logp = gaussian_logp(z_i.double()).mean().item()
            closed = abs(-2.0 * logp / math.log(2.0) / loss_i.item()) * 100.0
            err_rel = abs(err - closed) / closed
            if not math.isfinite(err) or err_rel > INVERT_ERR_RTOL:
                fail(f"invertibility error {err:.6f} % against its closed form "
                     f"{closed:.6f} %: relative {err_rel:.3e} > {INVERT_ERR_RTOL}")
            row = {"seed": seed, "batch": INVERT_BATCH, "frames": n_inv,
                   "max_abs_err_routes": e_x, "backward_loss_err": e_l,
                   "reconstruction_err": e_r, "forward_loss": loss_i.item(),
                   "backward_loss": back_k.item(), "error_percentage": err,
                   "closed_form_percentage": closed, "error_vs_closed_rel": err_rel}
            if seed == SEED:
                row["kernel_route_ms"] = time_ms(lambda: seqglow.sequence_invert(
                    spec, model_i, z_i, data_i, route="kernel"), reps=3, warmup=1)
                row["plain_route_ms"] = time_ms(lambda: seqglow.sequence_invert(
                    spec, model_i, z_i, data_i, route="plain"), reps=1, warmup=0)
            invert_summary.append(row)
            print(f"check sequence_invert seed {seed} B={INVERT_BATCH} N={n_inv}: "
                  f"routes max|d| {e_x:.3e}, backward loss |d| {e_l:.3e}, "
                  f"reconstruction max|d| {e_r:.3e}, invertibility error "
                  f"{err:.6f} % (closed form {closed:.6f} %, rel {err_rel:.3e}); "
                  f"launches {counts['frame_rev']} frame_rev  ok")
            del model_i, data_i, x_k, x_p
        print(f"sequence_invert B={INVERT_BATCH} N={n_inv} on {card}: kernel route "
              f"{invert_summary[0]['kernel_route_ms']:.3f} ms/call, plain route "
              f"{invert_summary[0]['plain_route_ms']:.3f} ms/call")
        data_i = {k: torch.randn((INVERT_BATCH, t_inv, d), generator=g, device=dev)
                  for k, d in (("p1_face", c), ("p2_face", c),
                               ("p1_speech", hp.Data["speech_dim"]),
                               ("p2_speech", hp.Data["speech_dim"]))}
        z_i = torch.randn((n_inv, INVERT_BATCH, c), generator=g, device=dev)
        print(json.dumps(trace_window(
            f"sequence_invert_b{INVERT_BATCH}", lambda: seqglow.sequence_invert(
                spec, model_gpu, z_i, data_i, route="kernel"), 3)))
        del data_i, z_i

        lap("12")

        # -- 13. run_test on the training checkpoint ---------------------------
        ckpt_t = CheckpointManager(ckpt_dir).latest()
        out_npz = Path(tmp) / "test_results.npz"
        printed = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            results = run_test_cli.main([
                "--ckpt", str(ckpt_t), "--out", str(out_npz), "--seq_len", str(t_inv),
                "--seed", str(SEED), "--synthetic-data", "--device", "cuda"])
        torch.cuda.synchronize()
        t_rt = time.perf_counter() - t0
        rt_launches = read_launches()
        rt_plans = read_plans()
        n_rt = len(results)
        print(f"run_test: {n_rt} batches in {t_rt:.3f} s (includes loading and "
              f"writing); launches {rt_launches}; gate plans {rt_plans}; printed:")
        require_plan("run_test (evaluation)", rt_plans, "sample_gates", "tile")
        require_plan("run_test (evaluation)", rt_plans, "cond_gates", tk.cond_gates_plan(0)[0])
        print("  " + printed.getvalue().strip().replace("\n", "\n  "))
        if "test_loss:" not in printed.getvalue():
            fail("run_test printed no summary")
        mods = [m for m in ("p2_face", "p2_speech", "p1_speech")
                if hp.Conditioning[m]["history"] > 0]
        want_keys = {f"batch{i}/{k}" for i in range(n_rt) for k in
                     ["test_loss", "test_losses", "predicted_prop_seq", "gt_seq"]
                     + [f"{p}_{m}{q}" for m in mods for p, q in
                        (("nll_mismatched", ""), ("losses_mismatched", ""),
                         ("predicted_mismatch", "_seq"))]}
        npz = np.load(out_npz)
        if set(npz.files) != want_keys:
            fail(f"run_test .npz keys {sorted(set(npz.files) ^ want_keys)} differ "
                 "from the JAX package's naming")
        for name in npz.files:
            if not np.isfinite(npz[name]).all():
                fail(f"run_test: non-finite {name}")
        per_batch = {k: rt_launches[k] / n_rt for k in ("cond_gates", "seq_fwd", "seq_rev")}
        want_per_batch = 1 + len(mods)
        if any(v != want_per_batch for v in per_batch.values()):
            fail(f"run_test launches per batch {per_batch}, expected {want_per_batch}")
        require_launches("run_test", rt_launches,
                         ("cond_gates", "seq_fwd", "seq_rev", "sample_gates",
                          "sample_chain"))
        gen_rt = Generator.from_checkpoint(ckpt_t, dataset_root=tmp, device="cuda")
        gen_rt.hp.Test = {"seq_len": t_inv}
        ds_rt = evaluation.load_test_split(gen_rt.hp, train_loop.synthetic_corpus(
            gen_rt.hp, SEED))
        batch_rt = train_loop.to_device(
            next(ds_rt.epoch_batches(gen_rt.hp.batch_size, shuffle=False)), dev)
        b_rt = int(batch_rt["p1_face"].shape[0])
        # the batch's outputs against the plain routes on the same inputs and
        # draws: losses at the training forward limit, generations as whole
        # sequences (first SEQ_TIGHT frames at the one-frame limit)
        draws_rt = evaluation.draw_eval(spec, gen_rt.hp, b_rt,
                                        torch.Generator().manual_seed(SEED))
        got_rt = evaluation.evaluate_batch(spec, gen_rt.model, gen_rt.hp, batch_rt,
                                           draws=draws_rt)
        with plain_paths(seqglow):
            reset_launches()
            ref_rt = evaluation.evaluate_batch(spec, gen_rt.model, gen_rt.hp,
                                               batch_rt, draws=draws_rt)
            torch.cuda.synchronize()
            if any(read_launches().values()):
                fail(f"evaluate_batch on the plain routes launched {read_launches()}")
        if set(got_rt) != set(ref_rt):
            fail(f"evaluate_batch keys {sorted(got_rt)} vs plain {sorted(ref_rt)}")
        rt_errs = {}
        for key in sorted(got_rt):
            a, r = torch.as_tensor(got_rt[key]), torch.as_tensor(ref_rt[key])
            what = f"evaluate_batch B={b_rt} N={n_inv} {key} vs plain routes"
            if key == "gt_seq":
                rt_errs[key] = check_close(what, a, r, atol=0.0, rtol=0.0)
            elif a.dim() == 3:   # [B, N, C] generations
                e_t = check_close(f"{what}, first {SEQ_TIGHT} frames",
                                  a[:, :SEQ_TIGHT], r[:, :SEQ_TIGHT])
                e_a = check_close(what, a, r, atol=SEQ_LOOSE_ATOL, rtol=0.0)
                rt_errs[key] = {f"first{SEQ_TIGHT}": e_t, "all": e_a}
            else:                # losses: scalars and [N, B]
                rt_errs[key] = check_close(what, a, r, atol=TRAIN_VAL_ATOL,
                                           rtol=TRAIN_VAL_RTOL)
        print(f"check evaluate_batch B={b_rt} N={n_inv} against the plain routes "
              f"(same inputs and draws; losses atol {TRAIN_VAL_ATOL} rtol "
              f"{TRAIN_VAL_RTOL}, generations first {SEQ_TIGHT} frames atol {ATOL} "
              f"rtol {RTOL}, all |diff| <= {SEQ_LOOSE_ATOL}): "
              f"{json.dumps(rt_errs)}  ok")
        del got_rt, ref_rt
        g_rt = torch.Generator().manual_seed(SEED)
        rt_ms = time_ms(lambda: evaluation.evaluate_batch(
            spec, gen_rt.model, gen_rt.hp, batch_rt, generator=g_rt), reps=2, warmup=1)
        print(json.dumps(trace_window(
            f"evaluate_batch_b{b_rt}",
            lambda: evaluation.evaluate_batch(spec, gen_rt.model, gen_rt.hp, batch_rt,
                                              generator=g_rt), 1)))
        rt_summary = {"batches": n_rt, "batch": b_rt, "frames": n_inv,
                      "max_abs_err_vs_plain": rt_errs, "launches_per_batch": per_batch,
                      "ms_per_batch": rt_ms, "wall_s": t_rt,
                      "summary": evaluation.summarize(results)}
        print(f"check run_test: {len(npz.files)} .npz keys as the JAX package names "
              f"them, all finite; per batch {per_batch}; evaluate_batch B="
              f"{rt_summary['batch']} {rt_ms:.3f} ms/batch on {card}  ok")

        lap("13")

        # -- 14. the trainer with the device data cache off and on -------------
        hp_c = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
        hp_c.Validation = dict(hp_c.Validation, check_invertion=True,
                               scale_logging=True)
        # one validation, at the end; the epochs cycle the larger corpus
        hp_c.max_epochs, hp_c.check_val_every_n_epoch = 1000, 1000
        corpus_c = train_loop.synthetic_corpus(hp_c, SEED, n_train_chunks=LOOP_CHUNKS)
        train_ds_c, val_ds_c = train_loop.load_datasets(hp_c, corpus_c)
        hp_c.device_data_cache = "on"
        batcher = device_cache.make_device_batcher(train_ds_c, hp_c, dev)
        sels = list(train_ds_c.epoch_index_batches(
            b_tr, rng=np.random.default_rng([SEED, 0]), shuffle=True, drop_last=True))
        on_path = train_loop.batch_transfer(train_ds_c, dev, batcher)
        off_path = train_loop.batch_transfer(train_ds_c, dev)
        for sel in sels:
            got_on, got_off = receive(on_path(sel)), receive(off_path(sel))
            host = train_ds_c.get_batch(sel)
            for k, v in host.items():
                if not (torch.equal(got_on[k].cpu(), torch.from_numpy(v))
                        and torch.equal(got_off[k].cpu(), torch.from_numpy(v))):
                    fail(f"device data cache: batch {k} differs from the host gather")
        budget = device_cache.auto_budget_bytes(dev)
        total_mem = torch.cuda.get_device_properties(dev).total_memory
        print(f"check device data cache: {len(sels)} batches of B={b_tr} gathered on "
              "the card and on the host (pinned, side stream) equal get_batch bit "
              f"for bit  ok; train split {batcher.total_bytes / 1e6:.3f} MB; auto "
              f"budget {budget / 1e9:.3f} GB of {total_mem / 1e9:.3f} GB")
        del batcher, on_path, off_path
        loop_runs = []
        for mode in CACHE_RUNS:
            hp_c.device_data_cache = mode
            trace, vals = LoopTrace(LOOP_WARM, LOOP_WINDOW), []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            reset_launches()
            t0 = time.perf_counter()
            state_c, _ = train_loop.train(
                hp_c, seed=SEED, max_steps=trace.max_steps, device="cuda",
                corpus=corpus_c, verbose=False, step_hook=trace,
                val_hook=lambda s, m: vals.append(m))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            require_launches(f"train (device_data_cache={mode})", counts,
                             ("cond_gates", "seq_fwd", "seq_bwd", "seq_rev",
                              "frame_rev", "sample_gates", "sample_chain"))
            if len(trace.metrics) != trace.max_steps or len(vals) != 1:
                fail(f"cache {mode}: {len(trace.metrics)} steps, {len(vals)} "
                     "validations")
            val = vals[0]
            if not (math.isfinite(val.get("reconstruction/error_percentage", math.nan))
                    and all(math.isfinite(v) for v in val.values())):
                fail(f"cache {mode}: validation {val}")
            window = trace.summary(f"train_loop_cache_{mode}")
            loop_ms = window["untraced_wall_ms_per_step"]
            loop_runs.append({
                "device_data_cache": mode, "wall_s": wall, "steps": trace.max_steps,
                "loop_ms_per_step": loop_ms, "loop_steps_per_s": 1e3 / loop_ms,
                "loop_windows_per_s": b_tr * 1e3 / loop_ms, "trace": window,
                "nll": [float(m["nll"]) for m in trace.metrics],
                "run_peak_bytes": torch.cuda.max_memory_allocated(dev) - held,
                "held_before_bytes": held, "launches": counts, "validation": val})
            print(f"train device_data_cache={mode}: {trace.max_steps} steps + "
                  f"validation in {wall:.3f} s; loop steps {LOOP_WARM + 1}-"
                  f"{LOOP_WARM + LOOP_WINDOW} {loop_ms:.3f} ms/step = "
                  f"{1e3 / loop_ms:.3f} steps/s, {b_tr * 1e3 / loop_ms:.1f} windows/s; "
                  f"traced steps {LOOP_WARM + LOOP_WINDOW + 1}-{trace.max_steps} "
                  f"{window['wall_ms_per_call']:.3f} ms/step wall, "
                  f"{window['device_ms_per_call']:.3f} ms/step on the card, idle "
                  f"share {window['idle_share']:.3f}; the run's peak device memory "
                  f"above the {held / 1e9:.3f} GB held before it "
                  f"{loop_runs[-1]['run_peak_bytes'] / 1e9:.3f} GB; launches {counts}")
        nll_off, nll_on = loop_runs[0]["nll"], loop_runs[1]["nll"]
        for i, (a, b) in enumerate(zip(nll_on, nll_off)):
            rtol = CPU_NLL_RTOL1 if i == 0 else CPU_NLL_RTOL
            if abs(a - b) > rtol * abs(b):
                fail(f"cache on vs off, step {i + 1}: nll {a} vs {b} (rtol {rtol})")

        class HistogramRecorder(train_loop.MetricLogger):
            def __init__(self):
                super().__init__(enabled=False)
                self.hists, self.logged = {}, []

            def histogram(self, step, name, values):
                self.hists[name] = np.asarray(values)

            def scalars(self, step, values):
                self.logged.append(values)

        # the validation's scale logging, on the model the last run trained
        recorder = HistogramRecorder()
        val_rec = train_loop.run_validation(
            spec, hp_c, state_c.model, val_ds_c, dev, state_c.step, SEED,
            logger=recorder)
        want_hists = train_loop.scale_histograms(state_c.model)
        if (set(recorder.hists) != set(want_hists)
                or not all(np.array_equal(recorder.hists[k], v)
                           and np.isfinite(v).all() for k, v in want_hists.items())
                or recorder.logged != [val_rec]):
            fail(f"validation's scale logging: histograms {sorted(recorder.hists)}, "
                 f"logged {len(recorder.logged)} metric sets")
        print(f"check cache on vs off: nll of {len(nll_on)} steps equal bits: "
              f"{nll_on == nll_off}; validation with check_invertion and "
              "scale_logging: error "
              f"{val_rec['reconstruction/error_percentage']:.6f} %, histograms "
              f"{ {k: int(v.size) for k, v in recorder.hists.items()} } logged, "
              "finite  ok")
        print(json.dumps({"slice5": {"invert": invert_summary, "run_test": rt_summary,
                                     "loop": loop_runs, "train_step_ms": t_step,
                                     "auto_budget_bytes": budget,
                                     "total_memory": total_mem}}))

        lap("14")

        # -- 15. the render service and the study-stimulus path ----------------
        checked = render_checks(gen, tmp, dev)
        render_launches = checked["launches"]
        require_launches("render_segment", render_launches,
                         ("seq_rev", "sample_gates", "sample_chain"))
        if render_launches["seq_rev"] != 1:
            fail(f"render_segment launched seq_rev {render_launches['seq_rev']} "
                 "times, expected one a segment")
        readings = checked["readings"]
        print(f"render_segment: one segment of {readings['segment_frames']} generated "
              f"frames on {card} in {readings['segment_wall_s']:.3f} s (generation and "
              f"the FLAME decoder on the card; the mp4 write swapped out); launches "
              f"{render_launches}; raster stage {readings['raster_ms_per_frame']:.1f} ms "
              f"a 2048x1024 frame on the host ({RENDER_FRAMES} frames, the heads "
              f"covering {readings['coverage']:.4f} of a frame); peak device memory "
              f"of the N={RENDER_LONG} get_vertices call "
              f"{readings['long_call_peak_bytes'] / 1e9:.3f} GB above what was held")
        print(json.dumps({"render": {**readings, **render_times(checked, card)}}))
        del checked

        lap("15")

        # -- 16. the extraction path, then training on what it wrote ----------
        t16 = time.perf_counter()
        extract = {"audio": extract_audio_checks(dev, card)}
        fits = extract_fit_checks(dev, card)
        extract["cli"] = extract_cli_checks(tmp, dev, card, fits.pop("head"),
                                            fits.pop("emb"), frames)
        extract.update(fits)
        extract["step_s"] = time.perf_counter() - t16
        print(json.dumps({"extract": extract}))
        print(f"step 16 (extraction, CLI, training on its corpus): "
              f"{extract['step_s']:.1f} s on {card}")

        lap("16")

        # -- 17. the precision modes, k steps a dispatch, the wire, the profiler
        modes = precision_step(tmp, dev, card, records)
        print(json.dumps({"precision": {k: v for k, v in modes.items()
                                        if k != "launches"}}))
        print(f"step 17 (precision modes, k-step graph, bf16 wire, profiler): "
              f"{modes['step_s']:.1f} s on {card}")

        lap("17")

        # -- 18. the kernels at the widened specs -----------------------------
        wide = widened_step(tmp, dev, card, records)
        print(json.dumps({"widened": wide}))
        print(f"step 18 (widened kernels): {wide['step_s']:.1f} s on {card}")

        lap("18")

        # -- 22. the Table-1 path; its checks against the plain route later ----
        table1, table1_done = table1_step(dev, card)
        lap("22")

        # -- 23's two runs start here and go on beside 19, 8 and 22's checks --
        resume_runs = start_resume_runs(tmp)

        # -- 19. tuning, in a thread beside 8 -------------------------------------
        try:
            tuning_done = in_thread(tuning_step, tmp, dev, card)
            # -- 8. the training kernels' checks (no timings), beside 19 and 23
            gates_err, fwd_err, bwd_err, gates_rms = training_kernel_checks()
            lap("8")
            table1_done()
            print(json.dumps({"table1": table1}))
            lap("22 checks")
            # -- 23. kill and resume: the runs started before 19 ----------------
            resumed = resume_step(tmp, card, resume_runs)
            print(json.dumps({"resume": resumed}))
            lap("23")
            # -- 20's ranks start once 23's runs have handed back the card's
            # memory, beside 19's last trials
            ddp_runs = ddp_start(tmp, dev)
            tuning = tuning_done()
        except BaseException:
            stop_resume_runs(resume_runs)
            raise
        for name, err in (("seq_fwd", fwd_err), ("seq_bwd", bwd_err),
                          ("cond_gates", gates_err)):
            train_records[name]["max_abs_err"] = err[SEED]
        train_records["cond_gates"]["rms_from_float64"] = gates_rms[SEED]
        print(json.dumps({"tuning": tuning}))
        print(f"step 19 (tuning, {TUNE_TRIALS} trials): {tuning['step_s']:.1f} s "
              f"on {card}")

        lap("19")

        # -- 20. data parallelism: its ranks' check ------------------------------
        ddp = ddp_finish(ddp_runs, dev, card)
        print(json.dumps({"ddp": ddp}))
        print(f"step 20 (data parallel): {ddp['step_s']:.1f} s on {card}")

        lap("20")

        # -- 21. the benchmark --------------------------------------------------
        benched = bench_step(dev, card)
        print(json.dumps({"bench": benched}))

        lap("21")

        # -- 24. the JAX start replayed ---------------------------------------
        replayed = replay_step(dev, card)
        print(json.dumps({"replay": replayed}))
        lap("24")

        paths = {"serving": launches, "training": train_launches,
                 "invert": invert_launches, "run_test": rt_launches,
                 "train_cache_off": loop_runs[0]["launches"],
                 "train_cache_on": loop_runs[1]["launches"],
                 "render": render_launches,
                 "extract_train": extract["cli"]["train"]["launches"],
                 **{f"tune_trial_{t['number']}": t["launches"] or {}
                    for t in tuning["trials"]},
                 **{f"ddp_{k}": v["launches"] for k, v in ddp.items()
                    if k.startswith("world")},
                 "bench": benched["launches"], "table1": table1["launches"],
                 "resume": resumed["launches"], "replay": replayed["launches"]}
        for rec in records:
            if "widened" in rec:
                by_path = {f"widened {rec['widened']}":
                           wide[rec["widened"]]["launches"]}
            elif "precision" in rec:
                by_path = {f"path_{rec['precision']}": modes["launches"][rec["precision"]],
                           **({"ab_both_arms": modes["launches"]["ab"]}
                              if rec["precision"] == "medium" else {})}
            else:
                by_path = paths
            rec["launches_by_path"] = {p: cnt[rec["name"]] for p, cnt in by_path.items()
                                       if rec["name"] in cnt}
            if rec["name"] in ("cond_gates", "sample_gates") and "widened" not in rec:
                plan_paths = {"serving": serving_plans, "sequence_sample_b128": seq_plans,
                              "training": train_plans, "invert": invert_plans,
                              "run_test": rt_plans, "bench": benched["plans"],
                              **{f"path_{p}": v
                                 for p, v in modes["plans"].items()}}
                rec["plans_by_path"] = {p: v[rec["name"]] for p, v in plan_paths.items()}

    print(json.dumps({"step_wall_s": STEP_WALL}))
    print(f"total: {time.perf_counter() - t_all:.1f} s "
          f"({time.perf_counter() - T_START:.1f} s since the script's imports)")
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
