#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path and its training path of
``hparams/final_model.yaml`` at full width on seeded random weights, from
the sources in this checkout:

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels (``lets_face_it_tpu_torch/csrc``) with nvcc
   and prints each one's registers and spills;
3. holds each sampling kernel against its plain PyTorch version on the card:
   ``frame_rev`` and ``seq_rev`` as their wrappers run them, and the two
   kernels each frame of them runs, ``sample_gates`` and ``sample_chain``,
   alone, at the main paths' batches and at odd ones (partial tiles and
   clusters), with and without the own-face history;
4. saves the weights in the reference's names, loads them through
   ``Generator.from_checkpoint``, generates a sequence and streams frames
   (``StreamingGenerator``), and checks the outputs against the plain path on
   the CPU with the same latents;
5. checks that each sampling kernel's launch counter rose during step 4
   (``sample_gates`` and ``sample_chain`` count the launches that
   ``frame_rev`` and ``seq_rev`` make of them);
6. times the serving path and each sampling kernel beside its plain version,
   a library yardstick and its bound;
7. traces a push at B=1 and B=64 and a generate at B=1 with
   ``torch.profiler``: device time, device idle share and the largest device
   operations of each call;
8. holds the training kernels against their plain versions at B=256, N=56
   (the conditioning gates ``cond_gates``, the forward's outputs, and the
   backward's outputs on seeded cotangents), and the autograd Function's
   gradients against eager autograd through the ``flow.frame_fwd`` loop, on
   two weight seeds;
9. trains ``final_model`` at B=256 for 3 steps and one validation on the
   synthetic corpus (``train.loop.train``), checks that ``cond_gates``,
   ``seq_fwd``, ``seq_bwd`` and ``seq_rev`` were launched, that loss and gradient norm
   are finite, and that the checkpoint loads through
   ``Generator.from_checkpoint`` and generates;
10. holds 2 training steps at B=32 against the same steps on the CPU plain
    path (same weights, batch and draws);
11. times the training step and each training kernel beside its plain
    version, a library yardstick and its bound (``seq_fwd`` as the whole
    route and as its two launches, ``cond_gates`` beside one cuBLAS call for
    the same product), and traces a training step with ``torch.profiler``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
It needs no network, imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
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
# Calls per traced window of step 7.
PROFILE_CALLS = 20
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
# Step 10: the GPU's steps against the CPU plain path's at B=32. The first
# step starts from the same weights (NLL rtol 1e-5, the JAX trajectory
# test's); Adam moves every entry by about the learning rate (1e-5) per step
# whatever its gradient's size, so an entry whose gradient is at rounding
# level may move the other way on the other path: the second step's NLL is
# held at rtol 1e-4 and the weights at two steps' moves in opposite
# directions (4e-5). Measured on an H100: 1.542e-05.
CPU_STEPS, CPU_BATCH = 2, 32
CPU_NLL_RTOL1, CPU_NLL_RTOL, CPU_PARAM_ATOL = 1e-5, 1e-4, 4e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check_close(name, got, ref, atol=ATOL, rtol=RTOL):
    import torch

    got, ref = got.double().cpu(), ref.double().cpu()
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


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def drift(got, ref) -> dict:
    """Largest |got - ref| of frame 0, of the first SEQ_TIGHT frames and of
    all frames of [N, B, C] sequences."""
    d = (got.double() - ref.double()).abs().amax(dim=(1, 2))
    return {"frame0": d[0].item(), f"first{SEQ_TIGHT}": d[:SEQ_TIGHT].max().item(),
            "all": d.max().item()}


def trace_window(name: str, fn, calls: int) -> dict:
    """Host wall time per call of ``calls`` synchronised calls of ``fn`` (no
    profiler: its own cost per operation is large), then as many again under
    ``torch.profiler``: device time per call (device kernels and copies), the
    device's idle share (1 - device / wall), device operations per call and
    the five largest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        if evt.device_type != DeviceType.CUDA:
            return 0.0   # the host operator reports its kernels' time again
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))

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
    on_device = [e for e in prof.key_averages() if device_us(e) > 0]
    if not on_device:
        fail(f"profile {name}: the trace shows no device time")
    device_ms = sum(device_us(e) for e in on_device) / 1e3 / calls
    top = sorted(on_device, key=device_us, reverse=True)[:5]
    return {
        "window": name, "calls": calls, "wall_ms_per_call": wall_ms,
        "device_ms_per_call": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
        "device_ops_per_call": sum(e.count for e in on_device) / calls,
        "top": [{"op": e.key[:60], "ms_per_call": device_us(e) / 1e3 / calls,
                 "count_per_call": e.count / calls} for e in top],
    }


def graphed(fn):
    """``fn`` captured once in a CUDA graph; returns the replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


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


def _weight_floats(weights) -> int:
    """Floats of the flow's sampling weights, each once: ``chain`` is a
    re-laid copy of some of the others (``flow_kernels.chain_weights``)."""
    return sum(t.numel() for n, t in weights._asdict().items() if n != "chain")


def frame_bound_ms(spec, weights, b: int):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    w_bytes = _weight_floats(weights) * 4
    io = 4 * (b * c + k * b * spec.cond.cond_dim + k * b * h      # inputs
              + b * c + k * b * h)                                 # outputs
    flops = b * k * _row_step_flops(spec)
    t_bytes, t_ops = (w_bytes + io) / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def seq_bound_ms(spec, weights, n: int, b: int):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    p1, cond = spec.cond.p1_face.out_dim, spec.cond.cond_dim
    w_bytes = (_weight_floats(weights) + k * p1 * cond) * 4
    io = 4 * (n * b * c + n * k * b * cond + b * p1 + k * b * h   # inputs
              + n * b * c)                                         # output
    flops = n * b * k * (_row_step_flops(spec) + 2 * p1 * cond)
    t_bytes, t_ops = (w_bytes + io) / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gates_bound_ms(spec, b: int, p1: int):
    """One frame's gates: proj (P1 > 0), gc and gh for all K steps."""
    k, h, cond = spec.n_steps, spec.hidden_channels, spec.cond.cond_dim
    g = 3 * h
    w_floats = k * (p1 * cond + (cond + 1) * g + (h + 1) * g)
    io = k * b * cond + b * p1 + k * b * h + (k * b * cond if p1 else 0) + 2 * k * b * g
    flops = 2 * b * k * (p1 * cond + cond * g + h * g)
    return _bound(4 * (w_floats + io), flops)


def chain_bound_ms(spec, weights, b: int, p1: int):
    """One frame's serial chain: its resident weights read once, the gates
    and states in, x, the states and the history out."""
    k, c, z1, h = spec.n_steps, spec.channels, spec.z1_dim, spec.hidden_channels
    cout, g = spec.coupling_out_dim, 3 * spec.hidden_channels
    io = b * c + 2 * k * b * g + k * b * h + b * p1 + b * c + k * b * h + b * p1
    matmul = 2 * (z1 * g + h * cout + c * c)
    pointwise = 12 * h + 6 * (cout // 2) + 2 * c
    return _bound(4 * (weights.chain.numel() + io), b * k * (matmul + pointwise))


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


def _bound(n_bytes, flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def train_fwd_bound_ms(spec, tw, n: int, b: int):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    half, cond = spec.coupling_out_dim // 2, spec.cond.cond_dim
    w_bytes = sum(t.numel() for t in tw) * 4
    io = 4 * (n * b * c + n * k * b * cond + k * b * h                  # inputs
              + n * b * c + n * k * b * (half + c + h))                   # outputs
    return _bound(w_bytes + io, n * b * k * _row_step_flops(spec))


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


def train_bwd_bound_ms(spec, tw, n: int, b: int):
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    half, cond, cout = spec.coupling_out_dim // 2, spec.cond.cond_dim, spec.coupling_out_dim
    w_bytes = (sum(t.numel() for t in tw)
               + k * (c * c + 3 * h * h + 3 * h * spec.z1_dim + cout * h)) * 4
    io = 4 * (n * b * c + n * k * b * (half + c + h + cond) + k * b * h  # inputs
              + n * b * c + k * b * h + n * k * b * (3 * h + h + cout + c))  # outputs
    return _bound(w_bytes + io, n * b * k * _bwd_row_step_flops(spec))


def cond_gates_bound_ms(spec, n: int, b: int):
    """The conditioning gates of every frame and step: [N*B, cond] @
    [cond, 3H] per step, cond read, weights and bias read, gc written."""
    k, cond, g = spec.n_steps, spec.cond.cond_dim, 3 * spec.hidden_channels
    n_bytes = 4 * (n * k * b * cond + k * (cond + 1) * g + n * k * b * g)
    return _bound(n_bytes, 2 * n * b * k * cond * g)


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


def main() -> int:
    if not (REPO / "lets_face_it_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout: lets_face_it_tpu_torch/ is not beside "
             "this script")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a GPU")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.ops import cuda_build
    from lets_face_it_tpu_torch.model.encoders import (MODALITY_ORDER,
                                                       frame_dropout_mask)
    from lets_face_it_tpu_torch.ops import flow_kernels as fk
    from lets_face_it_tpu_torch.ops import train_kernels as tk
    from lets_face_it_tpu_torch.sample.generate import Generator
    from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator
    from lets_face_it_tpu_torch.sample.weights import (seeded_random_model,
                                                       state_dict_reference)
    from lets_face_it_tpu_torch.train import loop as train_loop
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
    t0 = time.perf_counter()
    paths = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(paths)} libraries")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

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
                    xs = fk.sequence_rev_fused(spec, w_s, w_p1_s, zs, fixed, hist0, st0)
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
                    spec, fk.SamplingWeights(*(t.double() for t in w_r)),
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
                    got = fk.sample_gates(spec, w, w_p1_b, projs, hist_b, st)
                    ref = fk.sample_gates_ref(spec, w, w_p1_b, projs, hist_b, st)
                    torch.cuda.synchronize()
                    e_g = max(check_close(f"sample_gates {label} B={b} {nm}", a_, r_)
                              for nm, a_, r_ in zip(("proj", "gc", "gh"), got, ref))
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
                      f"cond_projs): max|d| {frame_gates_err[b]:.3e} / "
                      f"{frame_chain_err[b]:.3e}  ok")
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

        fk.frame_rev_fused.launches = 0
        fk.sequence_rev_fused.launches = 0
        fk.sample_gates.launches = fk.sample_chain.launches = 0
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
        print(f"main path: {t_main:.3f} s (includes first-use costs); "
              f"launches {launches}")

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
                    rows_.append(row)
                    print(f"{name} B={b} ({'own face' if own else 'cond_projs given'}): "
                          f"kernel {row['ms']:.4f} ms (graph replay; "
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
            PROFILE_CALLS // 10)))

        # -- 8. training kernels against their plain versions; gradients --
        if seqglow.training_path(spec) != "kernels":
            fail("final_model is outside the training kernels' envelope")
        b_tr = hp.batch_size
        n_tr = hp.Train["seq_len"] - spec.cond.longest_history
        print(f"training tolerances: seq_fwd vs plain atol {TRAIN_VAL_ATOL} rtol "
              f"{TRAIN_VAL_RTOL}; seq_bwd vs plain atol {TRAIN_BWD_ATOL} rtol "
              f"{TRAIN_BWD_RTOL}; Function gradients vs eager autograd |diff| <= "
              f"{GRAD_ATOL} + {GRAD_LEAF_RTOL} * max|leaf| (sums over N*B rows "
              "in another order)")

        def train_inputs(b, n):
            return (torch.randn(n, b, c, generator=g, device=dev),
                    torch.randn(n, k_steps, b, cond, generator=g, device=dev),
                    0.3 * torch.randn(k_steps, b, h, generator=g, device=dev))

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

        gates_err, fwd_err, bwd_err, grad_ratio = {}, {}, {}, {}
        for seed in TRAIN_SEEDS:
            model_t = (model_gpu if seed == SEED
                       else seeded_random_model(spec, seed).to(dev))
            xs, cs, st0 = train_inputs(b_tr, n_tr)
            with torch.no_grad():
                tw = tk.prepare_train_weights(spec, model_t.flow)
                gates_err[seed] = check_close(
                    f"cond_gates seed {seed}", tk.cond_gates(spec, tw, cs),
                    tk.cond_gates_ref(spec, tw, cs), TRAIN_VAL_ATOL, TRAIN_VAL_RTOL)
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

        # -- 9. the training main path --------------------------------------
        corpus = train_loop.synthetic_corpus(hp, SEED, n_train_chunks=TRAIN_CHUNKS)
        ckpt_dir = Path(tmp) / "train_ckpt"
        step_log, val_log = [], []
        tk.cond_gates.launches = tk.seq_fwd.launches = tk.seq_bwd.launches = 0
        fk.sequence_rev_fused.launches = fk.frame_rev_fused.launches = 0
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
        print(f"training main path: {TRAIN_STEPS} steps at B={b_tr} and one "
              f"validation in {t_train:.3f} s (includes first-use costs); "
              f"launches {train_launches}")
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
            # the library GEMM: one cuBLAS call, on operands laid out for it
            lib_a = torch.nn.functional.leaky_relu(cs, 0.01).permute(1, 0, 2, 3).reshape(
                k_steps, -1, cond).contiguous()
            lib_w = tw.w_ih_t[:, spec.z1_dim:].contiguous()
            lib_b = tw.b_ih[:, None, :].contiguous()
            lib_gates = time_ms(graphed(lambda: torch.baddbmm(lib_b, lib_a, lib_w)), 3)
            del lib_a
            lib_fwd = time_ms(graphed(lambda: eager_flow_sequence(
                spec, flow_t, xs, cs, st0)), 3)
        # the library backward: the eager loop's autograd backward (inputs and
        # flow weights), timed as graphed forward + backward less the graphed
        # forward with autograd recording
        lib_in = [x.clone().requires_grad_() for x in (xs, cs, st0)]
        lib_w = [p for n, p in flow_t.named_parameters()
                 if p.requires_grad and not n.startswith("cond_proj")]

        def lib_forward():
            z, _, ns, sc = eager_flow_sequence(spec, flow_t, *lib_in)
            return z, sc, ns

        lib_bwd = (time_ms(graphed(lambda: torch.autograd.grad(
                       lib_forward(), lib_in + lib_w, cot)), 3)
                   - time_ms(graphed(lib_forward), 3))
        fwd_bound, fwd_by = train_fwd_bound_ms(spec, tw, n_tr, b_tr)
        bwd_bound, bwd_by = train_bwd_bound_ms(spec, tw, n_tr, b_tr)
        gates_bound, gates_by = cond_gates_bound_ms(spec, n_tr, b_tr)
        serial_bound, serial_by = train_serial_bound_ms(spec, n_tr, b_tr)
        print(f"seq_fwd B={b_tr} N={n_tr}: whole route {fwd_ms:.4f} ms = cond_gates "
              f"{gemm_ms:.4f} ms + serial kernel {serial_ms:.4f} ms (graph replay; "
              f"the serial kernel's bound {serial_bound:.4f} ms, {serial_by}); "
              f"pair fwd + bwd {fwd_ms + bwd_ms:.4f} ms against bounds "
              f"{fwd_bound + bwd_bound:.4f} ms")
        print(f"cond_gates B={b_tr} N={n_tr}: kernel {gemm_ms:.4f} ms (graph replay; "
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
        records.append(dict(
            name="seq_fwd", route="cuda", source="lets_face_it_tpu_torch/csrc/seq_fwd.cu",
            replaces="lets_face_it_tpu/ops/pallas_train.py:182",
            launches=train_launches["seq_fwd"], max_abs_err=fwd_err[SEED], ms=fwd_ms,
            gemm_ms=gemm_ms, serial_ms=serial_ms, serial_bound_ms=serial_bound,
            wrapper_ms=fwd_wrap, plain_ms=fwd_plain, bound_ms=fwd_bound,
            bound_by=fwd_by, library_ms=lib_fwd, batch=b_tr, frames=n_tr))
        records.append(dict(
            name="seq_bwd", route="cuda", source="lets_face_it_tpu_torch/csrc/seq_bwd.cu",
            replaces="lets_face_it_tpu/ops/pallas_train.py:330",
            launches=train_launches["seq_bwd"], max_abs_err=bwd_err[SEED], ms=bwd_ms,
            wrapper_ms=bwd_wrap, plain_ms=bwd_plain, bound_ms=bwd_bound,
            bound_by=bwd_by, library_ms=lib_bwd, batch=b_tr, frames=n_tr))
        records.append(dict(
            name="cond_gates", route="cuda",
            source="lets_face_it_tpu_torch/csrc/cond_gates.cu",
            replaces="lets_face_it_tpu/ops/pallas_train.py:241",
            launches=train_launches["cond_gates"], max_abs_err=gates_err[SEED],
            ms=gemm_ms, wrapper_ms=gates_wrap, plain_ms=gates_plain,
            bound_ms=gates_bound, bound_by=gates_by, library_ms=lib_gates,
            batch=b_tr, frames=n_tr))
        print(json.dumps(trace_window(
            f"train_step_b{b_tr}", lambda: train_state.train_step(spec, hp, state, jb),
            3)))

    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
