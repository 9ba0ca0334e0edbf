"""Timing helpers for the card (the port of
``lets_face_it_tpu/utils/timing.py``).

Work on a CUDA device runs asynchronously to the host: a call returns once
its kernels are queued. A host-clock measurement must therefore end in a
``torch.cuda.synchronize()`` (``hard_sync``), and a kernel's own time is best
read from CUDA events recorded on its stream around it (``cuda_time_ms``),
which leave out the host's launch costs when the calls are replays of a CUDA
graph (``graphed``). ``diff_time`` keeps the JAX package's N-against-2N
difference, which cancels any fixed cost of the final sync. The benchmark
(``bench.py``), ``chip_smoke.py`` and the kernel probes all time through
this module.
"""

from __future__ import annotations

import time

import torch


def _first_tensor(x):
    """The first tensor leaf of ``x`` (nested dicts, lists and tuples), or
    None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def hard_sync(x) -> None:
    """Wait until the device of the first tensor leaf of ``x`` has run all
    the work queued on it; nothing on the CPU (or without a tensor)."""
    leaf = _first_tensor(x)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def diff_time(run_n, iters: int) -> float:
    """Seconds per iteration by the N-vs-2N difference method.

    ``run_n(n)`` must execute ``n`` chained iterations and hard-sync on the
    last output (fixed sync/queue-lag costs cancel in the difference).
    """
    t0 = time.perf_counter()
    run_n(iters)
    t_short = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_n(2 * iters)
    t_long = time.perf_counter() - t0
    return max(t_long - t_short, 1e-9) / iters


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` by CUDA events on the current stream around
    ``reps`` calls, after ``warmup`` calls and a synchronize. Raises where
    there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device; "
                           "torch.cuda.is_available() is False")
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


def graphed(fn, warmup: int = 2):
    """``fn`` captured once in a CUDA graph, after ``warmup`` calls on a side
    stream (the warm-up a capture needs); returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay
