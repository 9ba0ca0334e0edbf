"""Input pipeline: the native window gather, background prefetch, and the
hand-over of batches staged on a side CUDA stream (the port of
``lets_face_it_tpu/data/prefetch.py``).

``NativeGather`` binds ``native/window_loader.cpp`` (OpenMP parallel window
copies, built by ``utils/native.py``); where it cannot be built, a numpy
gather takes its place and says so once. ``prefetch_batches`` runs any batch
iterator in a daemon thread with a bounded queue, so that host-side batch
assembly and the upload overlap the training step (the role of the
reference's 8 DataLoader worker processes, mimicry_data_module.py:101-108).

Streams: a ``SideStreamTransfer`` runs its function in the worker thread on a
CUDA stream of its own and records an event after it; ``receive``, in the
consumer thread, makes the consumer's current stream wait on that event and
marks every tensor as used by that stream (``record_stream``), so that the
step never reads a batch still being written and the allocator never hands
the batch's memory to the next transfer while the step still reads it.
"""

from __future__ import annotations

import ctypes
import queue
import sys
import threading
from typing import Iterator

import numpy as np
import torch


class NativeGather:
    _lib = None
    _tried = False
    _warned = False

    @classmethod
    def available(cls) -> bool:
        if not cls._tried:
            cls._tried = True
            try:
                from lets_face_it_tpu_torch.utils.native import load_library

                lib = load_library("window_loader")
                lib.gather_windows.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
                lib.gather_windows.restype = None
                cls._lib = lib
            except Exception as exc:
                cls._lib = None
                print(f"NativeGather: native/window_loader.cpp unavailable "
                      f"({str(exc).splitlines()[0]}); gathering windows with "
                      "numpy", file=sys.stderr, flush=True)
                cls._warned = True
        return cls._lib is not None

    @classmethod
    def gather(cls, src: np.ndarray, starts: np.ndarray, seq_len: int,
               out: np.ndarray | None = None) -> np.ndarray:
        """src [T, D] float32, starts [B] -> [B, seq_len, D] (into ``out``
        when given)."""
        n, d = len(starts), src.shape[1]
        if out is None:
            out = np.empty((n, seq_len, d), np.float32)
        if cls.available() and src.dtype == np.float32 and src.flags["C_CONTIGUOUS"]:
            starts64 = np.ascontiguousarray(starts, np.int64)
            cls._lib.gather_windows(
                src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), d,
                starts64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, seq_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return out
        if not cls._warned:
            cls._warned = True
            print("NativeGather: gathering windows with numpy", file=sys.stderr,
                  flush=True)
        idx = np.asarray(starts)[:, None] + np.arange(seq_len)[None, :]
        out[:] = src[idx]
        return out


def gather_host(ds, indices, *, pin_memory: bool = False) -> dict:
    """The windows ``ds.window_starts[indices]`` of every modality as CPU
    float32 tensors [B, T, D], gathered by ``NativeGather`` straight into
    (optionally page-locked) tensor memory. Values equal ``ds.get_batch``."""
    starts = ds.window_starts[np.asarray(indices)]
    out = {}
    for name, arr in ds.arrays.items():
        buf = torch.empty((len(starts), ds.seq_len, arr.shape[1]),
                          dtype=torch.float32, pin_memory=pin_memory)
        NativeGather.gather(arr, starts, ds.seq_len, out=buf.numpy())
        out[name] = buf
    return out


class SideStreamTransfer:
    """``fn(item) -> {name: tensor}`` run on a side stream of ``device``.

    Called in the producer thread, it returns (batch, event); ``receive``
    takes that pair in the consumer thread. On the CPU, ``fn`` runs as it is
    and the event is None."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, item):
        if self.stream is None:
            return self.fn(item), None
        with torch.cuda.stream(self.stream):
            batch = self.fn(item)
            event = torch.cuda.Event()
            event.record(self.stream)
        return batch, event


def receive(staged) -> dict:
    """The batch of a (batch, event) pair, safe to use on the current stream."""
    batch, event = staged
    if event is not None:
        stream = torch.cuda.current_stream(next(iter(batch.values())).device)
        stream.wait_event(event)
        for t in batch.values():
            t.record_stream(stream)
    return batch


def prefetch_batches(iterator: Iterator, depth: int = 2,
                     transfer=None) -> Iterator:
    """Run ``iterator`` in a daemon thread; yield from a bounded queue.

    ``transfer`` (optional) is applied to each item inside the worker thread
    (the gather and the upload, so that they overlap the step). Errors in
    the worker are raised in the consumer; a consumer that stops early (a
    ``max_steps`` break) releases the worker and drops what it queued.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item if transfer is None else transfer(item)):
                    return
        except BaseException as exc:  # propagate into the consumer
            err.append(exc)
        finally:
            _put(_END)

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        def drain():
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

        stop.set()
        drain()          # unblock a put the worker entered before stop.set()
        t.join(timeout=5)
        drain()          # clear what that put deposited
