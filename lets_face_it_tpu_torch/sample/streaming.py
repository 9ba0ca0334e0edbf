"""Streaming duplex generation: a stateful stepper that emits one generated
face frame per call, for live-avatar serving (the port of
``lets_face_it_tpu/sample/streaming.py``).

The caller pushes the latest interlocutor-face/speech frames; the stepper
keeps the rolling history windows, the own-face history and the K
coupling-GRU states on the device. Each frame's flow inversion is one launch
of the per-frame kernel (``ops/flow_kernels.py::frame_rev_fused``) inside its
envelope, the plain ``flow.frame_rev`` outside it.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from lets_face_it_tpu_torch.model import encoders, flow
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import flow_kernels
from lets_face_it_tpu_torch.utils.device import resolve_device

_STREAMED = ("p2_face", "p1_speech", "p2_speech")


class StreamingGenerator:
    """Rolling device state for one (batched) live dyadic session.
    ``params`` is moved to ``device``."""

    def __init__(self, spec: FlowSpec, params: SeqGlow, *, batch_size: int = 1,
                 eps_std: float = 1.0, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec
        self.params = params.to(self.device).eval()
        self.eps_std = float(eps_std)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        # the float32 weights and their set rounded at each matmul precision
        # a push has run at, by mode
        self._weights = ({0: flow_kernels.prepare_sampling_weights(spec, params.flow)}
                         if flow_kernels.fused_supported(spec) else None)
        # the per-frame kernel's wrapper; a caller may wrap it to see what
        # each push hands the kernel (the benchmark checks pushes so)
        self.frame_kernel = flow_kernels.frame_rev_fused
        b, c, cond = batch_size, spec.channels, spec.cond

        def zeros(h, d):
            return torch.zeros(b, h, d, device=self.device)

        self.face_hist = zeros(max(cond.p1_face.history, 1), c)
        self.windows = {name: zeros(getattr(cond, name).history,
                                    getattr(cond, name).input_dim)
                        for name in _STREAMED if getattr(cond, name) is not None}
        self.states = flow.init_flow_states(spec, b, self.device)

    def _inputs(self, frames: dict, frame_axis: int | None):
        """Per-modality tensors on the device; checks that every conditioned
        modality is given and that all carry the same number of frames."""
        inputs, k = {}, None
        for name in self.windows:
            if frames.get(name) is None:
                raise ValueError(f"{name} is conditioned on; provide it")
            t = torch.as_tensor(frames[name], dtype=torch.float32,
                                device=self.device)
            if frame_axis is not None:
                if k is None:
                    k = t.shape[frame_axis]
                elif t.shape[frame_axis] != k:
                    raise ValueError(
                        f"{name} carries {t.shape[frame_axis]} frames but an "
                        f"earlier modality carries {k}")
            inputs[name] = t
        return inputs, k

    @torch.no_grad()
    def _step(self, inputs: dict, z=None):
        """One frame: roll the windows (the current interlocutor frame is
        visible, (t-h, t]), encode, invert the flow, roll the own face."""
        spec, params = self.spec, self.params
        for name, win in self.windows.items():
            self.windows[name] = torch.cat([win[:, 1:], inputs[name][:, None]],
                                           dim=1)
        parts = []
        if spec.cond.p1_face.out_dim > 0:
            parts.append(encoders.encode_p1_face_single(
                spec.cond, params.encoder, self.face_hist))
        for name, win in self.windows.items():
            parts.append(encoders.encode_windows(
                getattr(spec.cond, name), params.encoder[name], win[:, None])[:, 0])
        cond_t = torch.cat(parts, dim=-1)

        if z is None:
            z = torch.randn(self.face_hist[:, 0].shape, generator=self.rng,
                            device=self.device) * self.eps_std
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device).contiguous()
        if self._weights is not None:
            mode = flow_kernels.precision_mode()
            if mode not in self._weights:
                self._weights[mode] = flow_kernels.round_sampling_weights(
                    spec, self._weights[0], mode)
            proj = flow.project_cond(params.flow, cond_t).contiguous()
            x_t, self.states = self.frame_kernel(spec, self._weights[mode], z,
                                                 proj, self.states)
        else:
            x_t, _, self.states = flow.frame_rev(spec, params.flow, z, cond_t,
                                                 self.states)
        self.face_hist = torch.cat([self.face_hist[:, 1:], x_t[:, None]], dim=1)
        return x_t

    def push(self, p2_face=None, p1_speech=None, p2_speech=None, *, z=None):
        """Feed the current conversation frame ([B, D] per conditioned
        modality); returns the generated agent face frame [B, C]. ``z``
        [B, C] replaces the draw of ``randn * eps_std``."""
        inputs, _ = self._inputs({"p2_face": p2_face, "p1_speech": p1_speech,
                                  "p2_speech": p2_speech}, None)
        return self._step(inputs, z)

    def push_many(self, p2_face=None, p1_speech=None, p2_speech=None, *, z=None):
        """Feed k frames ([B, k, D] per modality); returns [B, k, C].
        Identical to k ``push`` calls (same random stream, same rolling
        state). ``z`` [B, k, C] replaces the draws."""
        inputs, k = self._inputs({"p2_face": p2_face, "p1_speech": p1_speech,
                                  "p2_speech": p2_speech}, 1)
        xs = [self._step({n: v[:, i] for n, v in inputs.items()},
                         None if z is None else z[:, i]) for i in range(k)]
        return torch.stack(xs, dim=1)

    def stage_session(self, frames) -> dict:
        """A session's conditioning stream (a list of n per-frame dicts
        ``{modality: [B, D]}``) as ``{modality: [n, B, D]}`` device tensors,
        one upload per modality."""
        return {name: torch.as_tensor(np.stack([np.asarray(f[name])
                                                for f in frames]),
                                      dtype=torch.float32, device=self.device)
                for name in self.windows}

    def push_staged(self, staged: dict, idx, k: int = 1, *, z=None):
        """Consume frames [idx, idx+k) of a staged stream; returns
        ``(frames [B, k, C], next_idx)``. ``idx`` may be a device int tensor
        (the cursor ``next_idx`` returned by the previous call), so the
        serving loop ships nothing to the device. ``z`` [B, k, C] replaces
        the draws."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        sel = idx + torch.arange(k, device=self.device)
        inputs = {n: a.index_select(0, sel) for n, a in staged.items()}
        xs = [self._step({n: v[i] for n, v in inputs.items()},
                         None if z is None else z[:, i]) for i in range(k)]
        return torch.stack(xs, dim=1), idx + k

    def catchup_sizes(self, max_catchup: int = 8):
        """The power-of-two dispatch sizes the paced session draws from."""
        sizes = [1]
        while sizes[-1] * 2 <= max_catchup:
            sizes.append(sizes[-1] * 2)
        return sizes

    def reset(self, seed_faces=None):
        """Start a new sequence: zero (or seed) the own-face history and reset
        the coupling-RNN states (models.py:535)."""
        b = self.face_hist.shape[0]
        if seed_faces is not None:
            self.face_hist = torch.as_tensor(seed_faces, dtype=torch.float32,
                                             device=self.device)
        else:
            self.face_hist = torch.zeros_like(self.face_hist)
        self.states = flow.init_flow_states(self.spec, b, self.device)


class SessionReport(NamedTuple):
    """What a depth-d jitter buffer experienced over one paced session."""

    frames: np.ndarray       # [B, n, C] generated output, playout order
    lateness_s: np.ndarray   # [n] completion wall time - frame arrival time
    underruns: int           # frames NOT ready at their depth-d playout slot
    min_depth: int           # smallest integer depth with zero underruns
    max_dispatch: int        # largest catch-up block dispatched
    depth: int               # the depth the session was run at


def run_paced_session(gen: StreamingGenerator, frames, *, depth: int = 2,
                      fps: float = 25.0, max_catchup: int = 8,
                      precompile: bool = True) -> SessionReport:
    """Drive a real-clock live session through a depth-``depth`` jitter
    buffer. ``frames`` (per-frame dicts ``{modality: [B, D]}``) arrive on the
    ``fps`` clock; playout of frame j is at ``t0 + (j + depth) / fps``; a
    frame completed after its slot is an underrun, and ``min_depth`` is the
    smallest buffer that would have absorbed the worst lateness. Backlogs are
    drained in power-of-two blocks up to ``max_catchup`` through
    ``push_staged`` on a stream staged once before the clock starts. The
    generated values do not depend on the pacing. ``precompile`` runs every
    block size once (and resets the session) before the clock starts, so
    first-use costs such as the kernel build stay out of the timing."""
    n = len(frames)
    period = 1.0 / fps
    sizes = gen.catchup_sizes(max_catchup)
    staged = gen.stage_session(frames)

    if precompile:
        for k in sizes:
            gen.push_staged(staged, 0, k)[0].cpu()
        gen.reset()

    outputs, dispatch_sizes = [], []
    completion = np.zeros(n)
    idx_dev = torch.zeros((), dtype=torch.long, device=gen.device)
    t0 = time.perf_counter()
    next_idx = 0
    while next_idx < n:
        now = time.perf_counter()
        arrived = min(n, int((now - t0) / period) + 1)
        backlog = arrived - next_idx
        if backlog <= 0:
            time.sleep(max(0.0, t0 + next_idx * period - now))
            continue
        k = next(sz for sz in reversed(sizes)
                 if sz <= backlog and next_idx + sz <= n)
        out, idx_dev = gen.push_staged(staged, idx_dev, k)
        arr = out.cpu().numpy()               # the one blocking round trip
        completion[next_idx:next_idx + k] = time.perf_counter() - t0
        outputs.append(arr)
        dispatch_sizes.append(k)
        next_idx += k

    lateness = completion - np.arange(n) * period
    playout = (np.arange(n) + depth) * period
    return SessionReport(
        frames=np.concatenate(outputs, axis=1),
        lateness_s=lateness,
        underruns=int(np.sum(completion > playout)),
        min_depth=max(int(np.ceil(lateness.max() * fps - 1e-9)), 0),
        max_dispatch=int(max(dispatch_sizes)),
        depth=depth,
    )
