"""Sliding-window conditioning encoders, batched over every frame at once (the
port of ``lets_face_it_tpu/model/encoders.py``).

All windows for all frames are gathered into one ``[B, N, h, D]`` tensor and
the encoder runs once: the RNN runs ``h`` steps whose batch is ``B*N``.

Window semantics (models.py:598-615): the agent's own face history is
``[t-h, t)`` (strictly past), every other modality is ``(t-h, t]`` — the
interlocutor's *current* frame is visible.

Frame-level dropout (models.py:55-58): during training a mask is drawn over
whole frames of each history window (``[B, N, h]``), zeroing entire frames
and scaling the survivors by ``1/keep``. The masks come from a
``torch.Generator`` or are handed in (``dropout_masks``), so that a test can
replay another framework's draws. Unlike the JAX package, no encoder scan is
rematerialised: the saved activations of ``final_model`` at B=256 are a few
GB, far below the GPU's memory.
"""

from __future__ import annotations

import math

import torch

from lets_face_it_tpu_torch.core import ops, rnn
from lets_face_it_tpu_torch.model.spec import CondSpec, EncSpec

# Concat order of the conditioning vector (models.py:127-145).
MODALITY_ORDER = ("p1_face", "p2_face", "p1_speech", "p2_speech")


def init_modality_encoder(generator: torch.Generator, spec: EncSpec) -> dict:
    if spec.enc == "rnn":
        return {"rnn": rnn.init_gru_cell(generator, spec.input_dim,
                                         spec.hidden_dim)}
    if spec.enc == "lstm":
        return {"rnn": rnn.init_lstm_cell(generator, spec.input_dim,
                                          spec.hidden_dim)}
    if spec.enc == "mlp":
        return {"mlp": ops.init_linear(generator, spec.input_dim * spec.history,
                                       spec.hidden_dim)}
    if spec.enc == "cnn":
        k = 1.0 / math.sqrt(spec.input_dim * spec.kernel_size)
        return {
            "w": ops.uniform_init(
                generator, (spec.hidden_dim, spec.input_dim, spec.kernel_size), k),
            "b": ops.uniform_init(generator, (spec.hidden_dim,), k),
        }
    if spec.enc == "none":
        return {}
    raise NotImplementedError(spec.enc)


def init_feature_encoder(generator: torch.Generator, cond: CondSpec) -> dict:
    params = {"p1_face": init_modality_encoder(generator, cond.p1_face)}
    for name in MODALITY_ORDER[1:]:
        spec = getattr(cond, name)
        if spec is not None:
            params[name] = init_modality_encoder(generator, spec)
    return params


def encode_windows(spec: EncSpec, params, windows):
    """Encode [B, N, h, D] windows -> [B, N, out_dim]."""
    b, n, h, d = windows.shape
    if spec.enc in ("rnn", "lstm"):
        flat = windows.reshape(b * n, h, d)
        if spec.enc == "rnn":
            _, h_last = rnn.gru_scan(params["rnn"], flat)
        else:
            _, (h_last, _) = rnn.lstm_scan(params["rnn"], flat)
        # the reference concatenates seq[:, -1] with h_state[0], which for a
        # single-layer unidirectional RNN are the same tensor
        out = torch.cat([h_last, h_last], dim=-1)
        return out.reshape(b, n, spec.out_dim)
    if spec.enc == "mlp":
        return ops.leaky_relu(ops.linear(params["mlp"],
                                         windows.reshape(b, n, h * d)))
    if spec.enc == "cnn":
        # cross-correlation with 'same'-style padding k//2, written as an
        # unfold + matmul so no convolution library (and no TF32) is involved
        pad = spec.kernel_size // 2
        lhs = windows.reshape(b * n, h, d).transpose(1, 2)          # [M, D, h]
        lhs = torch.nn.functional.pad(lhs, (pad, pad))
        patches = lhs.unfold(2, spec.kernel_size, 1)                # [M, D, t, k]
        out = torch.einsum("mdtk,odk->mto", patches, params["w"]) + params["b"]
        return out.reshape(b, n, -1)                                # [B, N, t*hid]
    if spec.enc == "none":
        return windows.reshape(b, n, h * d)
    raise NotImplementedError(spec.enc)


def _windows(x, times, offsets):
    idx = times[:, None] + offsets[None, :]
    return x[:, idx]


def own_face_windows(x, times, history: int):
    """Strictly-past windows [t-h, t). x: [B, T, D], times: [N] -> [B, N, h, D]."""
    offsets = torch.arange(-history, 0, device=times.device)
    return _windows(x, times, offsets)


def other_windows(x, times, history: int):
    """Windows (t-h, t] including the current frame. -> [B, N, h, D]."""
    offsets = torch.arange(-history + 1, 1, device=times.device)
    return _windows(x, times, offsets)


def frame_dropout_mask(spec: EncSpec, shape, generator: torch.Generator):
    """Keep-mask [B, N, h] over whole history frames, drawn as
    ``uniform < keep`` from ``generator`` (on its own device)."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < 1.0 - spec.dropout


def dropout_mask_shapes(cond: CondSpec, b: int, n: int) -> dict:
    """{modality: [B, N, h]} of the frame-dropout masks that a training
    encode of B sequences of N frames draws, in the order it draws them
    (``encode_conditioning``)."""
    names = (["p1_face"] if cond.p1_face.out_dim > 0 else []) + [
        name for name in MODALITY_ORDER[1:] if getattr(cond, name) is not None]
    return {name: (b, n, getattr(cond, name).history) for name in names
            if getattr(cond, name).dropout > 0.0}


def _frame_dropout(spec: EncSpec, windows, mask):
    """Zero whole history frames of [B, N, h, D] windows, scale the rest."""
    keep = 1.0 - spec.dropout
    mask = mask.to(windows.device, windows.dtype)
    return windows * (mask / keep)[..., None]


def _encode_all(cond: CondSpec, params, windows: dict, frame_nbs, empty, *,
                training: bool = False, generator: torch.Generator | None = None,
                dropout_masks: dict | None = None):
    """Encode each modality's [B, N, h, D] windows (with frame dropout when
    training) and concatenate them with the frame numbers; ``empty`` is the
    result when there is nothing to encode."""
    parts = []
    for name, w in windows.items():
        spec = getattr(cond, name)
        if training and spec.dropout > 0.0:
            mask = (dropout_masks[name] if dropout_masks is not None
                    else frame_dropout_mask(spec, w.shape[:3], generator))
            w = _frame_dropout(spec, w, mask)
        parts.append(encode_windows(spec, params[name], w))
    if cond.use_frame_nb:
        if frame_nbs is None:
            raise ValueError("use_frame_nb needs frame_nbs")
        parts.append(frame_nbs)
    return torch.cat(parts, dim=-1) if parts else empty


def _other_windows_all(cond: CondSpec, batch, times) -> dict:
    """Windows of every conditioned modality but the agent's own face."""
    return {name: other_windows(batch[name], times, getattr(cond, name).history)
            for name in MODALITY_ORDER[1:] if getattr(cond, name) is not None}


def encode_conditioning(cond: CondSpec, params, batch, prev_p1_faces, times, *,
                        frame_nbs=None, training: bool = False,
                        generator: torch.Generator | None = None,
                        dropout_masks: dict | None = None):
    """Full conditioning vector for every frame: -> [B, N, feature_dim].

    ``prev_p1_faces`` supplies the agent's own face history (teacher-forced,
    this is ``batch['p1_face']``); other modalities come from ``batch``.
    With ``training``, modalities whose encoder has dropout get frame
    dropout: masks [B, N, h] from ``dropout_masks[name]`` when given, else
    drawn from ``generator`` in the order of ``MODALITY_ORDER``."""
    windows = {}
    if cond.p1_face.out_dim > 0:
        windows["p1_face"] = own_face_windows(prev_p1_faces, times,
                                              cond.p1_face.history)
    windows.update(_other_windows_all(cond, batch, times))
    empty = prev_p1_faces.new_zeros((prev_p1_faces.shape[0], times.shape[0], 0))
    return _encode_all(cond, params, windows, frame_nbs, empty, training=training,
                       generator=generator, dropout_masks=dropout_masks)


def encode_fixed_conditioning(cond: CondSpec, params, batch, times, *,
                              frame_nbs=None):
    """The non-autoregressive slice of the conditioning vector (everything
    except the agent's own face encoding) for all frames, computed before the
    sampling loop. -> [B, N, feature_dim - p1_face.out_dim]."""
    x = batch["p1_face"]
    return _encode_all(cond, params, _other_windows_all(cond, batch, times),
                       frame_nbs, x.new_zeros((x.shape[0], times.shape[0], 0)))


def encode_p1_face_single(cond: CondSpec, params, face_hist):
    """Encode one own-face history window [B, h, D] -> [B, out_dim]."""
    return encode_windows(cond.p1_face, params["p1_face"], face_hist[:, None])[:, 0]
