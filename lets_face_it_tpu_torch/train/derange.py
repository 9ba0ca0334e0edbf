"""Batch derangement for negative-NLL training and mismatched-conditioning
probes (the port of ``lets_face_it_tpu/train/derange.py``; reference
glow/utils.py:85-113).

Shuffles the chosen modalities across the batch (and optionally across time)
so that the conditioning no longer matches the motion: a training signal
(gradient ascent on mismatched data, lets_face_it_glow.py:39-54) and an
"is the model listening" probe (mimicry_logger.py:199-238). The permutations
are drawn from a ``torch.Generator`` or handed in.
"""

from __future__ import annotations

import torch

ALL_MODALITIES = ("p1_face", "p2_face", "p1_speech", "p2_speech")


def derange_batch(batch, modalities, *, perm=None, time_perm=None,
                  generator: torch.Generator | None = None,
                  shuffle_time: bool = False):
    """Permute ``modalities`` across the batch dim (``perm`` [B], drawn from
    ``generator`` when not given); with ``shuffle_time`` also across time
    (``time_perm`` [T], drawn after ``perm``). Other entries pass through."""
    b, t = batch["p1_face"].shape[:2]
    if perm is None:
        perm = torch.randperm(b, generator=generator)
    if shuffle_time and time_perm is None:
        time_perm = torch.randperm(t, generator=generator)
    out = dict(batch)
    for name in ALL_MODALITIES:
        if name in batch and name in modalities:
            x = batch[name][perm.to(batch[name].device)]
            if shuffle_time:
                x = x[:, time_perm.to(x.device)]
            out[name] = x
    return out


def mismatched_modalities(conditioning: dict):
    """The p2 modalities being conditioned on, and the metric-name suffix
    (glow/utils.py:103-113)."""
    modalities = []
    if conditioning["p2_face"]["history"] > 0:
        modalities.append("p2_face")
    if conditioning["p2_speech"]["history"] > 0:
        modalities.append("p2_speech")
    if not modalities:
        return [], None
    name = "p2" if len(modalities) == 2 else modalities[0]
    return modalities, name
