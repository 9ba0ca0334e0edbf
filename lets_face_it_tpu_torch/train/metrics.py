"""Training-time self-checks (the port of ``lets_face_it_tpu/train/metrics.py``;
reference mimicry_logger.py): jerk statistics, the invertibility error and
matched-vs-deranged NLL probes."""

from __future__ import annotations

import torch

from lets_face_it_tpu_torch.model import seqglow
from lets_face_it_tpu_torch.train import derange


def calc_jerk(x):
    """Mean |third difference| over time (glow/utils.py:53-58). x: [B, T, C]."""
    d1 = x[:, 1:] - x[:, :-1]
    d2 = d1[:, 1:] - d1[:, :-1]
    d3 = d2[:, 1:] - d2[:, :-1]
    return d3.abs().mean()


def jerk_metrics(gt_seq, generated_seq) -> dict:
    """gt / generated / ratio triplet (mimicry_logger.py:175-184)."""
    gt = calc_jerk(gt_seq)
    gen = calc_jerk(generated_seq)
    return {"jerk/gt_jerk": gt, "jerk/generated_jerk": gen,
            "jerk/generated_jerk_ratio": gen / gt}


@torch.no_grad()
def invertibility_error(spec, model, batch, z_seq, loss):
    """Percentage disagreement between the forward NLL ``loss`` of ``batch``
    and the backward NLL of decoding its latents ``z_seq``
    (mimicry_logger.py:241-251)."""
    _, backward_loss = seqglow.sequence_invert(spec, model, z_seq, batch)
    return torch.abs((backward_loss + loss) / loss) * 100.0


@torch.no_grad()
def wrong_context_probes(spec, model, batch, base_loss, mismatch_cfg,
                         generator: torch.Generator) -> dict:
    """NLL deltas for each configured derangement group
    (mimicry_logger.py:199-238): positive => the model prefers matched
    conditioning. The permutations come from ``generator``."""
    out = {}
    for shuffle_time, groups in (
            (False, mismatch_cfg.get("shuffle_batch", {})),
            (True, mismatch_cfg.get("shuffle_time", {}))):
        for group_name, modalities in groups.items():
            deranged = derange.derange_batch(batch, modalities,
                                             generator=generator,
                                             shuffle_time=shuffle_time)
            _, mismatched_loss, _ = seqglow.sequence_nll(spec, model, deranged)
            kind = "shuffled_time" if shuffle_time else "shuffled_batch"
            out[f"mismatched_nll/{kind}/{group_name}"] = base_loss - mismatched_loss
    return out
