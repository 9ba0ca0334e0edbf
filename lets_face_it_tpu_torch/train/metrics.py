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


def probe_groups(mismatch_cfg: dict) -> list:
    """[(metric name, modalities, shuffle_time)] of the configured
    derangement groups, in the order ``wrong_context_probes`` computes them
    (the batch-shuffled groups, then the time-shuffled ones)."""
    return [(f"mismatched_nll/{kind}/{group}", modalities, shuffle_time)
            for key, kind, shuffle_time in (("shuffle_batch", "shuffled_batch", False),
                                            ("shuffle_time", "shuffled_time", True))
            for group, modalities in mismatch_cfg.get(key, {}).items()]


@torch.no_grad()
def wrong_context_probes(spec, model, batch, base_loss, mismatch_cfg,
                         generator: torch.Generator | None = None, *,
                         permutations: dict | None = None) -> dict:
    """NLL deltas for each configured derangement group
    (mimicry_logger.py:199-238): positive => the model prefers matched
    conditioning. The permutations come from ``generator``, or from
    ``permutations`` ({metric name: (perm, time_perm or None)}, a replayed
    run's; a group it lacks raises)."""
    if (generator is None) == (permutations is None):
        raise ValueError("give the probes a generator or their permutations")
    out = {}
    for key, modalities, shuffle_time in probe_groups(mismatch_cfg):
        if permutations is None:
            deranged = derange.derange_batch(batch, modalities, generator=generator,
                                             shuffle_time=shuffle_time)
        elif key not in permutations:
            raise ValueError(f"no permutation for the probe {key}")
        else:
            perm, time_perm = permutations[key]
            deranged = derange.derange_batch(batch, modalities, perm=perm,
                                             time_perm=time_perm,
                                             shuffle_time=shuffle_time)
        _, mismatched_loss, _ = seqglow.sequence_nll(spec, model, deranged)
        out[key] = base_loss - mismatched_loss
    return out
