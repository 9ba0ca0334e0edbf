"""User-study stimulus-set construction (the port of
``lets_face_it_tpu/data_segments/study_sets.py``; reference create_seqs.py, whose
``misc.find_test_segments`` dependency is missing upstream; see SURVEY.md
"known bit-rot" — rebuilt self-contained).

Builds the three stimulus families of the paper's mimicry perception study
from the annotated segments:

* ``mimicry_gt``: annotated mimicry intervals, both parties ground truth
* ``mimicry_random_alignment``: the same agent intervals paired with an
  interlocutor interval drawn from a *different* time (breaks the temporal
  alignment while keeping marginal motion statistics)
* ``non_mimicry``: intervals from the un-annotated gaps between mimicry
  events, and their random-alignment variants

Each entry is ``(file_name, session, start_ms, stop_ms, partner_start_ms)``;
callers materialize frames and hand them to ``stimulus.generate_videos``.
"""

from __future__ import annotations

import random

from lets_face_it_tpu_torch.data_segments.segments import MimicrySegment, get_segments


def _named(kind: str, seg: MimicrySegment, partner_start=None):
    name = f"{kind}_{seg.session}_{seg.start_ms}_{seg.stop_ms}.mp4"
    return (name, seg.session, seg.start_ms, seg.stop_ms,
            seg.start_ms if partner_start is None else partner_start)


def mimicry_gt(splits_file, annotations_file, *, split="train",
               min_duration_ms=1500, block_list=()):
    """Ground-truth mimicry intervals."""
    segs = [s for s in get_segments(splits_file, annotations_file, split)
            if s.mimicry_type is not None
            and s.duration_ms >= min_duration_ms]
    out = []
    for seg in segs:
        entry = _named("mimicry", seg)
        if entry[0] not in block_list:
            out.append(entry)
    return out


def random_alignment(entries, *, seed=1234, min_offset_ms=4000):
    """Re-pair each entry's interlocutor with a time-shifted interval of the
    same session (temporal alignment broken, content preserved)."""
    rng = random.Random(seed)
    out = []
    for name, session, start, stop, _ in entries:
        offset = rng.choice([-1, 1]) * rng.randint(
            min_offset_ms, min_offset_ms * 4)
        new_name = name.replace(".mp4", "_randalign.mp4")
        out.append((new_name, session, start, stop, max(0, start + offset)))
    return out


def non_mimicry(splits_file, annotations_file, *, split="train",
                min_duration_ms=1500, max_count=None, seed=1234):
    """Intervals from the gaps between annotated mimicry events."""
    segs = [s for s in get_segments(splits_file, annotations_file, split)
            if s.mimicry_type is None and s.duration_ms >= min_duration_ms]
    out = [_named("non_mimicry", s) for s in segs]
    if max_count is not None and len(out) > max_count:
        out = random.Random(seed).sample(out, max_count)
    return out


def build_study_sets(splits_file, annotations_file, *, split="train",
                     min_duration_ms=1500, seed=1234, block_list=()):
    """The full stimulus-set family keyed by condition name."""
    gt = mimicry_gt(splits_file, annotations_file, split=split,
                    min_duration_ms=min_duration_ms, block_list=block_list)
    nm = non_mimicry(splits_file, annotations_file, split=split,
                     min_duration_ms=min_duration_ms,
                     max_count=len(gt) or None, seed=seed)
    return {
        "mimicry_gt": gt,
        "mimicry_random_alignment": random_alignment(gt, seed=seed),
        "non_mimicry_gt": nm,
        "non_mimicry_random_alignment": random_alignment(nm, seed=seed + 1),
    }
