"""Validate a dataset-definition directory against the consumed JSON schemas
(the port's copy of ``tools/validate_data_jsons.py``; the extraction CLI's
combine stage runs it on the splits file it is given).

The reference ships three dataset-definition JSONs that cannot be bundled
here (MAHNOB Mimicry licensing), so users supply their own. This validator
checks a ``data/`` directory against exactly what the pipeline consumes —
fail early with a precise message instead of deep inside extraction:

  train_val_test.json   {split: {session: [[start_ms, stop_ms], ...]}}
                        (reference data/train_val_test.json, consumed by
                        features/combine.py::load_split_spec and
                        data_segments/segments.py::get_segments_v2)
  annotations.json      {session: {mimicry_type: [[start_ms, stop_ms,
                        value], ...]}} (consumed by
                        data_segments/segments.py::mimicry_segments)
  meta_data.json        {"sessions": {session: {participant: subject_id}},
                        "subjects": {subject_id: {"gender": ...}}}
                        (consumed by utils/misc.py::get_gender)

Usage: python -m lets_face_it_tpu_torch.data.validate_jsons DATA_DIR
Exit code 0 = consumable (warnings allowed), 1 = schema errors.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

KNOWN_SPLITS = {"train", "val", "test", "heldout_interaction"}


def _check_interval(iv, where, errors, expect_len):
    # the annotation value (3rd slot) may be null in the real MAHNOB
    # annotations (e.g. head_yaw); the segment tooling ignores it
    ok_vals = (isinstance(iv, list) and len(iv) == expect_len
               and all(isinstance(v, (int, float)) for v in iv[:2])
               and all(v is None or isinstance(v, (int, float))
                       for v in iv[2:]))
    if not ok_vals:
        errors.append(f"{where}: expected [start_ms, stop_ms"
                      + (", value]" if expect_len == 3 else "]")
                      + f", got {iv!r}")
        return False
    if iv[0] < 0 or iv[1] <= iv[0]:
        errors.append(f"{where}: degenerate interval {iv[:2]}")
        return False
    return True


def validate_splits(spec, errors, warnings, fname="train_val_test.json"):
    sessions = set()
    if not isinstance(spec, dict):
        errors.append(f"{fname}: top level must be "
                      "{split: {session: [[start_ms, stop_ms], ...]}}")
        return sessions
    unknown = set(spec) - KNOWN_SPLITS
    if unknown:
        warnings.append(f"{fname}: unknown split(s) "
                        f"{sorted(unknown)} (consumed: train/val/test"
                        f"/heldout_interaction)")
    for need in ("train", "val", "test"):
        if need not in spec:
            warnings.append(f"{fname}: split {need!r} missing")
    for split, by_session in spec.items():
        if split == "heldout_interaction" and isinstance(by_session, str):
            # the real file names the user-study heldout session by id only
            sessions.add(by_session)
            continue
        if not isinstance(by_session, dict):
            errors.append(f"{fname}[{split!r}]: must map "
                          "session -> interval list")
            continue
        for session, intervals in by_session.items():
            sessions.add(str(session))
            if not isinstance(intervals, list) or not intervals:
                errors.append(f"{fname}[{split!r}][{session!r}]:"
                              " empty or non-list interval set")
                continue
            spans = []
            for i, iv in enumerate(intervals):
                where = f"{fname}[{split!r}][{session!r}][{i}]"
                if _check_interval(iv, where, errors, 2):
                    spans.append(tuple(iv))
            spans.sort()
            for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
                if b0 < a1:
                    warnings.append(
                        f"{fname}[{split!r}][{session!r}]: "
                        f"overlapping intervals [{a0}, {a1}] and [{b0}, {b1}]"
                        " — windows will be duplicated")
    return sessions


def validate_annotations(ann, split_sessions, errors, warnings):
    if not isinstance(ann, dict):
        errors.append("annotations.json: top level must be "
                      "{session: {type: [[start, stop, value], ...]}}")
        return
    for session, by_type in ann.items():
        if not isinstance(by_type, dict):
            errors.append(f"annotations.json[{session!r}]: must map "
                          "mimicry type -> interval list")
            continue
        if split_sessions and str(session) not in split_sessions:
            warnings.append(f"annotations.json[{session!r}]: session not in "
                            "any train_val_test.json split")
        for kind, intervals in by_type.items():
            if not isinstance(intervals, list):
                errors.append(
                    f"annotations.json[{session!r}][{kind!r}]: not a list")
                continue
            for i, iv in enumerate(intervals):
                _check_interval(
                    iv, f"annotations.json[{session!r}][{kind!r}][{i}]",
                    errors, 3)


def validate_meta(meta, split_sessions, errors, warnings):
    if (not isinstance(meta, dict)
            or not isinstance(meta.get("sessions"), dict)
            or not isinstance(meta.get("subjects"), dict)):
        errors.append('meta_data.json: must contain "sessions" and '
                      '"subjects" maps')
        return
    subjects = meta["subjects"]
    for sid, info in subjects.items():
        if not isinstance(info, dict) or "gender" not in info:
            errors.append(f"meta_data.json subjects[{sid!r}]: missing gender")
    known = {str(k) for k in subjects}
    for session, info in meta["sessions"].items():
        if not isinstance(info, dict):
            errors.append(f"meta_data.json sessions[{session!r}]: must be a "
                          "dict with P1/P2 subject ids")
            continue
        # real MAHNOB metadata carries extra per-session fields (date, topic,
        # experiment type); only the P1/P2 participant ids are consumed
        # (utils/misc.py::get_gender)
        for part in ("P1", "P2"):
            if part not in info:
                errors.append(f"meta_data.json sessions[{session!r}]: "
                              f"missing participant {part!r}")
            elif str(info[part]) not in known:
                errors.append(f"meta_data.json sessions[{session!r}]"
                              f"[{part!r}]: unknown subject {info[part]!r}")
    missing = split_sessions - {str(s) for s in meta["sessions"]}
    if missing:
        warnings.append(f"meta_data.json: {len(missing)} split session(s) "
                        f"without metadata (get_gender will fail for them): "
                        f"{sorted(missing)[:5]}...")


def validate_data_dir(data_dir, splits_file=None
                      ) -> tuple[list[str], list[str], dict]:
    """Returns (errors, warnings, summary). ``splits_file`` overrides the
    split-spec path (default ``<data_dir>/train_val_test.json``) — callers
    with a custom-named splits file must pass the file they actually
    consume, not rely on the conventional name existing next to it."""
    data_dir = Path(data_dir)
    errors: list[str] = []
    warnings: list[str] = []
    summary: dict = {}

    split_sessions: set[str] = set()
    splits_path = (Path(splits_file) if splits_file is not None
                   else data_dir / "train_val_test.json")
    if splits_path.exists():
        try:
            spec = json.loads(splits_path.read_text())
            split_sessions = validate_splits(spec, errors, warnings,
                                             splits_path.name)
            summary["splits"] = {
                s: {"sessions": len(v),
                    "hours": round(sum(iv[1] - iv[0]
                                       for ivs in v.values()
                                       for iv in ivs
                                       if isinstance(iv, list)
                                       and len(iv) == 2) / 3.6e6, 2)}
                for s, v in spec.items() if isinstance(v, dict)}
        except json.JSONDecodeError as exc:
            errors.append(f"{splits_path.name}: invalid JSON ({exc})")
    else:
        errors.append(f"{splits_path.name}: missing (required by "
                      "combine_features and segment tooling)")

    for name, fn in (("annotations.json", validate_annotations),
                     ("meta_data.json", validate_meta)):
        path = data_dir / name
        if not path.exists():
            warnings.append(f"{name}: missing (annotation-driven segment "
                            "selection / gender lookup unavailable)")
            continue
        try:
            fn(json.loads(path.read_text()), split_sessions, errors, warnings)
        except json.JSONDecodeError as exc:
            errors.append(f"{name}: invalid JSON ({exc})")

    return errors, warnings, summary


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    errors, warnings, summary = validate_data_dir(sys.argv[1])
    for w in warnings:
        print(f"WARNING: {w}")
    for e in errors:
        print(f"ERROR: {e}")
    if summary.get("splits"):
        for split, info in summary["splits"].items():
            print(f"{split}: {info['sessions']} sessions, "
                  f"{info['hours']} h annotated")
    if errors:
        raise SystemExit(1)
    print("data directory is consumable")


if __name__ == "__main__":
    main()
