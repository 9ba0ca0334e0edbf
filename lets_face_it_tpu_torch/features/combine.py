"""Dataset combiner: per-session features -> ``lets_face_it.h5`` (the
port's copy of ``lets_face_it_tpu/features/combine.py``; ``h5py`` is
imported by the functions that read or write HDF5, and the file it writes
is the one ``data/windows.py::WindowDataset.from_file`` reads).

Reproduces the reference combiner's behavior (combine_features.py:18-216) on
the same on-disk inputs:

    <session>/<P1|P2>/openface_{fps}fps.csv        OpenFace CSV (cols 299:435
                                                   consumed; success = conf
                                                   col 3 >= 0.98 and col 4)
    <session>/<P1|P2>/flame_{fps}fps.h5            tf_exp / tf_pose / tf_rot
    <session>/<P1|P2>/mfcc_{fps}fps.npy
    <session>/<P1|P2>/prosodic_features_{fps}fps.npy

Semantics preserved: neck = global rot + pose[:3], re-centered by the mean
rotation over successful frames; failed frames repaired by linear
interpolation across <=2-frame gaps (preferring nearer neighbours) or the
segment is split; contiguous bins shorter than the 9-frame smoothing window
dropped; face/openface params savgol-smoothed (win 9, poly 3); both dyad
roles written per segment by swapping P1/P2; face kinds standardized by
train-agent statistics, audio kinds raw.

Output schema: /{split}/{kind}/{chunk_i}/{agent,interlocutor} plus
/means/{kind}, /stds/{kind}. ``combine_corpus`` builds the same store in
memory, also from fitted FLAME arrays in place of the ``flame_{fps}fps.h5``
files, for ``WindowDataset.from_chunks`` and a trainer without ``h5py``.
"""

from __future__ import annotations

import csv
import json
from collections import defaultdict
from pathlib import Path

import numpy as np
import scipy.signal

from lets_face_it_tpu_torch.data.windows import Corpus

WIN_LEN = 9
STD_EPS = 1e-6   # below this a channel counts as zero-variance (see
                 # combine_features standardization guard)
FACE_KINDS = ("flame_expression", "flame_jaw", "flame_neck", "flame_rotation",
              "openface")
AUDIO_KINDS = ("mfcc", "prosody")


def ms2frames(ms: float, fps: int) -> int:
    """Millisecond offset -> frame index (reference misc/utils.py)."""
    return int(round(ms / 1000 * fps))


def load_openface_csv(path):
    """(landmarks [T, 136], success [T] bool): cols 299:435 and the
    confidence/success columns (combine_features.py:18-23)."""
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    landmarks = np.array([[float(c.strip()) for c in row[299:435]]
                          for row in rows], np.float64)
    # NOTE: the reference tests ``bool(frame[4])`` on the raw CSV *string*
    # (combine_features.py:23), which is truthy for any non-empty cell — so
    # success effectively reduces to the confidence threshold. Replicated
    # for bit-parity.
    success = np.array([float(r[3]) >= 0.98 and bool(r[4]) for r in rows])
    return landmarks, success


def flame_kinds(tf: dict) -> dict:
    """{expression, jaw, neck, rotation} from the fitted arrays tf_exp /
    tf_pose / tf_rot (combine_features.py:26-33)."""
    exp, pose, rot = tf["tf_exp"], tf["tf_pose"], tf["tf_rot"]
    return {
        "expression": exp,
        "jaw": pose[:, 3:6],
        "neck": pose[:, :3] + rot,
        "rotation": rot,
    }


def load_flame_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return flame_kinds({k: f[k][()] for k in ("tf_exp", "tf_pose", "tf_rot")})


def load_participant(participant_path: Path, fps: int, flame: dict | None = None):
    """One participant's features; ``flame``: its fitted tf_* arrays
    (``flame_fit.fit_participant``), or None to read ``flame_{fps}fps.h5``."""
    p = {}
    landmarks, success = load_openface_csv(
        participant_path / f"openface_{fps}fps.csv")
    p["openface"] = landmarks
    p["success"] = success
    p["flame"] = (load_flame_h5(participant_path / f"flame_{fps}fps.h5")
                  if flame is None else flame_kinds(flame))
    p["flame"]["neck"] = (p["flame"]["neck"]
                          - p["flame"]["rotation"][success].mean())
    p["mfcc"] = np.load(participant_path / f"mfcc_{fps}fps.npy")
    p["prosody"] = np.load(participant_path / f"prosodic_features_{fps}fps.npy")
    n = len(p["success"])
    assert all(len(p["flame"][k]) == n for k in ("expression", "jaw", "neck"))
    assert len(p["mfcc"]) == n and len(p["prosody"]) == n
    return p


def load_session(session_path: Path, fps: int, flame: dict | None = None):
    """``flame``: {part: fitted tf_* arrays}, or None to read the files."""
    return {part: load_participant(Path(session_path) / part, fps,
                                   None if flame is None else flame[part])
            for part in ("P1", "P2")}


# ---------------------------------------------------------------------------
# Gap repair (combine_features.py:66-104): a failed frame is recoverable when
# a successful frame exists within 2 frames on each side; nearer neighbours
# preferred, and a 2-frame-away past neighbour only pairs with a 1-frame-away
# future one.
#
# Provenance note: this block intentionally mirrors the reference's repair
# preference logic INCLUDING the `if prev and future` quirk (frame index 0
# is falsy, so a repair whose past neighbour is frame 0 is dropped) —
# quirk-for-quirk behavioral parity is the spec here; the mechanics differ
# (bounds checks + plan tuples vs try/except mutation).
# ---------------------------------------------------------------------------

def _try_get(success, n):
    if 0 <= n < len(success) and success[n]:
        return n
    return None


def _with_preference(success, n1, n2, score=1):
    first = _try_get(success, n1)
    if first is not None:
        return first, 1
    if score == 1:
        return _try_get(success, n2), 2
    return None, -1


def repair_plan(frame: int, success) -> int | tuple | None:
    """int -> use as-is; tuple (past, future, steps, pos) -> interpolate;
    None -> unrecoverable."""
    if success[frame]:
        return frame
    prev, prev_score = _with_preference(success, frame - 1, frame - 2)
    future, future_score = _with_preference(success, frame + 1, frame + 2,
                                            prev_score)
    if prev and future:
        return (prev, future, 1 + prev_score + future_score, prev_score)
    return None


def resolve_frame(plan, data: np.ndarray) -> np.ndarray:
    if isinstance(plan, (int, np.integer)):
        return data[plan]
    past, future, steps, pos = plan
    return np.linspace(data[past], data[future], steps, axis=0)[pos]


# ---------------------------------------------------------------------------
# Binning + smoothing + role-swapped segment assembly
# ---------------------------------------------------------------------------

def create_bins(session, start: int, stop: int, agent: str, interlocutor: str):
    bins = []
    new_bin = True
    for frame in range(start, stop):
        a_plan = repair_plan(frame, session[agent]["success"])
        i_plan = repair_plan(frame, session[interlocutor]["success"])
        if a_plan is not None and i_plan is not None:
            if new_bin:
                bins.append([])
                new_bin = False
            bins[-1].append((frame, a_plan, i_plan))
        else:
            new_bin = True
    return bins


def assemble_segment(session, start: int, stop: int, agent: str,
                     interlocutor: str, win_len: int = WIN_LEN):
    """-> {role: {kind: [chunk arrays]}} for one (agent, interlocutor) view."""
    bins = create_bins(session, start, stop, agent, interlocutor)
    out = {"agent": defaultdict(list), "interlocutor": defaultdict(list)}

    for session_bin in bins:
        if len(session_bin) < win_len:
            continue
        per_role = {"agent": defaultdict(list), "interlocutor": defaultdict(list)}
        for orig_frame, a_plan, i_plan in session_bin:
            for role, part, plan in (("agent", agent, a_plan),
                                     ("interlocutor", interlocutor, i_plan)):
                p = session[part]
                for kind in AUDIO_KINDS:
                    per_role[role][kind].append(p[kind][orig_frame])
                per_role[role]["openface"].append(
                    resolve_frame(plan, p["openface"]))
                for name in ("jaw", "expression", "neck", "rotation"):
                    per_role[role][f"flame_{name}"].append(
                        resolve_frame(plan, p["flame"][name]))

        for role in ("agent", "interlocutor"):
            for kind, values in per_role[role].items():
                arr = np.asarray(values)
                if kind not in AUDIO_KINDS:
                    arr = scipy.signal.savgol_filter(arr, win_len, 3, axis=0)
                out[role][kind].append(arr)
    return out


def combine_corpus(dataset_dir, split_spec: dict, fps: int = 25,
                   win_len: int = WIN_LEN, progress=None,
                   flame: dict | None = None) -> Corpus:
    """The full store in memory from per-session features.

    ``split_spec``: {"train"|"val"|"test": {session: [[start_ms, stop_ms], ...]}}
    (the layout of data/train_val_test.json). ``flame``: {session: {part:
    fitted tf_* arrays}}, or None to read each ``flame_{fps}fps.h5``.
    """
    dataset_dir = Path(dataset_dir)
    splits, stds, means = {}, {}, {}
    for split in ("train", "val", "test"):
        grand = defaultdict(lambda: defaultdict(list))
        for session_name, segments in (split_spec.get(split) or {}).items():
            session = load_session(dataset_dir / session_name, fps,
                                   None if flame is None else flame[session_name])
            for start_ms, stop_ms in segments:
                for agent, inter in (("P1", "P2"), ("P2", "P1")):
                    seg = assemble_segment(
                        session,
                        ms2frames(start_ms, fps) - 1,
                        ms2frames(stop_ms, fps) - 1,
                        agent, inter, win_len)
                    for role, kinds in seg.items():
                        for kind, chunks in kinds.items():
                            grand[kind][role] += chunks
            if progress:
                progress(split, session_name)

        if split == "train":
            for kind, roles in grand.items():
                rows = np.vstack([c for c in roles["agent"]])
                std = rows.std(axis=0)
                # a zero-variance channel (e.g. a FLAME dim pinned by the
                # fitter) would standardize to NaN and silently poison
                # training; clamp its std so the channel maps to exact 0
                # and de-standardization (x*std + mean) still restores the
                # constant. The clamped value is what gets written to
                # /stds, keeping both directions consistent.
                degenerate = std < STD_EPS
                if degenerate.any():
                    import warnings

                    warnings.warn(
                        f"combine_features: {int(degenerate.sum())} "
                        f"zero-variance channel(s) in kind '{kind}' — "
                        "std clamped to 1.0 (constant channels "
                        "standardize to ~0)", stacklevel=2)
                stds[kind] = np.where(degenerate, 1.0, std)
                means[kind] = rows.mean(axis=0)

        n_chunks = len(grand["prosody"]["agent"])
        splits[split] = [
            {kind: {role: (chunks[i] if kind in AUDIO_KINDS
                           else (chunks[i] - means[kind]) / stds[kind])
                    for role, chunks in roles.items()}
             for kind, roles in grand.items()}
            for i in range(n_chunks)]
    return Corpus(splits, means, stds)


def combine_features(dataset_dir, output_file, split_spec: dict, fps: int = 25,
                     win_len: int = WIN_LEN, progress=None):
    """Build the full HDF5 from per-session features (``combine_corpus``
    written in the store's schema)."""
    import h5py

    corpus = combine_corpus(dataset_dir, split_spec, fps, win_len, progress)
    output_file = Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(output_file, "w") as f:
        for kind in corpus.means:
            f.create_dataset(f"/stds/{kind}", data=corpus.stds[kind])
            f.create_dataset(f"/means/{kind}", data=corpus.means[kind])
        for split, chunks in corpus.splits.items():
            for i, chunk in enumerate(chunks):
                for kind, roles in chunk.items():
                    for role, data in roles.items():
                        f.create_dataset(f"/{split}/{kind}/{i}/{role}", data=data)
    return output_file


def load_split_spec(path) -> dict:
    """data/train_val_test.json layout."""
    return json.loads(Path(path).read_text())
