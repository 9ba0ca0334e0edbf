"""Adapters for the external, third-party feature-extraction stages (the
port's copy of ``lets_face_it_tpu/features/external.py``).

The reference wraps three heavyweight external systems that the pipeline
keeps as *optional* subprocess stages with documented on-disk interfaces
(SURVEY.md §2.2):

* **OpenFace** (openface.py:12-48): dockerized ``FeatureExtraction`` binary
  producing ``openface_{fps}fps.csv`` per participant; downstream consumes
  only the confidence/success columns (3, 4) and 2-D landmark columns
  299:435.
* **RingNet** (ringnet.py:96-176): TF1 graph producing per-frame FLAME
  initialisation as ``ringnet_{fps}fps.h5`` with group ``flame_params/{cam,
  pose, shape, expression}``, plus a neutral mesh PLY.
* **VOCA + DeepSpeech** (voca.py:126-202): TF1 graphs producing per-frame
  lipsync vertex offsets as ``voca_{fps}fps.npy`` on the neutral mesh.

Each adapter checks availability, runs idempotently, and raises
``StageUnavailable`` with the exact interface contract when the external
system is absent so a user can produce the artifacts elsewhere and drop them
in — the rest of the pipeline only reads these files.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path


class StageUnavailable(RuntimeError):
    pass


def _have(binary: str) -> bool:
    return shutil.which(binary) is not None


def extract_openface(video_path, out_csv, fps: int = 25,
                     docker_image: str = "algebr/openface:latest") -> Path:
    """Run OpenFace FeatureExtraction in docker; writes ``out_csv``.

    Flags match the reference invocation (openface.py:24-35):
    ``-2Dfp -3Dfp -pdmparams -pose -aus -gaze``.
    """
    out_csv = Path(out_csv)
    if out_csv.exists():
        return out_csv
    if not _have("docker"):
        raise StageUnavailable(
            "OpenFace stage needs docker + the algebr/openface image. "
            f"Alternatively place the CSV at {out_csv} (FeatureExtraction "
            "output with -2Dfp -3Dfp -pdmparams -pose -aus -gaze; columns "
            "3/4 = confidence/success, 299:435 = 2-D landmarks).")
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    video_path = Path(video_path).absolute()
    proc = subprocess.run([
        "docker", "run", "--rm",
        "-v", f"{video_path.parent}:/in",
        "-v", f"{out_csv.parent.absolute()}:/out",
        docker_image,
        "build/bin/FeatureExtraction", "-f", f"/in/{video_path.name}",
        "-out_dir", "/out", "-of", out_csv.stem,
        "-2Dfp", "-3Dfp", "-pdmparams", "-pose", "-aus", "-gaze",
    ], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"OpenFace failed: {proc.stderr[-2000:]}")
    return out_csv


def require_ringnet(out_h5) -> Path:
    """RingNet output contract check (we do not bundle the TF1 graph)."""
    out_h5 = Path(out_h5)
    if out_h5.exists():
        return out_h5
    raise StageUnavailable(
        "RingNet stage: produce per-frame FLAME initialisation with the "
        "RingNet TF1 graph (reference ringnet.py:96-158) as "
        f"{out_h5} containing flame_params/{{cam,pose,shape,expression}}. "
        "Only needed to seed FLAME landmark fitting; the batched L-BFGS "
        "fitter also accepts a zero initialisation (init='zeros').")


def require_voca(out_npy) -> Path:
    """VOCA lipsync output contract check."""
    out_npy = Path(out_npy)
    if out_npy.exists():
        return out_npy
    raise StageUnavailable(
        "VOCA stage: produce per-frame lipsync vertex offsets with the "
        "VOCA+DeepSpeech TF1 graphs (reference voca.py:126-202) as "
        f"{out_npy} ([n_frames, 5023, 3] float). Only used for stimulus "
        "rendering (rendering/generate_test_sequences.py), not training.")
