"""Video IO stages: fps resampling, frame extraction, frame counting (the
port's copy of ``lets_face_it_tpu/features/video.py``).

ffmpeg/ffprobe subprocess wrappers (reference video_utils.py, shared.py) —
IO, not compute; every stage is idempotent (skips when its output exists),
preserving the reference pipeline's resumability."""

from __future__ import annotations

import json
import subprocess
from pathlib import Path


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr[-2000:]}")
    return proc.stdout


def count_video_frames(video_path) -> int:
    """ffprobe frame count (reference feature_extraction/shared.py:3-4)."""
    out = _run([
        "ffprobe", "-v", "error", "-select_streams", "v:0",
        "-count_frames", "-show_entries", "stream=nb_read_frames",
        "-of", "json", str(video_path)])
    return int(json.loads(out)["streams"][0]["nb_read_frames"])


def convert_video_to_fps(src, dst, fps: int) -> Path:
    """Resample a video to a fixed frame rate (video_utils.py:9-24)."""
    dst = Path(dst)
    if dst.exists():
        return dst
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(".tmp.mp4")
    _run(["ffmpeg", "-y", "-i", str(src), "-filter:v", f"fps=fps={fps}",
          "-c:a", "copy", str(tmp)])
    tmp.rename(dst)
    return dst


def extract_images(video, out_dir, quality: int = 2) -> Path:
    """Dump per-frame JPEGs (video_utils.py:27-39)."""
    out_dir = Path(out_dir)
    if out_dir.exists():
        return out_dir
    tmp = out_dir.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    _run(["ffmpeg", "-y", "-i", str(video), "-qscale:v", str(quality),
          str(tmp / "%06d.jpg")])
    tmp.rename(out_dir)
    return out_dir


def have_ffmpeg() -> bool:
    try:
        subprocess.run(["ffmpeg", "-version"], capture_output=True)
        return True
    except FileNotFoundError:
        return False
