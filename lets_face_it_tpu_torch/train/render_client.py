"""Render client for validation videos (the port of
``lets_face_it_tpu/train/render_client.py``; the reference's MimicryLogger
render path, mimicry_logger.py:65-124): de-standardize the generated and
ground-truth face sequences, serialize them in the render service's byte
protocol (latin-1-decoded ``np.save`` blobs in JSON), and POST them to the
service from a daemon thread, so that rendering never stalls training.
Plain HTTP to a separate service process; it needs nothing of the service
itself."""

from __future__ import annotations

import io
import json
import sys
import urllib.request
from pathlib import Path
from threading import Thread

import numpy as np

from lets_face_it_tpu_torch.data.windows import face_means_stds, load_standardization


def byteify(x: np.ndarray) -> str:
    """``np.save`` bytes as a latin-1 string (render/server.py:39-44)."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(x))
    buf.seek(0)
    return buf.read().decode("latin-1")


class RenderClient:
    def __init__(self, url: str, hp, timeout: float = 600.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.hp = hp
        #: optional (step, video_url) callback fired after a successful render;
        #: the training loop wires it to MetricLogger.video_url
        self.on_rendered = None
        self.face_means = None
        self.face_stds = None
        data_file = Path(hp.dataset_root) / hp.Data["file_name"]
        if data_file.exists() and hp.Data.get("use_standardization", True):
            import h5py   # only with a feature store; GPU hosts may lack it

            with h5py.File(data_file, "r") as f:
                means, stds = load_standardization(f)
            if means:
                self.face_means, self.face_stds = face_means_stds(
                    means, stds, hp.Data["expression_dim"])

    def de_standardize(self, seq: np.ndarray) -> np.ndarray:
        if self.face_means is None:
            return seq
        return seq * self.face_stds + self.face_means

    def _face_payload(self, seq_56: np.ndarray) -> dict:
        """[T, C] standardized face -> the protocol's field dict (expression
        padded to 50, zero shape and rotation; mimicry_logger.py:94-100)."""
        seq = self.de_standardize(np.asarray(seq_56, np.float32))
        t = seq.shape[0]
        exp_dim = self.hp.Data["expression_dim"]
        expression = np.zeros((t, 50), np.float32)
        expression[:, :min(exp_dim, 50)] = seq[:, :min(exp_dim, 50)]
        pose = np.zeros((t, 12), np.float32)
        pose[:, 3:6] = seq[:, exp_dim:exp_dim + 3]          # jaw
        pose[:, :3] = seq[:, exp_dim + 3:exp_dim + 6]       # neck
        return {
            "expression": byteify(expression),
            "pose": byteify(pose),
            "shape": byteify(np.zeros((t, 300), np.float32)),
            "rotation": byteify(np.zeros((t, 3), np.float32)),
        }

    def __call__(self, generated: np.ndarray, gt: np.ndarray, step: int) -> Thread:
        """Render sample 0 of generated against ground truth, side by side,
        asynchronously; returns the posting thread."""
        payload = json.dumps({
            "seqs": [self._face_payload(gt[0]), self._face_payload(generated[0])],
            "file_name": f"val_{step}.mp4",
            "fps": 25,
        }).encode()

        def post():
            try:
                req = urllib.request.Request(
                    f"{self.url}/render", data=payload,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    out = json.loads(resp.read())
                print(f"render: {out.get('url')}", file=sys.stderr)
                if self.on_rendered is not None and out.get("url"):
                    self.on_rendered(step, out["url"])
            except Exception as exc:  # never kill training over a video
                print(f"render request failed: {exc}", file=sys.stderr)

        thread = Thread(target=post, daemon=True, name="render-post")
        thread.start()
        return thread
