"""HTTP render service (the port of ``lets_face_it_tpu/render/server.py``),
byte-compatible with the reference's FastAPI server (render_server.py:31-69)
on the Python stdlib:

    POST /render   JSON {"seqs": [face, face], "file_name": ..., "fps": N}
                   where each face = {"expression", "pose", "shape",
                   "rotation"}: latin-1-decoded ``np.save`` blobs
                   -> {"url": "http://<host>/video/<path>"}
    GET  /video/<path>   streams the mp4

Mesh evaluation (FLAME blendshapes + LBS, ``render/flame.py``) runs batched
on the service's device, the GPU unless ``--device cpu`` is asked for;
rasterization is the native C++ renderer on the host; the mp4 is written
with OpenCV and transcoded by ffmpeg where it is installed.

    python -m lets_face_it_tpu_torch.render.server [--flame_model PATH]
        [--port 8000] [--video_dir videos] [--device cuda]

Without ``--flame_model`` the service renders a synthetic head (smoke
tests). ``--port 0`` binds a free port; the line printed at start names it.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import subprocess
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from uuid import uuid4

import numpy as np
import torch

from lets_face_it_tpu_torch.render import flame as flame_mod
from lets_face_it_tpu_torch.utils.device import resolve_device

VIDEO_DIR = Path("videos")


def debyteify(face: dict, key: str) -> np.ndarray:
    buf = io.BytesIO(face[key].encode("latin-1"))
    buf.seek(0)
    return np.load(buf).astype(np.float32)


def byteify(x: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(x))
    buf.seek(0)
    return buf.read().decode("latin-1")


class RenderService:
    """The service logic, separable from HTTP for direct use and tests.
    ``flame_model``: a ``FlameModel`` (moved to ``device``), a path for
    ``load_flame``, or None for a synthetic 512-vertex head."""

    def __init__(self, flame_model=None, video_dir: Path = VIDEO_DIR,
                 width: int = 2048, *, device="cuda"):
        self.device = resolve_device(device)
        if flame_model is None:
            self.model = flame_mod.synthetic_flame_model(512, device=self.device)
        elif isinstance(flame_model, (str, Path)):
            self.model = flame_mod.load_flame(flame_model, device=self.device)
        else:
            self.model = flame_model.to(self.device)
        self.video_dir = Path(video_dir)
        self.width = width

    def _field(self, face: dict, key: str) -> torch.Tensor:
        return torch.from_numpy(debyteify(face, key)).to(self.device)

    def get_vertices(self, face: dict) -> torch.Tensor:
        """One face of a request -> [T, V, 3] vertices on the service's
        device."""
        shape = self._field(face, "shape") if "shape" in face else None
        return flame_mod.get_vertices(
            self.model, self._field(face, "expression"), self._field(face, "pose"),
            self._field(face, "rotation"), shape=shape)

    def render(self, payload: dict) -> Path:
        file_name = self.video_dir / payload.get("file_name", f"{uuid4()}.mp4")
        fps = payload.get("fps", 25)
        left = self.get_vertices(payload["seqs"][0])
        right = self.get_vertices(payload["seqs"][1])

        from lets_face_it_tpu_torch.render.video import render_double_face_video

        file_name.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(suffix=".mp4") as tmpf:
            render_double_face_video(tmpf.name, left, right, self.model.faces,
                                     fps=fps, width=self.width)
            transcode_h264(tmpf.name, file_name)
        return file_name


def transcode_h264(src, dst):
    """ffmpeg h264 transcode when available (render_server.py:57), else copy."""
    if shutil.which("ffmpeg"):
        proc = subprocess.run(
            ["ffmpeg", "-y", "-i", str(src), "-vcodec", "h264", str(dst)],
            capture_output=True)
        if proc.returncode == 0:
            return
    shutil.copyfile(src, dst)


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/render":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers["Content-Length"])
                payload = json.loads(self.rfile.read(length))
                file_name = service.render(payload)
                url = f"http://{self.headers['Host']}/video/{file_name}"
                self._json(200, {"url": url})
            except Exception as exc:  # mirror the reference's 500-on-error
                self._json(500, {"error": str(exc)})

        def do_GET(self):
            if not self.path.startswith("/video/"):
                return self._json(404, {"error": "not found"})
            path = Path(self.path[len("/video/"):])
            if not str(path).startswith(str(service.video_dir)):
                path = service.video_dir / path
            if not path.exists():
                return self._json(404, {"error": "no such video"})
            data = path.read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--flame_model", default=None,
                        help="FLAME 2019 .pkl/.npz; synthetic head if omitted")
    parser.add_argument("--video_dir", default="videos")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    service = RenderService(args.flame_model, Path(args.video_dir),
                            device=args.device)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(service))
    print(f"render server on :{server.server_address[1]} "
          f"(model: {'synthetic' if args.flame_model is None else args.flame_model}; "
          f"device: {service.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
