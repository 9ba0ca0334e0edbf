"""Dyadic avatar video rendering: FLAME vertex sequences -> side-by-side mp4
(the port of ``lets_face_it_tpu/render/video.py``).

The reference pipeline per frame was: write a textured OBJ to a temp dir,
re-load it with trimesh, rasterize with pyrender, feed cv2.VideoWriter
(render_tools.py:117-165). Here the whole sequence is rasterized in one
batched native call (OpenMP over frames), ``render_double_face_frames``, and
``render_double_face_video`` streams those images to cv2. The two stages are
apart so that the raster stage runs where OpenCV is not installed.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from lets_face_it_tpu_torch.render.rasterizer import SKIN_COLORS, Rasterizer

FACE_SHIFT = 0.1 * 2  # ±2 face-widths in x (render_tools.py:150-153)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def render_double_face_frames(vertices, vertices2, faces, *,
                              skin_color_v1: str | None = None,
                              skin_color_v2: str | None = None,
                              width: int = 2048, height: int = 1024,
                              uv_layout=None, textures=None,
                              textured: bool = False) -> np.ndarray:
    """vertices, vertices2: [T, V, 3] (numpy, or tensors on any device);
    faces: [F, 3]. Returns the side-by-side images [T, height, width, 3]
    uint8 (RGB).

    Textured path (render_tools.py:117-165 parity): pass ``textured=True``
    to wrap a skin texture per face: ``uv_layout`` [F, 3, 2] (defaults to a
    cylindrical projection of the first frame) and ``textures`` a pair of
    [th, tw, 3] uint8 images (defaults to procedural skin from the chosen
    skin colors, or ``texture/*.png`` assets when that directory exists).
    """
    v1 = _host_f32(vertices).copy()
    v2 = _host_f32(vertices2).copy()
    first = v1[0].copy()
    v1[:, :, 0] -= FACE_SHIFT
    v2[:, :, 0] += FACE_SHIFT

    skin1 = skin_color_v1 or random.choice(list(SKIN_COLORS))
    skin2 = skin_color_v2 or random.choice(list(SKIN_COLORS))

    rc = Rasterizer(width=width, height=height, x=width // 2, y=400, z=-1,
                    f=(4754.97941935, 4754.97941935))
    if textured or uv_layout is not None or textures is not None:
        from lets_face_it_tpu_torch.render import texture as texture_mod

        if uv_layout is None:
            uv_layout = texture_mod.cylindrical_uv_layout(first, faces)
        if textures is None:
            textures = (texture_mod.find_skin_texture(skin1, seed=0),
                        texture_mod.find_skin_texture(skin2, seed=1))
        ones = np.ones((v1.shape[1], 3), np.float32)
        return rc.render([(v1, faces, ones), (v2, faces, ones)],
                         uvs=[uv_layout, uv_layout], textures=list(textures))
    colors1 = np.tile(np.asarray(SKIN_COLORS[skin1], np.float32),
                      (v1.shape[1], 1))
    colors2 = np.tile(np.asarray(SKIN_COLORS[skin2], np.float32),
                      (v2.shape[1], 1))
    return rc.render([(v1, faces, colors1), (v2, faces, colors2)])


def render_double_face_video(file_name, vertices, vertices2, faces, *,
                             fps: int = 50, skin_color_v1: str | None = None,
                             skin_color_v2: str | None = None,
                             width: int = 2048, height: int = 1024,
                             uv_layout=None, textures=None,
                             textured: bool = False):
    """``render_double_face_frames``, then the images written as an mp4 to
    ``file_name`` at ``fps``. Needs OpenCV (``cv2``)."""
    import cv2

    images = render_double_face_frames(
        vertices, vertices2, faces, skin_color_v1=skin_color_v1,
        skin_color_v2=skin_color_v2, width=width, height=height,
        uv_layout=uv_layout, textures=textures, textured=textured)
    writer = cv2.VideoWriter(str(file_name), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (width, height))
    try:
        for frame in images:
            writer.write(frame[..., ::-1])  # RGB -> BGR
    finally:
        writer.release()
    return file_name
