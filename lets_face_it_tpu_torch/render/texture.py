"""UV layouts and skin textures for the textured render path (the port of
``lets_face_it_tpu/render/texture.py``; numpy only).

The reference wraps a skin texture picked from ``texture/*.png`` onto FLAME's
UV layout when writing per-frame OBJs (render_tools.py:117-165). Those PNG
assets and FLAME's texture-coordinate tables are user-provided (licensing);
this module loads them when present and otherwise synthesizes both: a
cylindrical UV projection from the template geometry and a procedural
skin-tone texture, so textured stimulus rendering works out of the box.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lets_face_it_tpu_torch.render.rasterizer import SKIN_COLORS


def load_uv_layout(path, faces: np.ndarray) -> np.ndarray:
    """Per-face-corner UVs [F, 3, 2] from a FLAME texture-space file.

    Accepts the public ``FLAME_texture.npz`` layout (``vt`` [Nt, 2] texture
    vertices + ``ft`` [F, 3] texture-face indices). Falls back to treating
    ``vt`` as per-mesh-vertex coords when no ``ft`` is present.
    """
    data = np.load(path, allow_pickle=True)
    vt = np.asarray(data["vt"], np.float32)
    if "ft" in data:
        ft = np.asarray(data["ft"], np.int64)
        return vt[ft]
    return vt[np.asarray(faces, np.int64)]


def cylindrical_uv_layout(template_vertices: np.ndarray,
                          faces: np.ndarray) -> np.ndarray:
    """Synthetic per-face-corner UVs [F, 3, 2]: cylindrical projection of the
    template head (u from the angle around the vertical axis, v from height).
    Faces crossing the wrap seam are shifted to the u=1 edge (they sit at the
    back of the head, off-camera in the dyadic view)."""
    v = np.asarray(template_vertices, np.float64)
    u = np.arctan2(v[:, 0], v[:, 2]) / (2 * np.pi) + 0.5
    y = v[:, 1]
    h = (y - y.min()) / max(np.ptp(y), 1e-9)
    per_vertex = np.stack([u, h], axis=1).astype(np.float32)

    uv = per_vertex[np.asarray(faces, np.int64)]        # [F, 3, 2]
    span = uv[:, :, 0].max(axis=1) - uv[:, :, 0].min(axis=1)
    seam = span > 0.5
    wrapped = uv[seam]
    lo = wrapped[:, :, 0] < 0.5
    wrapped[:, :, 0] = np.where(lo, wrapped[:, :, 0] + 1.0, wrapped[:, :, 0])
    uv[seam] = np.clip(wrapped, 0.0, 1.0)
    return uv


def procedural_skin_texture(skin_color: str | tuple = "white",
                            size: int = 256, seed: int = 0) -> np.ndarray:
    """[size, size, 3] uint8 skin-tone texture: the base color with smooth
    multiplicative mottling and fine grain, a stand-in for the reference's
    ``texture/*.png`` assets."""
    base = np.asarray(SKIN_COLORS.get(skin_color, skin_color), np.float64)
    rng = np.random.default_rng(seed)

    def smooth_noise(cells: int, amplitude: float) -> np.ndarray:
        coarse = rng.standard_normal((cells, cells))
        # bilinear upsample to [size, size]
        xs = np.linspace(0, cells - 1, size)
        x0 = np.clip(xs.astype(int), 0, cells - 2)
        fx = xs - x0
        rows = (coarse[x0] * (1 - fx[:, None]) + coarse[x0 + 1] * fx[:, None])
        cols = (rows[:, x0] * (1 - fx[None, :]) + rows[:, x0 + 1] * fx[None, :])
        return amplitude * cols

    mottle = smooth_noise(8, 0.06) + smooth_noise(32, 0.03)
    grain = 0.015 * rng.standard_normal((size, size))
    tex = base[None, None, :] * (1.0 + mottle + grain)[:, :, None]
    return np.clip(tex * 255.0, 0, 255).astype(np.uint8)


def find_skin_texture(skin_color: str, texture_dir="texture",
                      seed: int = 0) -> np.ndarray:
    """A real texture PNG from ``texture_dir`` when available (the
    reference's asset convention), else a procedural one."""
    d = Path(texture_dir)
    if d.is_dir():
        candidates = sorted(d.glob(f"*{skin_color}*.png")) or sorted(
            d.glob("*.png"))
        if candidates:
            try:
                import cv2

                img = cv2.imread(str(candidates[seed % len(candidates)]))
                if img is not None:
                    return img[..., ::-1].copy()  # BGR -> RGB
            except ImportError:
                pass
    return procedural_skin_texture(skin_color, seed=seed)
