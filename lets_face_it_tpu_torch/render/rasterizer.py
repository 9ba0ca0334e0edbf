"""Python binding for the native C++ rasterizer (ctypes); the port of
``lets_face_it_tpu/render/rasterizer.py``, loading ``native/rasterizer.cpp``
through the port's own build (``utils/native.py``, into ``_build/``).

Scene defaults mirror the reference's pyrender setup (render_tools.py:17-87):
ambient 0.2, five white point lights of intensity 1.5 arranged around the
camera axis (straight ahead and rotated ±30° about x and y), intrinsics
camera at ``[0, 0, 1 - z]`` looking down -z, and a white background.
"""

from __future__ import annotations

import ctypes

import numpy as np

from lets_face_it_tpu_torch.utils.native import load_library

_DEF_F = 4754.97941935


class _Camera(ctypes.Structure):
    _fields_ = [("fx", ctypes.c_float), ("fy", ctypes.c_float),
                ("cx", ctypes.c_float), ("cy", ctypes.c_float),
                ("tx", ctypes.c_float), ("ty", ctypes.c_float),
                ("tz", ctypes.c_float),
                ("znear", ctypes.c_float), ("zfar", ctypes.c_float)]


class _PointLight(ctypes.Structure):
    _fields_ = [("x", ctypes.c_float), ("y", ctypes.c_float),
                ("z", ctypes.c_float),
                ("r", ctypes.c_float), ("g", ctypes.c_float),
                ("b", ctypes.c_float), ("intensity", ctypes.c_float)]


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resample (dependency-free; textures only)."""
    yi = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xi = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[yi][:, xi]


def default_lights(intensity: float = 1.5):
    """Five point lights at rotations of [0, 0, 1] (render_tools.py:51-70)."""
    angle = np.pi / 6.0
    base = np.array([0.0, 0.0, 1.0])
    positions = [base, _rot_x(angle) @ base, _rot_x(-angle) @ base,
                 _rot_y(-angle) @ base, _rot_y(angle) @ base]
    return [(p, (1.0, 1.0, 1.0), intensity) for p in positions]


class Rasterizer:
    def __init__(self, width: int = 1024, height: int = 1024, *,
                 x: float = 0.0, y: float = 0.0, z: float = 0.0,
                 f: tuple[float, float] | None = None,
                 ambient: float = 0.2, background=(255, 255, 255),
                 lights=None):
        self.lib = load_library("rasterizer")
        self.width, self.height = width, height
        f = f or (_DEF_F / 2, _DEF_F / 2)
        self.camera = _Camera(fx=f[0], fy=f[1], cx=x, cy=y,
                              tx=0.0, ty=0.0, tz=1.0 - z,
                              znear=0.01, zfar=100.0)
        lights = lights if lights is not None else default_lights()
        self._lights = (_PointLight * len(lights))(*[
            _PointLight(x=p[0], y=p[1], z=p[2], r=c[0], g=c[1], b=c[2],
                        intensity=i) for p, c, i in lights])
        self.ambient = ambient
        self.background = np.asarray(background, np.uint8)

        self.lib.render_frames.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(_Camera),
            ctypes.POINTER(_PointLight), ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]

    def render(self, meshes_per_frame, *, uvs=None, textures=None):
        """meshes_per_frame: list over meshes of
        (vertices [T, V_m, 3] float32, faces [F_m, 3] int32,
         colors [V_m, 3] float in 0..1).

        Textured rendering (render_tools.py:117-165 skin-texture parity):
        ``uvs`` is a list over meshes of per-face-corner coords
        [F_m, 3, 2] (FLAME's vt[ft] layout) and ``textures`` a list of
        equal-size [th, tw, 3] uint8 images, one per mesh; per-vertex
        colors then act as a tint (pass ones for pure texture).

        Returns images [T, H, W, 3] uint8 (RGB)."""
        n_meshes = len(meshes_per_frame)
        t = meshes_per_frame[0][0].shape[0]

        vert_offsets = np.zeros(n_meshes + 1, np.int64)
        face_offsets = np.zeros(n_meshes + 1, np.int64)
        for i, (v, f, _c) in enumerate(meshes_per_frame):
            assert v.shape[0] == t
            vert_offsets[i + 1] = vert_offsets[i] + v.shape[1]
            face_offsets[i + 1] = face_offsets[i] + f.shape[0]

        verts = np.ascontiguousarray(
            np.concatenate([m[0] for m in meshes_per_frame], axis=1),
            np.float32)                                     # [T, total_V, 3]
        faces = np.ascontiguousarray(
            np.concatenate([m[1] for m in meshes_per_frame], axis=0),
            np.int32)
        colors = np.ascontiguousarray(
            np.concatenate([m[2] for m in meshes_per_frame], axis=0),
            np.float32)

        uv_ptr = ctypes.POINTER(ctypes.c_float)()
        tex_ptr = ctypes.POINTER(ctypes.c_uint8)()
        tex_w = tex_h = 0
        if uvs is not None and textures is not None:
            assert len(uvs) == n_meshes and len(textures) == n_meshes
            uv_arr = np.ascontiguousarray(np.concatenate(uvs, axis=0),
                                          np.float32)       # [total_F, 3, 2]
            assert uv_arr.shape == (face_offsets[-1], 3, 2)
            # user-provided texture PNGs may differ in size (and the
            # procedural fallback is 256x256) — resample to a common shape
            # before stacking
            if len({t.shape for t in textures}) > 1:
                h = max(t.shape[0] for t in textures)
                w = max(t.shape[1] for t in textures)
                textures = [_resize_nearest(t, h, w) for t in textures]
            tex_arr = np.ascontiguousarray(np.stack(textures), np.uint8)
            _, tex_h, tex_w, _ = tex_arr.shape
            uv_ptr = uv_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            tex_ptr = tex_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

        images = np.empty((t, self.height, self.width, 3), np.uint8)
        images[:] = self.background

        self.lib.render_frames(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            colors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vert_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            face_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_meshes,
            ctypes.byref(self.camera),
            self._lights, len(self._lights),
            self.ambient, self.ambient, self.ambient,
            uv_ptr, tex_ptr, tex_w, tex_h,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            t, self.width, self.height)
        return images


SKIN_COLORS = {
    "white": (0.95, 0.78, 0.66),
    "black": (0.45, 0.30, 0.22),
}
