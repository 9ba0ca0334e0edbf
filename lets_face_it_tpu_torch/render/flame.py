"""FLAME head-model decoder in PyTorch (the port of
``lets_face_it_tpu/render/flame.py``): shape/expression blendshapes, pose
corrective blendshapes and 5-joint linear blend skinning, evaluated batched
over whole sequences on the model's device.

Replaces FLAME_PyTorch as used by the reference render path
(render_tools.py:174-208): one ``flame_vertices`` call evaluates every frame
of a sequence as one batch of products (``torch.einsum``) instead of a
per-frame module call.

Model weights: the FLAME 2019 model (generic/female/male ``.pkl`` from
flame.is.tue.mpg.de, not redistributable, so not bundled). ``load_flame``
reads the official pickle (tolerating its chumpy-wrapped arrays without
needing chumpy installed) or an ``.npz`` with the same field names;
``flame_model_from_arrays`` takes the fields by their ``FlameModel`` names
(for instance the arrays of the JAX package's model); tests use
``synthetic_flame_model``, which makes the same numpy draws as the JAX
package's and so gives the same head bit for bit.

Joint order (FLAME kinematic tree): 0 global, 1 neck, 2 jaw, 3 left eye,
4 right eye; parents [-1, 0, 1, 1, 1].
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from lets_face_it_tpu_torch.utils.device import resolve_device

PARENTS = (-1, 0, 1, 1, 1)
N_JOINTS = 5


class FlameModel(NamedTuple):
    v_template: torch.Tensor   # [V, 3]
    shapedirs: torch.Tensor    # [V, 3, 400] (300 shape + 100 expression)
    posedirs: torch.Tensor     # [V, 3, 36]  (4 non-root joints x 9 rotmat)
    j_regressor: torch.Tensor  # [5, V]
    lbs_weights: torch.Tensor  # [V, 5]
    faces: np.ndarray          # [F, 3] int32 (host-side, for rasterization)

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "FlameModel":
        """The same model with its tensors on ``device``."""
        return FlameModel(*(t.to(device) for t in self[:-1]), faces=self.faces)


class _ChumpyStub:
    """Minimal stand-in so FLAME pkls unpickle without chumpy: keeps the
    wrapped ndarray."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def r(self):
        for key in ("x", "a", "v"):
            if key in self.__dict__:
                return np.asarray(self.__dict__[key])
        raise AttributeError("no array payload in chumpy stub")


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        if module == "scipy.sparse.csc" and name == "csc_matrix":
            from scipy.sparse import csc_matrix

            return csc_matrix
        return super().find_class(module, name)


def _to_np(x):
    if isinstance(x, _ChumpyStub):
        return x.r
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def flame_model_from_arrays(arrays: dict, device="cuda",
                            dtype=torch.float32) -> FlameModel:
    """A ``FlameModel`` on ``device`` from numpy arrays keyed by its field
    names (``v_template``, ``shapedirs``, ``posedirs``, ``j_regressor``,
    ``lbs_weights``, ``faces``); float arrays are rounded to ``dtype`` once,
    ``faces`` stays a host int32 array."""
    device = resolve_device(device)
    tensors = {name: torch.as_tensor(np.asarray(arrays[name], np.float64)).to(
        device=device, dtype=dtype) for name in FlameModel._fields[:-1]}
    return FlameModel(**tensors,
                      faces=np.ascontiguousarray(arrays["faces"], np.int32))


def load_flame(path, device="cuda", dtype=torch.float32) -> FlameModel:
    """Load FLAME 2019 from the official .pkl or an equivalent .npz."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=False) as npz:
            data = dict(npz)
    else:
        with open(path, "rb") as f:
            data = _TolerantUnpickler(f, encoding="latin1").load()
    v_template = _to_np(data["v_template"]).astype(np.float64)
    posedirs = _to_np(data["posedirs"]).astype(np.float64)
    if posedirs.ndim == 2:  # some releases store [V*3, 36]
        posedirs = posedirs.reshape(v_template.shape[0], 3, -1)
    return flame_model_from_arrays({
        "v_template": v_template,
        "shapedirs": _to_np(data["shapedirs"]).astype(np.float64),
        "posedirs": posedirs,
        "j_regressor": _to_np(data["J_regressor"]).astype(np.float64),
        "lbs_weights": _to_np(data["weights"]).astype(np.float64),
        "faces": _to_np(data["f"]).astype(np.int32),
    }, device, dtype)


def synthetic_flame_model(n_vertices: int = 128, seed: int = 0, device="cuda",
                          dtype=torch.float32) -> FlameModel:
    """A random FLAME-shaped model for tests (same tensor contract). The
    draws, and their order, are the JAX package's."""
    rng = np.random.default_rng(seed)
    v_template = rng.standard_normal((n_vertices, 3)) * 0.1
    shapedirs = rng.standard_normal((n_vertices, 3, 400)) * 0.01
    posedirs = rng.standard_normal((n_vertices, 3, 36)) * 0.01
    j_regressor = np.abs(rng.standard_normal((N_JOINTS, n_vertices)))
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)
    weights = np.abs(rng.standard_normal((n_vertices, N_JOINTS)))
    weights /= weights.sum(axis=1, keepdims=True)
    # random valid triangles
    faces = rng.integers(0, n_vertices, (max(n_vertices, 64), 3)).astype(np.int32)
    return flame_model_from_arrays({
        "v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
        "j_regressor": j_regressor, "lbs_weights": weights, "faces": faces,
    }, device, dtype)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3] (batched).

    Uses the unnormalized-axis form R = I + (sin t / t) K + ((1-cos t)/t^2) K^2
    with Taylor fallbacks near t=0 evaluated on *safe* inputs, so both the
    value and the gradient are finite at exactly zero rotation (a plain
    ``torch.where`` over ``sin(t)/t`` back-propagates 0 * NaN there, and
    zero rotations are the common case in landmark-fitting inits)."""
    theta2 = (rvec ** 2).sum(dim=-1)
    small = theta2 < 1e-12
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / safe_theta2)

    x, y, z = rvec.unbind(dim=-1)
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + sinc[..., None, None] * K + cosc[..., None, None] * (K @ K)


def flame_vertices(model: FlameModel, shape, expression, jaw, neck, eyes=None,
                   global_rot=None) -> torch.Tensor:
    """Batched FLAME forward: [N, ...] params -> [N, V, 3] vertices.

    shape [N, <=300], expression [N, <=100], jaw [N, 3], neck [N, 3],
    eyes [N, 6] (left‖right), global_rot [N, 3], all on the model's device.
    The reference render path passes global_rot = 0 and folds head rotation
    into the neck joint (render_tools.py:196-199).
    """
    shape = _pad_to(shape, 300)
    n_expr_total = model.shapedirs.shape[-1] - 300
    expression = _pad_to(expression, n_expr_total)

    betas = torch.cat([shape, expression], dim=-1)               # [N, 400]
    v_shaped = (model.v_template[None]
                + torch.einsum("nk,vck->nvc", betas, model.shapedirs))

    joints = torch.einsum("jv,nvc->njc", model.j_regressor, v_shaped)  # [N, 5, 3]
    return pose_and_skin(model.posedirs, model.lbs_weights, v_shaped, joints,
                         jaw, neck, eyes, global_rot)


def pose_and_skin(posedirs, lbs_weights, v_shaped, joints, jaw, neck,
                  eyes=None, global_rot=None) -> torch.Tensor:
    """Pose-corrective blendshapes + forward kinematics + LBS: the second
    half of ``flame_vertices``, split out so a vertex-subset evaluation (the
    landmark fit restricts to the ~150 anchor vertices) can reuse the exact
    math with externally supplied shaped vertices and joint locations."""
    n = v_shaped.shape[0]
    like = dict(dtype=v_shaped.dtype, device=v_shaped.device)
    if eyes is None:
        eyes = torch.zeros((n, 6), **like)
    if global_rot is None:
        global_rot = torch.zeros((n, 3), **like)

    pose = torch.stack([global_rot, neck, jaw, eyes[:, :3], eyes[:, 3:]],
                       dim=1)                                     # [N, 5, 3]
    rot = rodrigues(pose)                                         # [N, 5, 3, 3]

    # pose corrective blendshapes: non-root relative rotations minus identity
    eye3 = torch.eye(3, **like)
    pose_feature = (rot[:, 1:] - eye3).reshape(n, 36)
    v_posed = v_shaped + torch.einsum("np,vcp->nvc", pose_feature, posedirs)

    # forward kinematics along parents [-1, 0, 1, 1, 1]
    transforms = []
    for j, parent in enumerate(PARENTS):
        offset = joints[:, j] - joints[:, parent] if parent >= 0 else joints[:, j]
        t_local = _rigid(rot[:, j], offset)
        transforms.append(t_local if parent < 0 else transforms[parent] @ t_local)
    A = torch.stack(transforms, dim=1)                            # [N, 5, 4, 4]

    # remove the rest-pose joint locations (standard LBS correction)
    j_homo = torch.cat([joints, torch.zeros((n, N_JOINTS, 1), **like)], dim=-1)
    correction = torch.einsum("njxy,njy->njx", A, j_homo)         # [N, 5, 4]
    A_rel = torch.cat([A[..., :3], (A[..., 3] - correction)[..., None]], dim=-1)

    # the blended transforms' top three rows, [N, V, 3, 4], applied to
    # [v_posed, 1] as multiply-adds (as one batched 4x4 product per vertex,
    # cuBLAS runs millions of tiny GEMVs: 6.7 of the 8.5 ms on the card at
    # N=1500, V=5023 on an H100)
    T = torch.einsum("vj,njxy->nvxy", lbs_weights, A_rel[:, :, :3])
    return (T[..., 3] + T[..., 0] * v_posed[..., 0:1] + T[..., 1] * v_posed[..., 1:2]
            + T[..., 2] * v_posed[..., 2:3])


def _pad_to(x: torch.Tensor, dim: int) -> torch.Tensor:
    if x.shape[-1] == dim:
        return x
    if x.shape[-1] > dim:
        raise ValueError(f"param dim {x.shape[-1]} exceeds model dim {dim}")
    pad = torch.zeros(x.shape[:-1] + (dim - x.shape[-1],), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=-1)


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> homogeneous [..., 4, 4]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def neutral_mesh_vertices(model: FlameModel, shape=None) -> torch.Tensor:
    """Neutral (zero-pose, zero-expression) head vertices [V, 3]: the role
    of the reference's extract_neutral_mesh (ringnet.py:161-176), which ran
    chumpy FLAME over the average RingNet shape."""
    like = dict(dtype=model.v_template.dtype, device=model.device)
    if shape is None:
        shape = torch.zeros((1, 300), **like)
    zero = torch.zeros((1, 3), **like)
    return flame_vertices(model, shape, torch.zeros((1, 50), **like), zero,
                          zero)[0]


def write_ply(path, vertices, faces):
    """Minimal ASCII PLY writer (replaces the psbody.mesh dependency);
    ``vertices`` a numpy array or a tensor on any device."""
    vertices = torch.as_tensor(vertices).detach().cpu().numpy()
    faces = np.asarray(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
    return path


def read_ply(path):
    """Minimal ASCII PLY reader -> (vertices [V,3] f32, faces [F,3] i32)."""
    vertices, faces = [], []
    with open(path) as f:
        n_v = n_f = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        for _ in range(n_v):
            vertices.append([float(x) for x in next(f).split()[:3]])
        for _ in range(n_f):
            parts = next(f).split()
            faces.append([int(x) for x in parts[1:1 + int(parts[0])]])
    return (np.asarray(vertices, np.float32), np.asarray(faces, np.int32))


def get_vertices(model: FlameModel, expression, pose, rotation, eyes=None,
                 shape=None, *, generator: torch.Generator | None = None
                 ) -> torch.Tensor:
    """The reference's render-path contract (render_tools.py:174-208):
    ``pose`` [N, >=6] carries global rotation in [:3] (zeroed) and jaw in
    [3:6]; head rotation is added to the neck; shape defaults to a random
    100-D draw held constant over the sequence, from ``generator`` (a CPU
    generator seeded with 0 when none is given; the JAX package draws from
    ``PRNGKey(0)``, a different stream)."""
    n = expression.shape[0]
    if shape is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draw = torch.rand((1, 100), generator=generator, device=generator.device,
                          dtype=expression.dtype)
        shape = torch.cat([draw.to(expression.device),
                           torch.zeros((1, 200), dtype=expression.dtype,
                                       device=expression.device)], dim=-1)
        shape = shape.expand(n, 300)
    neck = pose[:, :3] + rotation
    jaw = pose[:, 3:6]
    return flame_vertices(model, shape, expression, jaw, neck, eyes)
