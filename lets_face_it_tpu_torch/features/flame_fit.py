"""FLAME landmark fitting in PyTorch (the port of
``lets_face_it_tpu/features/flame_fit.py``): the per-frame two-stage fit of
the reference, batched across frames on the device.

The reference fits one frame at a time inside a Ray actor pool of 8 TF1
sessions (flame.py:28-29, 266-291), the "CPU+GPU months" stage. Here the
same two-stage optimization is one batched L-BFGS with a zoom line search
(``features/lbfgs.py``, the port's counterpart of the ``optax.lbfgs`` the
JAX package vmaps) over all frames of a chunk at once: each frame is an
independent ~470-dimensional problem with its own memory and line search.

Objective per frame (flame.py:85-159):
  stage 1  (scale, trans, rot):           lmk_dist
  stage 2  (scale, trans_xy, rot, pose, shape, exp): lmk_dist + regularizers
with
  lmk_dist = ||s * lmks3d_xy - target||^2 / factor^2,
  factor   = max spread of the target landmarks,
  regs     = 1e-3 shape + 1e-3 expr + 100 neck + 1e-3 jaw + 10 eyeballs,
  target   = OpenFace landmarks 17..67 (jaw contour dropped), y flipped to
             1024 - y (flame.py:51-53, 284).

Every function here is batched over frames: parameters are dicts of [N, ...]
tensors (``scale`` [N]), landmarks [N, L, 3], losses [N]. A chunk runs on
the device of its FLAME model. The landmark embedding (51 barycentric
anchors on the FLAME surface) comes from the official
``flame_static_embedding.pkl``; tests use a synthetic one.
"""

from __future__ import annotations

import csv
import pickle
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from lets_face_it_tpu_torch.features.lbfgs import lbfgs_solve
from lets_face_it_tpu_torch.render.flame import (FlameModel, _pad_to,
                                                 flame_vertices, load_flame,
                                                 pose_and_skin)
from lets_face_it_tpu_torch.utils.device import resolve_device

WEIGHTS = {"lmk": 1.0, "shape": 1e-3, "expr": 1e-3, "neck_pose": 100.0,
           "jaw_pose": 1e-3, "eyeballs_pose": 10.0}
IMAGE_HEIGHT = 1024.0
FIT_KEYS = ("trans", "rot", "pose", "shape", "exp")


class LandmarkEmbedding(NamedTuple):
    vertex_ids: np.ndarray   # [L, 3] vertex indices of the anchor triangle
    bary: torch.Tensor       # [L, 3] barycentric weights

    def to(self, device) -> "LandmarkEmbedding":
        return LandmarkEmbedding(self.vertex_ids, self.bary.to(device))


class RestrictedFlame(NamedTuple):
    """FLAME restricted to the landmark-anchor vertices.

    The fit objective reads only the 51 barycentric landmarks, i.e. ~150
    unique anchor vertices of the 5,023, but evaluating them through the
    full model drags every [N, V, ...] blendshape/skinning tensor through
    memory per L-BFGS evaluation. Blendshapes, pose correctives, and LBS are
    per-vertex independent, so gathering the anchor rows gives the same
    landmark math ~30x smaller. The one cross-vertex coupling is the joint
    regressor (joints = J @ v_shaped over ALL vertices); its
    template/shapedirs contractions are precomputed so that
    joints = j_template + betas @ j_shapedirs, the same value up to float
    reassociation (~1 ulp)."""
    v_template: torch.Tensor   # [U, 3]
    shapedirs: torch.Tensor    # [U, 3, 400]
    posedirs: torch.Tensor     # [U, 3, 36]
    lbs_weights: torch.Tensor  # [U, 5]
    j_template: torch.Tensor   # [5, 3]
    j_shapedirs: torch.Tensor  # [5, 3, 400]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "RestrictedFlame":
        return RestrictedFlame(*(t.to(device) for t in self))


def restrict_to_landmarks(model: FlameModel, emb: LandmarkEmbedding):
    """-> (RestrictedFlame, LandmarkEmbedding with vertex_ids remapped to
    positions in the gathered anchor-vertex array)."""
    ids = np.asarray(emb.vertex_ids)
    uniq, inv = np.unique(ids.ravel(), return_inverse=True)
    uniq_t = torch.as_tensor(uniq, device=model.device)
    restricted = RestrictedFlame(
        v_template=model.v_template[uniq_t],
        shapedirs=model.shapedirs[uniq_t],
        posedirs=model.posedirs[uniq_t],
        lbs_weights=model.lbs_weights[uniq_t],
        j_template=model.j_regressor @ model.v_template,
        j_shapedirs=torch.einsum("jv,vck->jck", model.j_regressor,
                                 model.shapedirs),
    )
    remapped = LandmarkEmbedding(
        vertex_ids=inv.reshape(ids.shape).astype(ids.dtype), bary=emb.bary)
    return restricted, remapped


def landmark_embedding_from_arrays(vertex_ids, bary, device="cuda"
                                   ) -> LandmarkEmbedding:
    """A ``LandmarkEmbedding`` from numpy arrays (for instance the JAX
    package's embedding): host vertex ids, float32 weights on ``device``."""
    return LandmarkEmbedding(
        vertex_ids=np.asarray(vertex_ids),
        bary=torch.as_tensor(np.array(bary, np.float32),
                             device=resolve_device(device)))


def load_landmark_embedding(path, faces: np.ndarray, device="cuda"
                            ) -> LandmarkEmbedding:
    """Official flame_static_embedding.pkl: lmk_face_idx + lmk_b_coords;
    anchored triangles resolved against the model's topology."""
    with open(Path(path), "rb") as f:
        data = pickle.load(f, encoding="latin1")
    face_idx = np.asarray(data["lmk_face_idx"], np.int64)
    bary = np.asarray(data["lmk_b_coords"], np.float64)
    return landmark_embedding_from_arrays(faces[face_idx], bary, device)


def synthetic_landmark_embedding(model: FlameModel, n_landmarks: int = 51,
                                 seed: int = 0) -> LandmarkEmbedding:
    """Random anchors on the model's faces, on the model's device; the
    numpy draws, and their order, are the JAX package's."""
    rng = np.random.default_rng(seed)
    face_idx = rng.integers(0, model.faces.shape[0], n_landmarks)
    bary = rng.dirichlet(np.ones(3), n_landmarks)
    return landmark_embedding_from_arrays(model.faces[face_idx], bary,
                                          model.device)


def model_landmarks(model, emb: LandmarkEmbedding, params) -> torch.Tensor:
    """3-D landmark positions [N, L, 3] for params {trans, rot, pose, shape,
    exp} of [N, ...].

    ``model`` is a FlameModel or a RestrictedFlame (whose ``emb`` must be the
    matching remapped embedding from ``restrict_to_landmarks``)."""
    pose = params["pose"]
    kinematics = dict(jaw=pose[:, 3:6], neck=pose[:, :3], eyes=pose[:, 6:12],
                      global_rot=params["rot"])
    if isinstance(model, RestrictedFlame):
        shape = _pad_to(params["shape"], 300)
        exp = _pad_to(params["exp"], model.shapedirs.shape[-1] - 300)
        betas = torch.cat([shape, exp], dim=-1)                 # [N, 400]
        v_shaped = (model.v_template[None]
                    + torch.einsum("nk,vck->nvc", betas, model.shapedirs))
        joints = (model.j_template[None]
                  + torch.einsum("nk,jck->njc", betas, model.j_shapedirs))
        verts = pose_and_skin(model.posedirs, model.lbs_weights, v_shaped,
                              joints, **kinematics)
    else:
        verts = flame_vertices(model, params["shape"], params["exp"],
                               **kinematics)
    verts = verts + params["trans"][:, None]
    ids = torch.as_tensor(np.asarray(emb.vertex_ids, np.int64),
                          device=verts.device)
    tri = verts[:, ids]                                  # [N, L, 3, 3]
    # the barycentric sums as multiply-adds: [N, L, 3] in row-major order
    # whatever N is, so that the sums over landmarks below take the same
    # order for a frame alone as in a chunk
    bary = emb.bary[None, :, :, None]
    return (tri[:, :, 0] * bary[:, :, 0] + tri[:, :, 1] * bary[:, :, 1]
            + tri[:, :, 2] * bary[:, :, 2])


def _lmk_dist(model, emb, params, target) -> torch.Tensor:
    lmks = model_landmarks(model, emb, params)
    proj = params["scale"][:, None, None] * lmks[..., :2]
    spread = target.amax(dim=1) - target.amin(dim=1)      # [N, 2]
    factor = torch.maximum(spread[:, 0], spread[:, 1])
    return (WEIGHTS["lmk"] * ((proj - target) ** 2).sum(-1).sum(-1)
            / (factor ** 2))


def _regularizers(params) -> torch.Tensor:
    pose = params["pose"]
    return (WEIGHTS["neck_pose"] * torch.sum(pose[:, :3] ** 2, dim=1)
            + WEIGHTS["jaw_pose"] * torch.sum(pose[:, 3:6] ** 2, dim=1)
            + WEIGHTS["eyeballs_pose"] * torch.sum(pose[:, 6:12] ** 2, dim=1)
            + WEIGHTS["shape"] * torch.sum(params["shape"] ** 2, dim=1)
            + WEIGHTS["expr"] * torch.sum(params["exp"] ** 2, dim=1))


class FlatParams:
    """A dict of [N, ...] parameters as one [N, D] tensor and back, the keys
    in sorted order (the order in which JAX flattens a dict); [N] entries
    (``scale``) take one column."""

    def __init__(self, params: dict):
        self.keys = sorted(params)
        self.widths = [params[k][0].numel() for k in self.keys]
        self.scalar = {k for k in self.keys if params[k].dim() == 1}

    def flatten(self, params: dict) -> torch.Tensor:
        return torch.cat([params[k].reshape(params[k].shape[0], -1)
                          for k in self.keys], dim=1)

    def unflatten(self, x: torch.Tensor) -> dict:
        out = dict(zip(self.keys, torch.split(x, self.widths, dim=1)))
        for k in self.scalar:
            out[k] = out[k][:, 0]
        return out


def _solve(loss_of: Callable, params: dict, n_steps: int):
    """L-BFGS over the dict ``params``: -> (params, loss at the start of the
    last step, evaluations)."""
    flat = FlatParams(params)
    res = lbfgs_solve(lambda x: loss_of(flat.unflatten(x)), flat.flatten(params),
                      n_steps)
    return flat.unflatten(res.x), res.loss, res.evals


@torch.no_grad()
def init_scale(model, emb, params, target) -> torch.Tensor:
    """Scale init = 2-D spread / 3-D xy spread (flame.py:85-100), [N]."""
    lmks = model_landmarks(model, emb, params)
    s2d = torch.mean(torch.linalg.vector_norm(
        target - target.mean(dim=1, keepdim=True), dim=-1), dim=1)
    s3d = torch.mean(torch.sqrt(torch.sum(
        (lmks - lmks.mean(dim=1, keepdim=True))[..., :2] ** 2, dim=-1)), dim=1)
    return s2d / torch.clamp_min(s3d, 1e-9)


def zero_params(model, n: int, init=None) -> dict:
    """{trans, rot, pose, shape, exp} zeros [N, ...] on the model's device,
    with ``init`` (a dict of [N, <=width] arrays, e.g. from RingNet) written
    over their leading columns."""
    device = model.device
    n_expr = model.shapedirs.shape[-1] - 300
    params = {k: torch.zeros((n, w), device=device)
              for k, w in zip(FIT_KEYS, (3, 3, 12, 300, n_expr))}
    for k, v in (init or {}).items():
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        params[k][:, :v.shape[1]] = v
    return params


def _fit_split(model, emb, targets, init, mesh, **steps):
    """``fit_batch`` of this rank's frames, gathered from every rank."""
    targets = torch.as_tensor(targets, dtype=torch.float32, device=model.device)
    n = targets.shape[0]
    pad = (-n) % mesh.size

    def mine(t):
        t = torch.as_tensor(t, device=model.device)
        if pad:
            t = torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
        return mesh.local(t).contiguous()

    params, losses, evals = fit_batch(
        model, emb, mine(targets),
        None if init is None else {k: mine(v) for k, v in init.items()},
        **steps)
    params = {k: mesh.all_gather(v)[:n] for k, v in params.items()}
    counts = mesh.all_gather(torch.tensor([evals], device=model.device))
    return (params, mesh.all_gather(losses)[:n],
            tuple(int(c) for c in counts.max(dim=0).values))


def fit_batch(model: FlameModel, emb: LandmarkEmbedding, targets, init=None, *,
              stage1_steps: int = 30, stage2_steps: int = 60, mesh=None):
    """Fit FLAME to [N, 51, 2] target landmarks; all N frames at once on the
    model's device, the objective evaluated through the landmark-anchor
    vertices (``restrict_to_landmarks``).

    init: optional dict of [N, ...] arrays {trans, rot, pose, shape, exp}
    (e.g. from RingNet). Returns (params dict of [N, ...] tensors on the
    device, {trans, rot, pose, shape, exp, scale}; losses [N], each the
    loss at the start of the last stage-2 step; the (stage 1, stage 2)
    counts of objective evaluations).

    A frame's result depends on its own target and init and not on the
    other frames of its chunk (only the rounding of the products may change
    with the chunk's size), so a session may be cut into chunks of any size
    (the JAX package pads chunks to shapes it has compiled; nothing here
    needs that). ``mesh`` (``parallel/mesh.py``): the frames split over its
    ranks (the last one repeated up to a multiple of their number), each
    rank fitting its share on its model's device; every rank returns all
    N frames' results and the most evaluations a rank made.
    """
    if mesh is not None:
        return _fit_split(model, emb, targets, init, mesh,
                          stage1_steps=stage1_steps, stage2_steps=stage2_steps)
    device = model.device
    emb = emb.to(device)
    if not isinstance(model, RestrictedFlame):
        model, emb = restrict_to_landmarks(model, emb)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
    params = zero_params(model, targets.shape[0], init)
    params["scale"] = init_scale(model, emb, params, targets)

    # stage 1: rigid alignment (scale, trans, rot)
    def loss1(p_rigid):
        return _lmk_dist(model, emb, {**params, **p_rigid}, targets)

    p_rigid, _, evals1 = _solve(loss1, {k: params[k] for k in ("scale", "trans", "rot")},
                                stage1_steps)
    params.update(p_rigid)

    # stage 2: everything (trans constrained to xy, flame.py:151)
    trans_z = params["trans"][:, 2:]

    def loss2(p_all):
        merged = dict(p_all)
        merged["trans"] = torch.cat([p_all["trans"][:, :2], trans_z], dim=1)
        return _lmk_dist(model, emb, merged, targets) + _regularizers(merged)

    params, final_loss, evals2 = _solve(loss2, params, stage2_steps)
    params["trans"] = torch.cat([params["trans"][:, :2], trans_z], dim=1)
    return params, final_loss, (evals1, evals2)


def fit_to_vertices(model: FlameModel, target_vertices, *, n_steps: int = 80,
                    weights: dict | None = None, batch_frames: int = 256):
    """Fit FLAME params to target meshes: the role of the reference's VOCA
    ``MeshFitter`` (voca.py:27-123) and of the missing
    ``feature_extraction.mesh_utils.get_flame_parameters_for_objs`` used by
    the segment tooling (get_data_segments.py:28-36), converting e.g. VOCA
    lipsync vertex sequences into FLAME parameter sequences.

    target_vertices: [N, V, 3], fitted in chunks of ``batch_frames`` meshes
    on the model's device. Returns (params dict of [N, ...] tensors {shape,
    exp, jaw, neck, trans}, losses [N]).
    """
    device = model.device
    w = {"expr": 1e-4, "jaw": 1e-4, "neck": 1e-3, "shape": 1e-4}
    if weights:
        w.update(weights)
    targets = torch.as_tensor(target_vertices, dtype=torch.float32)
    n_expr = model.shapedirs.shape[-1] - 300

    def loss_of(target):
        def loss(p):
            verts = flame_vertices(model, p["shape"], p["exp"], p["jaw"],
                                   p["neck"]) + p["trans"][:, None]
            # row-major [N, V, 3]: the sums over vertices take one order
            # whatever the chunk's size
            sq = ((verts - target) ** 2).contiguous()
            data = torch.mean(sq.sum(dim=-1), dim=-1)
            reg = (w["expr"] * torch.sum(p["exp"] ** 2, dim=1)
                   + w["jaw"] * torch.sum(p["jaw"] ** 2, dim=1)
                   + w["neck"] * torch.sum(p["neck"] ** 2, dim=1)
                   + w["shape"] * torch.sum(p["shape"] ** 2, dim=1))
            return data + reg
        return loss

    chunks = []
    for lo in range(0, targets.shape[0], batch_frames):
        target = targets[lo:lo + batch_frames].to(device)
        n = target.shape[0]
        params = {k: torch.zeros((n, width), device=device)
                  for k, width in (("shape", 300), ("exp", n_expr), ("jaw", 3),
                                   ("neck", 3), ("trans", 3))}
        params, losses, _ = _solve(loss_of(target), params, n_steps)
        chunks.append((params, losses))
    params = {k: torch.cat([c[0][k] for c in chunks]) for k in chunks[0][0]}
    return params, torch.cat([c[1] for c in chunks])


def openface_targets(csv_rows) -> np.ndarray:
    """OpenFace rows -> [N, 51, 2] targets: cols 299:435 reshaped (2, 68),
    transposed, jaw contour (first 17) dropped, y flipped to 1024 - y
    (flame.py:51-53, 282-284)."""
    out = []
    for row in csv_rows:
        lm = np.array([float(x) for x in row[299:435]]).reshape(2, -1).T[17:]
        lm[:, 1] = IMAGE_HEIGHT - lm[:, 1]
        out.append(lm)
    return np.asarray(out, np.float32)


def read_openface_targets(part_dir, fps: int) -> np.ndarray:
    with open(Path(part_dir) / f"openface_{fps}fps.csv") as f:
        rows = list(csv.reader(f))[1:]
    return openface_targets(rows)


def fit_participant(part_dir, fps: int, model, emb, *, batch_frames: int = 256,
                    stage1_steps: int = 30, stage2_steps: int = 60) -> dict:
    """One participant directory's frames fitted from its OpenFace CSV (and
    ``ringnet_{fps}fps.h5`` as init where that file exists, read with
    ``h5py``), in chunks of ``batch_frames`` on the model's device: the
    arrays of ``flame_{fps}fps.h5``, {tf_trans, tf_rot, tf_pose, tf_shape,
    tf_exp} of [N, ...] numpy."""
    part_dir = Path(part_dir)
    if not isinstance(model, RestrictedFlame):
        # hoist the anchor-vertex gather out of the chunk loop
        model, emb = restrict_to_landmarks(model, emb.to(model.device))
    targets = read_openface_targets(part_dir, fps)

    init = None
    ringnet_file = part_dir / f"ringnet_{fps}fps.h5"
    if ringnet_file.exists():
        import h5py

        with h5py.File(ringnet_file, "r") as f:
            fp = f["flame_params"]
            init = {"rot": fp["pose"][:, :3], "pose": np.pad(
                        fp["pose"][:, 3:6], ((0, 0), (3, 6))),
                    "shape": fp["shape"][()], "exp": fp["expression"][()]}

    results = {f"tf_{k}": [] for k in FIT_KEYS}
    for lo in range(0, targets.shape[0], batch_frames):
        hi = lo + batch_frames
        chunk_init = ({k: v[lo:hi] for k, v in init.items()}
                      if init else None)
        params, _, _ = fit_batch(model, emb, targets[lo:hi], chunk_init,
                                 stage1_steps=stage1_steps,
                                 stage2_steps=stage2_steps)
        for key in FIT_KEYS:
            results[f"tf_{key}"].append(params[key].cpu().numpy())
    return {k: np.concatenate(v, axis=0) for k, v in results.items()}


def fit_session_participant(part_dir, fps: int, *, model=None, emb=None,
                            flame_model_path=None,
                            landmark_embedding_path=None,
                            batch_frames: int = 256,
                            stage1_steps: int = 30, stage2_steps: int = 60,
                            device="cuda"):
    """Produce ``flame_{fps}fps.h5`` for one participant directory from its
    OpenFace CSV (+ optional RingNet init), the batched replacement for the
    reference's extract_flame (flame.py:244-303): ``fit_participant`` on
    ``device`` (a given model is moved there; needs ``h5py``)."""
    import h5py

    device = resolve_device(device)
    if model is None:
        model = load_flame(flame_model_path, device)
    if emb is None:
        emb = load_landmark_embedding(landmark_embedding_path, model.faces,
                                      device)
    results = fit_participant(part_dir, fps, model.to(device), emb.to(device),
                              batch_frames=batch_frames,
                              stage1_steps=stage1_steps,
                              stage2_steps=stage2_steps)
    out_file = Path(part_dir) / f"flame_{fps}fps.h5"
    with h5py.File(out_file, "w") as f:
        for key, data in results.items():
            f.create_dataset(key, data=data)
    return out_file
