"""RingNet-lite in PyTorch (the port of
``lets_face_it_tpu/features/ringnet_lite.py``): a landmark-driven FLAME
initialisation stage.

The reference seeds its expensive per-frame FLAME landmark fit with RingNet,
a licensed TF1 image-regression network run frame by frame
(/root/reference/code/feature_extraction/ringnet.py:96-158). The network
itself cannot be redistributed, so this module provides the same *pipeline
role* (a ``ringnet_{fps}fps.h5`` initialisation consumed by
``flame_fit.fit_session_participant``) from data the pipeline already has:
the OpenFace 2-D landmarks.

Two batched L-BFGS solves (``features/lbfgs.py``), both small next to the
main fit:

1. **Per-frame rigid init**: (scale, trans, rot) of the *neutral* face
   against each frame's 51 landmarks, all frames of a chunk at once (the
   same stage-1 objective as flame_fit, fewer steps).
2. **Session-level shared shape**: one solve of a single shape vector
   against a subsample of frames (rigid params frozen), a batch of one
   problem whose loss averages over the frames: a participant has ONE
   face, so shape evidence accumulates across frames instead of being
   re-regressed per frame.

Output layout matches the reference RingNet HDF5 exactly,
``flame_params/{cam, pose, shape, expression}`` with pose = [global-rot(3),
jaw(3)], so the true RingNet remains a drop-in replacement
(features/external.py documents that contract).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.features import flame_fit
from lets_face_it_tpu_torch.render.flame import _pad_to, load_flame
from lets_face_it_tpu_torch.utils.device import resolve_device


def estimate_init(model, emb, targets, *, rigid_steps: int = 25,
                  shape_steps: int = 40, shape_frames: int = 32,
                  shape_dims: int = 100, batch_frames: int = 256):
    """Landmark-driven FLAME init for [N, 51, 2] targets, on the model's
    device.

    Returns a dict of numpy arrays: scale [N], trans [N, 3], rot [N, 3],
    shape [N, shape_dims] (the shared session shape broadcast per frame,
    RingNet file-layout style), exp [N, 50] zeros.
    """
    device = model.device
    emb = emb.to(device)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
    n = targets.shape[0]
    # landmark-anchor-restricted evaluation: same objective, ~30x smaller
    # tensors (see flame_fit.RestrictedFlame)
    if not isinstance(model, flame_fit.RestrictedFlame):
        model, emb = flame_fit.restrict_to_landmarks(model, emb)

    def rigid_fit(target):
        base = flame_fit.zero_params(model, target.shape[0])
        base["scale"] = flame_fit.init_scale(model, emb, base, target)

        def loss(p_rigid):
            return flame_fit._lmk_dist(model, emb, {**base, **p_rigid}, target)

        p_rigid, _, _ = flame_fit._solve(
            loss, {k: base[k] for k in ("scale", "trans", "rot")}, rigid_steps)
        return p_rigid

    # chunk the solve like flame_fit.fit_session_participant: a real
    # session has tens of thousands of frames, and each L-BFGS step
    # materialises per-frame FLAME vertex intermediates
    chunks = [rigid_fit(targets[lo:lo + batch_frames])
              for lo in range(0, n, batch_frames)]
    rigid = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    # shared shape over an even subsample of frames
    idx = np.unique(np.linspace(0, n - 1, min(shape_frames, n)).astype(int))
    idx_t = torch.as_tensor(idx, device=device)
    sub_t = targets[idx_t]
    sub = flame_fit.zero_params(model, len(idx))
    sub.update({k: v[idx_t] for k, v in rigid.items()})

    def shape_loss(p):
        frames = dict(sub, shape=_pad_to(p["shape"], 300).expand(len(idx), 300))
        data = torch.mean(flame_fit._lmk_dist(model, emb, frames, sub_t))
        return (data + flame_fit.WEIGHTS["shape"]
                * torch.sum(p["shape"] ** 2, dim=1))

    p, _, _ = flame_fit._solve(
        shape_loss, {"shape": torch.zeros((1, shape_dims), device=device)},
        shape_steps)
    shape = p["shape"][0].cpu().numpy()

    return {
        "scale": rigid["scale"].cpu().numpy(),
        "trans": rigid["trans"].cpu().numpy(),
        "rot": rigid["rot"].cpu().numpy(),
        "shape": np.tile(shape[None], (n, 1)),
        "exp": np.zeros((n, 50), np.float32),
    }


def write_ringnet_h5(path, est) -> Path:
    """Write the reference RingNet HDF5 layout (ringnet.py:141-158):
    flame_params/{cam, pose, shape, expression}; pose = [rot | jaw]
    (needs ``h5py``)."""
    import h5py

    path = Path(path)
    n = est["rot"].shape[0]
    pose = np.concatenate([est["rot"], np.zeros((n, 3), np.float32)], axis=1)
    cam = np.stack([est["scale"], est["trans"][:, 0], est["trans"][:, 1]],
                   axis=1).astype(np.float32)
    with h5py.File(path, "w") as f:
        f["flame_params/cam"] = cam
        f["flame_params/pose"] = pose.astype(np.float32)
        f["flame_params/shape"] = est["shape"].astype(np.float32)
        f["flame_params/expression"] = est["exp"].astype(np.float32)
    return path


def extract_ringnet_lite(part_dir, fps: int, *, model=None, emb=None,
                         flame_model_path=None, landmark_embedding_path=None,
                         device="cuda", **estimate_kwargs) -> Path:
    """Idempotent per-participant driver: openface_{fps}fps.csv ->
    ringnet_{fps}fps.h5 (skipped if present, like every reference feature
    stage, e.g. ringnet.py:104-107), fitted on ``device``."""
    part_dir = Path(part_dir)
    out = part_dir / f"ringnet_{fps}fps.h5"
    if out.exists():
        return out
    device = resolve_device(device)
    if model is None:
        model = load_flame(flame_model_path, device)
    if emb is None:
        emb = flame_fit.load_landmark_embedding(landmark_embedding_path,
                                                model.faces, device)
    targets = flame_fit.read_openface_targets(part_dir, fps)
    est = estimate_init(model.to(device), emb.to(device), targets, **estimate_kwargs)
    return write_ringnet_h5(out, est)
