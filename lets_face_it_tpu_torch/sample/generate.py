"""Model-space generation: checkpoint + packed frame matrix -> de-standardized
106-D face sequences (the port of ``lets_face_it_tpu/sample/generate.py``).

Packed 273-D frame layout (generate_motion_from_model.py:73-87):
  [0:106]    p1 face  (expression at 0, jaw at 100, neck at 103)
  [106:136]  p1 speech (26 mfcc + 4 prosody)
  [136:242]  p2 face  (same block layout offset by 136)
  [242:272]  p2 speech
  [272]      frame_nb
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.data.windows import (face_means_stds,
                                                 load_standardization)
from lets_face_it_tpu_torch.hparams import HParams, load_hparams
from lets_face_it_tpu_torch.model import seqglow
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.sample.weights import model_from_reference
from lets_face_it_tpu_torch.utils.device import resolve_device
from lets_face_it_tpu_torch.utils.misc import get_face_indicies


def dictify_frames(frames: np.ndarray, data_hparams: dict) -> dict:
    """[T, 273] packed rows -> modality dict (un-batched)."""
    exp, jaw, neck = (data_hparams["expression_dim"], data_hparams["jaw_dim"],
                      data_hparams["neck_dim"])
    speech = data_hparams["speech_dim"]
    left = get_face_indicies(exp, jaw, neck)
    right = get_face_indicies(exp, jaw, neck, offset=136)
    return {
        "p1_face": frames[:, left],
        "p1_speech": frames[:, 106:106 + speech],
        "p2_face": frames[:, right],
        "p2_speech": frames[:, 242:242 + speech],
    }


def expand_face_dim(seq: np.ndarray, data_hparams: dict) -> np.ndarray:
    """[B, T, exp+jaw+neck] -> [B, T, 106] packed layout
    (generate_motion_from_model.py:39-51)."""
    exp, jaw, neck = (data_hparams["expression_dim"], data_hparams["jaw_dim"],
                      data_hparams["neck_dim"])
    out = np.zeros((seq.shape[0], seq.shape[1], 106), seq.dtype)
    out[:, :, :exp] = seq[:, :, :exp]
    out[:, :, 100:100 + jaw] = seq[:, :, exp:exp + jaw]
    out[:, :, 103:103 + neck] = seq[:, :, exp + jaw:exp + jaw + neck]
    return out


class Generator:
    """A model on one device plus standardization stats, ready for repeated
    sampling. ``model`` is moved to ``device``."""

    def __init__(self, hp: HParams, model: SeqGlow, *, device="cuda"):
        self.device = resolve_device(device)
        self.hp = hp
        self.spec = FlowSpec.build(hp)
        self.model = model.to(self.device).eval()
        self.rng = torch.Generator(device=self.device)
        data_file = Path(hp.dataset_root) / hp.Data["file_name"]
        if data_file.exists():
            import h5py   # only with a feature store; GPU hosts may lack it

            with h5py.File(data_file, "r") as f:
                means, stds = load_standardization(f)
            self.face_means, self.face_stds = face_means_stds(
                means, stds, hp.Data["expression_dim"])
        else:
            c = self.spec.channels
            self.face_means = np.zeros(c, np.float32)
            self.face_stds = np.ones(c, np.float32)

    @classmethod
    def from_checkpoint(cls, ckpt_path, hparams_file=None, dataset_root=None,
                        overrides=None, *, device="cuda") -> "Generator":
        """Load a reference PyTorch-Lightning ``.ckpt`` or a ``torch.save``d
        state_dict in the reference's names (``sample/weights.py``). The
        hparams come from ``hparams_file`` or else from the checkpoint.
        Orbax checkpoint directories belong to the JAX package."""
        device = resolve_device(device)
        ckpt_path = Path(ckpt_path)
        if ckpt_path.is_dir():
            raise ValueError(f"{ckpt_path} is a directory (an orbax checkpoint "
                             "of the JAX package?); the port loads .ckpt/.pt files")
        # Lightning checkpoints pickle their hparams object
        payload = torch.load(ckpt_path, map_location="cpu",
                             weights_only=ckpt_path.suffix != ".ckpt")
        state = payload.get("state_dict", payload)
        if hparams_file is not None:
            hp = load_hparams(hparams_file, dataset_root=dataset_root,
                              overrides=overrides)
        else:
            raw_hp = payload.get("hparams", payload.get("hyper_parameters"))
            if raw_hp is None:
                raise ValueError("checkpoint carries no hparams; pass hparams_file")
            d = dict(raw_hp)
            if dataset_root is not None:
                d["dataset_root"] = str(dataset_root)
            d.setdefault("dataset_root", str(Path.cwd() / "dataset"))
            hp = HParams(**d)
            hp.config_name = ckpt_path.name
        model = model_from_reference(state, FlowSpec.build(hp))
        return cls(hp, model, device=device)

    def standardize_face(self, x):
        return (np.asarray(x) - self.face_means) / self.face_stds

    def generate(self, frames: np.ndarray, *, eps: float | None = None,
                 seed: int = 0, use_zero_pose: bool = True,
                 z=None) -> np.ndarray:
        """Packed [T, 273] frames -> generated [1, T - history, 106] faces.

        Mirrors generate_motion (generate_motion_from_model.py:54-70): the
        own-face seed history is zeroed (or standardized ground truth),
        interlocutor modalities standardized, the flow sampled with
        ``Infer.eps``, the output de-standardized and re-expanded to the
        106-D layout. The latents are ``randn * eps`` from ``self.rng``
        seeded with ``seed``, unless ``z`` [T - history, 1, C] is given.
        """
        eps = self.hp.Infer["eps"] if eps is None else eps
        data = dictify_frames(np.asarray(frames, np.float32), self.hp.Data)

        p1_face = self.standardize_face(data["p1_face"])
        if use_zero_pose:
            p1_face = np.zeros_like(p1_face)
        cond = {
            "p1_face": p1_face,
            "p2_face": self.standardize_face(data["p2_face"]),
            "p1_speech": data["p1_speech"],
            "p2_speech": data["p2_speech"],
        }
        cond = {k: torch.as_tensor(np.asarray(v, np.float32)[None],
                                   device=self.device) for k, v in cond.items()}
        self.rng.manual_seed(seed)
        out = seqglow.sequence_sample(
            self.spec, self.model, cond, frames.shape[0], eps_std=float(eps),
            generator=self.rng, z_seq=z)
        destd = out.cpu().numpy() * self.face_stds + self.face_means
        return expand_face_dim(destd, self.hp.Data)


def generate_motion(frames, model_path, hparams_file=None, dataset_root=None,
                    eps: float = 1.0, seed: int = 0, *,
                    device="cuda") -> np.ndarray:
    """One-shot convenience mirroring the reference entry point."""
    gen = Generator.from_checkpoint(model_path, hparams_file=hparams_file,
                                    dataset_root=dataset_root, device=device)
    return gen.generate(frames, eps=eps, seed=seed)
