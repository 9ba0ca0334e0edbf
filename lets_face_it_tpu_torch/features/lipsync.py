"""Lipsync extraction: the VOCA stage (reference voca.py:126-202) rebuilt;
the port of ``lets_face_it_tpu/features/lipsync.py``.

The reference runs two TF1 graphs — DeepSpeech audio features into the VOCA
decoder — to produce per-frame lipsync meshes on each participant's neutral
template, resampled to the video frame count and saved as
``voca_mesh_{fps}fps.npy``. Those graphs need externally-licensed weights, so
here the *inference model* is pluggable:

* pass any callable ``(audio [S], sample_rate, template_vertices [V, 3]) ->
  meshes [N, V, 3]`` (e.g. a wrapper around the real VOCA docker image —
  the drop-in contract of features/external.py:83-91);
* or use :class:`EnvelopeLipsync` (default), a dependency-free articulation
  model that drives the FLAME jaw and mouth expression from the smoothed
  speech envelope. It is not a learned lipsync, but produces plausible,
  audio-locked mouth motion — and the consuming pipeline scales lipsync by
  VAD activity anyway (generate_test_sequences.py:27-48).

``voca_to_flame_params`` then converts lipsync meshes into the per-frame
FLAME-parameter files that the stimulus tooling reads
(``Sessions_50fps_voca/<session>/<participant>/flame_params/<frame>.npy``,
the role of the reference's MeshFitter, voca.py:27-123).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.render.flame import flame_vertices


class EnvelopeLipsync:
    """Audio-envelope-driven jaw/mouth articulation on a FLAME model.

    Per output frame: jaw pitch = ``jaw_gain`` x the normalized smoothed
    speech envelope (faster attack than release, like real articulation),
    plus a small envelope-derivative term on the first expression components
    to add lip pre-motion. Output meshes are FLAME evaluations of those
    params on the given template, on the FLAME model's device, returned as
    numpy.
    """

    def __init__(self, flame_model, *, out_fps: float = 60.0,
                 jaw_gain: float = 0.28, exp_gain: float = 0.35,
                 attack_ms: float = 40.0, release_ms: float = 120.0,
                 full_scale_rms: float = 0.05):
        self.model = flame_model
        self.out_fps = out_fps
        self.jaw_gain = jaw_gain
        self.exp_gain = exp_gain
        self.attack_ms = attack_ms
        self.release_ms = release_ms
        # absolute envelope level (for audio in [-1, 1]) that maps to a
        # fully-open jaw: keeps amplitudes consistent across the separately
        # processed audio chunks, and stops quiet/noise-only chunks from
        # being peak-normalized up to full articulation
        self.full_scale_rms = full_scale_rms

    def params_for_audio(self, audio, sample_rate: float) -> dict:
        """{jaw [N, 3], exp [N, n_expr]} at ``out_fps`` frames."""
        x = np.asarray(audio, np.float64)
        if x.ndim > 1:
            x = x.mean(axis=1)
        n_frames = max(int(round(len(x) / sample_rate * self.out_fps)), 1)

        # per-frame RMS envelope
        hop = max(int(sample_rate / self.out_fps), 1)
        pad = (-len(x)) % hop
        frames = np.pad(x, (0, pad)).reshape(-1, hop)
        env = np.sqrt((frames ** 2).mean(axis=1))
        env = env[:n_frames]
        if len(env) < n_frames:
            env = np.pad(env, (0, n_frames - len(env)))

        # asymmetric smoothing: jaw opens fast, closes slower
        a_att = np.exp(-1000.0 / (self.attack_ms * self.out_fps))
        a_rel = np.exp(-1000.0 / (self.release_ms * self.out_fps))
        smooth = np.empty_like(env)
        prev = 0.0
        for i, e in enumerate(env):
            a = a_att if e > prev else a_rel
            prev = a * prev + (1.0 - a) * e
            smooth[i] = prev
        openness = np.clip(smooth / self.full_scale_rms, 0.0, 1.0)

        n_expr = int(self.model.shapedirs.shape[-1]) - 300
        jaw = np.zeros((n_frames, 3), np.float32)
        jaw[:, 0] = self.jaw_gain * openness          # pitch-open
        exp = np.zeros((n_frames, n_expr), np.float32)
        lip_drive = (np.gradient(openness) * self.out_fps / 10.0
                     if len(openness) > 1 else np.zeros_like(openness))
        exp[:, 0] = self.exp_gain * openness
        exp[:, 1] = self.exp_gain * np.clip(lip_drive, -1.0, 1.0)
        return {"jaw": jaw, "exp": exp}

    @torch.no_grad()
    def __call__(self, audio, sample_rate: float, template_vertices):
        p = self.params_for_audio(audio, sample_rate)
        n = p["jaw"].shape[0]
        dev = self.model.device

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        verts = flame_vertices(
            self.model, zeros(n, 300), torch.as_tensor(p["exp"], device=dev),
            torch.as_tensor(p["jaw"], device=dev), zeros(n, 3))
        # re-center onto the provided template (participant-specific shape)
        base = flame_vertices(self.model, zeros(1, 300),
                              zeros(1, p["exp"].shape[1]), zeros(1, 3),
                              zeros(1, 3))
        offset = torch.as_tensor(template_vertices, dtype=torch.float32,
                                 device=dev) - base[0]
        return (verts + offset[None]).cpu().numpy()


def extract_voca(dataset_dir, fps: int, *, model, nb_frames_lookup=None):
    """Per-participant lipsync meshes, the reference extract_voca driver
    (voca.py:180-202): run the model over ``audio_chunks/*.wav`` (falling
    back to ``audio.wav``), vstack, resample to the participant's video frame
    count, save ``voca_mesh_{fps}fps.npy``. Idempotent per participant.

    ``model``: callable (audio, sample_rate, template_vertices) -> [N, V, 3].
    ``nb_frames_lookup``: optional ``{participant_dir_name: n_frames}``; when
    absent the frame count comes from the sidecar ``frames_{fps}fps.txt``
    that video-less runs carry (as the CLI's audio stage reads it), else
    from ffprobe on ``video_{fps}fps.mp4``.
    """
    from scipy.signal import resample

    from lets_face_it_tpu_torch.features.audio_io import read_wav
    from lets_face_it_tpu_torch.render.flame import read_ply

    out_files = []
    for participant in sorted(Path(dataset_dir).glob("*/*")):
        voca_file = participant / f"voca_mesh_{fps}fps.npy"
        neutral_mesh = participant / "neutral_mesh.ply"
        if voca_file.exists() or not neutral_mesh.exists():
            continue
        template, _ = read_ply(neutral_mesh)

        chunks = sorted((participant / "audio_chunks").glob("*.wav"))
        if not chunks:
            single = participant / "audio.wav"
            if not single.exists():
                continue
            chunks = [single]

        meshes = []
        for wav in chunks:
            sample_rate, audio = read_wav(wav)
            meshes.append(model(audio, sample_rate, template))
        all_meshes = np.vstack(meshes)

        sidecar = participant / f"frames_{fps}fps.txt"
        if nb_frames_lookup and participant.name in nb_frames_lookup:
            nb_frames = int(nb_frames_lookup[participant.name])
        elif sidecar.exists():
            nb_frames = int(sidecar.read_text().strip())
        else:
            from lets_face_it_tpu_torch.features.video import count_video_frames

            nb_frames = count_video_frames(participant / f"video_{fps}fps.mp4")
        np.save(voca_file, resample(all_meshes, nb_frames).astype(np.float32))
        out_files.append(voca_file)
    return out_files


def voca_to_flame_params(voca_meshes, flame_model, out_dir, frame_offset=1,
                         *, n_steps: int = 40):
    """Fit FLAME params to each lipsync mesh and write the per-frame
    ``flame_params/<frame>.npy`` dict files the stimulus tooling consumes
    (stimulus.get_vocas; reference mesh_utils role, voca.py:27-123).

    voca_meshes: [N, V, 3], fitted in chunks of 256 meshes on the FLAME
    model's device. Files are named by 1-based frame number
    (``frame_offset`` shifts the start).
    """
    from lets_face_it_tpu_torch.features.flame_fit import fit_to_vertices

    params, _ = fit_to_vertices(flame_model, voca_meshes, n_steps=n_steps)
    params = {k: v.cpu().numpy() for k, v in params.items()}
    out = Path(out_dir) / "flame_params"
    out.mkdir(parents=True, exist_ok=True)
    n = params["jaw"].shape[0]
    files = []
    for i in range(n):
        pose = np.zeros((1, 12), np.float32)
        pose[0, 3:6] = params["jaw"][i]
        d = {"tf_pose": pose,
             "tf_exp": params["exp"][i][None].astype(np.float32),
             "tf_shape": params["shape"][i][None].astype(np.float32),
             "tf_rot": np.zeros((1, 3), np.float32),
             "tf_trans": params["trans"][i][None].astype(np.float32)}
        f = out / f"{frame_offset + i:06d}.npy"
        np.save(f, d, allow_pickle=True)
        files.append(f)
    return files
