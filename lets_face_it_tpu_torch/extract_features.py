"""Feature-extraction pipeline of the port: dyadic session recordings ->
``lets_face_it.h5`` (the counterpart of the root ``extract_features.py``).

    python -m lets_face_it_tpu_torch.extract_features --dataset_dir DIR \\
        --splits data/train_val_test.json [--fps 25] \\
        [--stages video,audio,openface,ringnet,voca,flame,combine] \\
        [--output FILE] [--device cuda]

ffmpeg stages stay subprocess IO; the audio features (prosody, MFCC, VAD)
run as whole-utterance batches on ``--device``; FLAME landmark fitting runs
as a batched L-BFGS over the frames of each chunk there; the heavyweight
external stages have in-framework defaults with documented drop-in file
interfaces for the originals: RingNet -> landmark-driven init
(``features/ringnet_lite.py``), VOCA -> envelope lipsync
(``features/lipsync.py``), OpenFace -> docker adapter. ``--device cpu``
runs everything on the CPU; the default needs a CUDA device and raises
without one.

Every stage is idempotent (it checks for its output and skips), so the
pipeline is resumable at file granularity, like the reference.

Layout expected under --dataset_dir:
    <session>/audio_c1_c2.wav        stereo session recording  (or
    <session>/<P1|P2>/audio.wav      pre-split per-participant audio)
    <session>/<P1|P2>/video.mp4      per-participant video (any fps)
    <session>/<P1|P2>/frames_{fps}fps.txt   frame count, for runs without video

The FLAME stages read ``[flame].model_path_generic`` and
``.static_landmark_embedding_path`` from ``config.toml``; they skip, with a
log line, when those files are absent, and any error while loading them
propagates. Each ``stage_*`` takes ``assets=(FlameModel, LandmarkEmbedding)``
to run on a model the caller built.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from lets_face_it_tpu_torch.utils.device import resolve_device

ALL_STAGES = ("video", "audio", "openface", "ringnet", "voca", "flame",
              "combine")
FLAME_ASSETS = {
    "model_path_generic": "models/flame_model/FLAME2019/generic_model.pkl",
    "static_landmark_embedding_path":
        "models/flame_model/flame_static_embedding.pkl",
}


def log(msg: str):
    print(f"[extract_features] {msg}", flush=True)


def stage_video(sessions, fps):
    from lets_face_it_tpu_torch.features import video

    if not video.have_ffmpeg():
        log("video stage: ffmpeg not found — skipping (provide "
            "video_{fps}fps.mp4 files directly)")
        return
    for session in sessions:
        for part_dir in (session / "P1", session / "P2"):
            src = part_dir / "video.mp4"
            if not src.exists():
                continue
            dst = part_dir / f"video_{fps}fps.mp4"
            video.convert_video_to_fps(src, dst, fps)
            video.extract_images(dst, part_dir / "images")
            log(f"video: {dst}")


def _frame_count(part_dir, fps) -> int | None:
    """Frames for this participant: ffprobe of the resampled video, or a
    sidecar ``frames_{fps}fps.txt`` for video-less (audio-only) runs."""
    sidecar = part_dir / f"frames_{fps}fps.txt"
    if sidecar.exists():
        return int(sidecar.read_text().strip())
    video_file = part_dir / f"video_{fps}fps.mp4"
    if video_file.exists():
        from lets_face_it_tpu_torch.features.video import count_video_frames

        return count_video_frames(video_file)
    return None


def stage_audio(sessions, fps, *, device="cuda"):
    from lets_face_it_tpu_torch.features import audio_io, mfcc, prosody, vad

    for session in sessions:
        stereo = next(iter(session.glob("*c1_c2.wav")), None)
        if stereo is not None:
            audio_io.split_audio_channels(stereo, session)

        frame_counts = {}
        for part in ("P1", "P2"):
            part_dir = session / part
            wav_file = part_dir / "audio.wav"
            if not wav_file.exists():
                continue
            nb_frames = _frame_count(part_dir, fps)
            if nb_frames is None:
                log(f"audio: no frame count for {part_dir} — skipping")
                continue
            frame_counts[part] = nb_frames
            fs, samples = audio_io.read_wav(wav_file)

            audio_io.chunk_audio_file(wav_file, part_dir / "audio_chunks")

            pros_file = part_dir / f"prosodic_features_{fps}fps.npy"
            if not pros_file.exists():
                feats = prosody.extract_prosodic_features(samples, fs, nb_frames,
                                                          device=device)
                np.save(pros_file, feats.cpu().numpy())
                log(f"prosody: {pros_file}")

            mfcc_file = part_dir / f"mfcc_{fps}fps.npy"
            if not mfcc_file.exists():
                # reference feeds raw int16-scale samples to psf mfcc
                feats = mfcc.extract_mfcc_to_frames(samples * 32768.0, fs,
                                                    nb_frames, device=device)
                np.save(mfcc_file, feats.cpu().numpy())
                log(f"mfcc: {mfcc_file}")

        p1_vad = session / "P1" / f"crosstalk_vad_{fps}fps.npy"
        p2_vad = session / "P2" / f"crosstalk_vad_{fps}fps.npy"
        if (len(frame_counts) == 2 and not p1_vad.exists()
                and not p2_vad.exists()):
            if frame_counts["P1"] != frame_counts["P2"]:
                raise ValueError(f"{session.name}: P1 has {frame_counts['P1']} "
                                 f"frames, P2 {frame_counts['P2']}")
            fs1, x1 = audio_io.read_wav(session / "P1" / "audio.wav")
            fs2, x2 = audio_io.read_wav(session / "P2" / "audio.wav")
            if fs1 != fs2:
                raise ValueError(f"{session.name}: sample rates {fs1} and {fs2}")
            s1, s2 = vad.crosstalk_vad(x1, x2, fs1, frame_counts["P1"],
                                       device=device)
            np.save(p1_vad, s1.cpu().numpy())
            np.save(p2_vad, s2.cpu().numpy())
            log(f"vad: {session.name}")


def stage_openface(sessions, fps):
    from lets_face_it_tpu_torch.features import external

    for session in sessions:
        for part in ("P1", "P2"):
            part_dir = session / part
            video_file = part_dir / f"video_{fps}fps.mp4"
            out_csv = part_dir / f"openface_{fps}fps.csv"
            if out_csv.exists() or not video_file.exists():
                continue
            try:
                external.extract_openface(video_file, out_csv, fps)
                log(f"openface: {out_csv}")
            except external.StageUnavailable as exc:
                log(str(exc))
                return


def _flame_paths() -> tuple[str, str]:
    """config.toml's [flame] model and landmark-embedding paths."""
    from lets_face_it_tpu_torch.config import load_config

    flame_cfg = {**FLAME_ASSETS, **load_config().get("flame", {})}
    return (flame_cfg["model_path_generic"],
            flame_cfg["static_landmark_embedding_path"])


def _present(path) -> bool:
    return bool(path) and Path(path).exists()


def _flame_assets(device):
    """(FlameModel, LandmarkEmbedding) on ``device`` from config.toml's
    [flame] paths, or None with a log line when the asset files are absent
    (the stages are independently resumable). An error while loading them
    propagates."""
    from lets_face_it_tpu_torch.features import flame_fit
    from lets_face_it_tpu_torch.render.flame import load_flame

    model_path, emb_path = _flame_paths()
    if not (_present(model_path) and _present(emb_path)):
        log("flame assets not found ([flame].model_path_generic / "
            ".static_landmark_embedding_path in config.toml) — skipping")
        return None
    model = load_flame(model_path, device)
    return model, flame_fit.load_landmark_embedding(emb_path, model.faces, device)


def stage_ringnet(sessions, fps, *, device="cuda", assets=None):
    """FLAME initialisation for the fitter. A real RingNet drop-in
    (features/external.py contract) takes precedence: this stage skips any
    participant whose ``ringnet_{fps}fps.h5`` already exists and otherwise
    estimates the init from the OpenFace landmarks (features/ringnet_lite.py)."""
    from lets_face_it_tpu_torch.features import ringnet_lite

    assets = assets or _flame_assets(device)
    if assets is None:
        return
    model, emb = assets
    for session in sessions:
        for part in ("P1", "P2"):
            part_dir = session / part
            out = part_dir / f"ringnet_{fps}fps.h5"
            if (out.exists()
                    or not (part_dir / f"openface_{fps}fps.csv").exists()):
                continue
            ringnet_lite.extract_ringnet_lite(part_dir, fps, model=model,
                                              emb=emb, device=device)
            log(f"ringnet(-lite): {out}")


def stage_flame(sessions, fps, *, device="cuda", assets=None):
    """Landmark fits of every participant, 256 frames a chunk on one
    device."""
    from lets_face_it_tpu_torch.features import flame_fit

    assets = assets or _flame_assets(device)
    if assets is None:
        return
    model, emb = assets
    for session in sessions:
        for part in ("P1", "P2"):
            part_dir = session / part
            out_h5 = part_dir / f"flame_{fps}fps.h5"
            csv_file = part_dir / f"openface_{fps}fps.csv"
            if out_h5.exists() or not csv_file.exists():
                continue
            flame_fit.fit_session_participant(
                part_dir, fps, model=model, emb=emb, batch_frames=256,
                device=device)
            log(f"flame: {out_h5}")


def stage_voca(dataset_dir, fps, *, device="cuda", assets=None):
    """Lipsync meshes per participant (reference voca.py:180-202), with the
    built-in envelope articulation model on the FLAME model; plug the real
    VOCA via features/lipsync.extract_voca(model=...). Then the meshes'
    per-frame FLAME parameters, in the layout the stimulus tooling reads
    (stimulus.get_vocas:
    Sessions_50fps_voca/<session>/<participant>/flame_params/<frame>.npy)."""
    from lets_face_it_tpu_torch.features.lipsync import (EnvelopeLipsync,
                                                         extract_voca,
                                                         voca_to_flame_params)
    from lets_face_it_tpu_torch.render.flame import load_flame

    if assets is not None:
        flame_model = assets[0].to(resolve_device(device))
    else:
        flame_path = _flame_paths()[0]
        if not _present(flame_path):
            log("voca stage: [flame].model_path_generic not found — "
                "skipping")
            return
        flame_model = load_flame(flame_path, device)
    model = EnvelopeLipsync(flame_model)
    for f in extract_voca(dataset_dir, fps, model=model):
        log(f"voca: {f}")
    for mesh_file in sorted(Path(dataset_dir).glob(f"*/*/voca_mesh_{fps}fps.npy")):
        participant = mesh_file.parent
        out_dir = (Path(dataset_dir) / "Sessions_50fps_voca"
                   / participant.parent.name / participant.name)
        if (out_dir / "flame_params").is_dir():
            continue
        voca_to_flame_params(np.load(mesh_file), model.model, out_dir)
        log(f"voca flame_params: {out_dir}")


def stage_combine(dataset_dir, splits_file, fps, output):
    from lets_face_it_tpu_torch.features import combine

    if output.exists():
        log(f"combine: {output} exists — skipping")
        return
    validate_splits_dir(splits_file)
    spec = combine.load_split_spec(splits_file)
    combine.combine_features(dataset_dir, output, spec, fps=fps,
                             progress=lambda s, n: log(f"combine {s}/{n}"))
    log(f"combine: wrote {output}")


def validate_splits_dir(splits_file):
    """Schema-check the dataset-definition JSONs next to the splits file
    before spending hours in the pipeline (``data/validate_jsons.py``);
    exits on schema errors in the splits file, logs the rest as warnings."""
    from lets_face_it_tpu_torch.data.validate_jsons import validate_data_dir

    errors, warnings, _ = validate_data_dir(Path(splits_file).parent,
                                            splits_file=splits_file)
    # The combine stage consumes ONLY the splits file; schema errors in
    # optional sibling JSONs (annotations.json, meta_data.json, ...) must
    # not block an otherwise valid combine run, so they become warnings.
    # Every finding is prefixed with its source file's name (either
    # "name: msg" or "name['key']...: msg"; match on the bare name).
    splits_name = Path(splits_file).name
    blocking = [e for e in errors if e.startswith(splits_name)]
    warnings = warnings + [e for e in errors if e not in blocking]
    for w in warnings:
        log(f"data-json WARNING: {w}")
    if blocking:
        for e in blocking:
            log(f"data-json ERROR: {e}")
        sys.exit(f"{len(blocking)} splits-file schema error(s); see "
                 "python -m lets_face_it_tpu_torch.data.validate_jsons")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--splits", default=None,
                        help="train_val_test.json (required for combine)")
    parser.add_argument("--output", default=None,
                        help="combined HDF5 path (default <dataset_dir>/lets_face_it.h5)")
    parser.add_argument("--fps", type=int, default=25)
    parser.add_argument("--stages", default=",".join(ALL_STAGES))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    dataset_dir = Path(args.dataset_dir)
    sessions = sorted(p for p in dataset_dir.iterdir() if p.is_dir())
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = set(stages) - set(ALL_STAGES)
    if unknown:
        sys.exit(f"unknown stages: {sorted(unknown)}; valid: {ALL_STAGES}")
    log(f"{len(sessions)} sessions, stages: {stages}, device: {device}")

    if "video" in stages:
        stage_video(sessions, args.fps)
    if "audio" in stages:
        stage_audio(sessions, args.fps, device=device)
    if "openface" in stages:
        stage_openface(sessions, args.fps)
    if "ringnet" in stages:
        stage_ringnet(sessions, args.fps, device=device)
    if "voca" in stages:
        stage_voca(dataset_dir, args.fps, device=device)
    if "flame" in stages:
        stage_flame(sessions, args.fps, device=device)
    if "combine" in stages:
        if not args.splits:
            sys.exit("--splits is required for the combine stage")
        output = Path(args.output or dataset_dir / "lets_face_it.h5")
        stage_combine(dataset_dir, args.splits, args.fps, output)


if __name__ == "__main__":
    main()
