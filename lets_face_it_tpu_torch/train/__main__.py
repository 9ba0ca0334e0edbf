"""Train the facial-gesture flow on the GPU.

    python -m lets_face_it_tpu_torch.train HPARAMS [--synthetic-data]
        [--max_steps N] [--batch_size B] [--max_epochs E] [--seed S]
        [--ckpt_dir DIR] [--dataset_root DIR] [--resume_from CKPT]
        [--log_dir DIR] [--stall_timeout_s S] [--render_url URL]
        [--device_data_cache auto|on|off] [--precision 32|16]
        [--steps_per_dispatch K] [--wire_dtype f32|bf16] [--profile_dir DIR]
        [--debug_nans] [--device cuda] [--dist_backend nccl|gloo]
    torchrun --nproc_per_node=N -m lets_face_it_tpu_torch.train HPARAMS ...

HPARAMS is a YAML config (``hparams/final_model.yaml``, or an unmodified
reference one). ``--synthetic-data`` trains on the synthetic corpus built in
memory from ``--seed`` (``data/synthetic.py``) instead of the HDF5 store
``DATASET_ROOT/Data.file_name``. Metrics go to stdout as JSON lines;
checkpoints (``<step>/checkpoint.pt``, loadable by ``Generator.from_checkpoint``) to
``--ckpt_dir``; TensorBoard event files to ``--log_dir`` when given.
``--stall_timeout_s`` exits with code 17 when no step completes for that long
(``utils/watchdog.py``), so that ``python -m
lets_face_it_tpu_torch.supervise_train`` can relaunch the command with
``--resume_from``. ``--render_url`` posts the validation's
generated sequence to a render service when ``Validation.render`` is on.
``--device_data_cache`` keeps the splits on the device and gathers batches
there (default ``auto``: on the card when they fit). ``--precision 16``
trains, and validates, with bf16 operands in every product of the kernels
(float32 sums), the JAX trainer's production mode; 32 (the default) in
float32. ``--steps_per_dispatch K`` runs K optimizer steps as one CUDA graph
over the device data cache (it needs the cache). ``--wire_dtype bf16``
uploads the host-gathered batches as bf16 (cache off). ``--profile_dir``
writes a ``torch.profiler`` trace of the first steps there. ``--device cpu``
runs the plain PyTorch versions of the kernels. Under ``torchrun`` the
run is data-parallel over its ranks (``parallel/mesh.py``): one process a
GPU over NCCL (gloo on the CPU, or with ``--dist_backend gloo``, which also
runs several ranks on one card), ``--batch_size`` the global batch; rank 0
validates, logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("hparams_file")
    parser.add_argument("--synthetic-data", action="store_true",
                        help="train on the synthetic corpus built from --seed")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--ckpt_dir", default=None,
                        help="default: checkpoints/<config name>")
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--resume_from", default=None,
                        help="checkpoint file, or a directory of them")
    parser.add_argument("--log_dir", default=None,
                        help="TensorBoard directory (default: none)")
    parser.add_argument("--stall_timeout_s", type=float, default=None,
                        help="exit 17 when no step completes for this long; "
                             "arms after the first step. Size it above a "
                             "validation pass")
    parser.add_argument("--render_url", default=None,
                        help="render-service URL for validation videos "
                             "(e.g. http://localhost:8000)")
    parser.add_argument("--device_data_cache", default=None,
                        choices=("auto", "on", "off"))
    parser.add_argument("--precision", type=int, default=None, choices=(16, 32),
                        help="override the config's precision: 32 = float32 "
                             "products, 16 = bf16 operands with float32 sums")
    parser.add_argument("--steps_per_dispatch", type=int, default=None,
                        help="optimizer steps per CUDA graph replay; needs "
                             "the device data cache")
    parser.add_argument("--wire_dtype", default=None, choices=("f32", "bf16"),
                        help="host-to-device batch format of the host gather "
                             "(the values rounded to bf16, widened on the "
                             "device)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the first "
                             "training steps into this directory")
    parser.add_argument("--debug_nans", action="store_true",
                        help="stop at the first non-finite loss or gradient "
                             "norm (the reference's terminate_on_nan); "
                             "synchronises every step")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                        help="under torchrun: the collectives' backend "
                             "(default nccl on the card, gloo on the CPU)")
    args = parser.parse_args(argv)

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.parallel.mesh import mesh_from_environment
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus, train
    from lets_face_it_tpu_torch.utils.precision import training_precision
    from lets_face_it_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    mesh = mesh_from_environment(args.device, args.dist_backend)
    overrides = {k: getattr(args, k) for k in ("batch_size", "max_epochs",
                                                "stall_timeout_s",
                                                "device_data_cache", "precision",
                                                "steps_per_dispatch", "wire_dtype")
                 if getattr(args, k) is not None}
    if args.debug_nans:
        overrides["terminate_on_nan"] = True
    hp = load_hparams(args.hparams_file, dataset_root=args.dataset_root,
                      overrides=overrides)
    training_precision(hp)
    corpus = synthetic_corpus(hp, args.seed) if args.synthetic_data else None
    ckpt_dir = args.ckpt_dir or str(Path("checkpoints") / Path(args.hparams_file).stem)
    render_client = None
    if args.render_url and hp.Validation.get("render", False):
        from lets_face_it_tpu_torch.train.render_client import RenderClient

        render_client = RenderClient(args.render_url, hp)
    _, best_val = train(hp, seed=args.seed, ckpt_dir=ckpt_dir, log_dir=args.log_dir,
                        max_steps=args.max_steps, device=args.device,
                        corpus=corpus, resume_from=args.resume_from,
                        render_client=render_client, profile_dir=args.profile_dir,
                        mesh=mesh)
    if mesh is None or mesh.is_main:
        print(f"training done; best val_loss = {best_val:.4f}; "
              f"checkpoints in {ckpt_dir}")
    if mesh is not None:
        import torch.distributed

        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
