"""Train the facial-gesture flow on the GPU.

    python -m lets_face_it_tpu_torch.train HPARAMS [--synthetic-data]
        [--max_steps N] [--batch_size B] [--max_epochs E] [--seed S]
        [--ckpt_dir DIR] [--dataset_root DIR] [--resume_from CKPT]
        [--log_dir DIR] [--stall_timeout_s S] [--render_url URL]
        [--device_data_cache auto|on|off] [--device cuda]

HPARAMS is a YAML config (``hparams/final_model.yaml``, or an unmodified
reference one). ``--synthetic-data`` trains on the synthetic corpus built in
memory from ``--seed`` (``data/synthetic.py``) instead of the HDF5 store
``DATASET_ROOT/Data.file_name``. Metrics go to stdout as JSON lines;
checkpoints (``<step>/checkpoint.pt``, loadable by ``Generator.from_checkpoint``) to
``--ckpt_dir``; TensorBoard event files to ``--log_dir`` when given.
``--stall_timeout_s`` exits with code 17 when no step completes for that long
(``utils/watchdog.py``), so that ``tools/supervise_train.py`` can relaunch the
command with ``--resume_from``. ``--render_url`` posts the validation's
generated sequence to a render service when ``Validation.render`` is on.
``--device_data_cache`` keeps the splits on the device and gathers batches
there (default ``auto``: on the card when they fit). ``--device cpu`` runs the
plain PyTorch versions of the kernels.
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
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus, train
    from lets_face_it_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    overrides = {k: getattr(args, k) for k in ("batch_size", "max_epochs",
                                                "stall_timeout_s",
                                                "device_data_cache")
                 if getattr(args, k) is not None}
    hp = load_hparams(args.hparams_file, dataset_root=args.dataset_root,
                      overrides=overrides)
    corpus = synthetic_corpus(hp, args.seed) if args.synthetic_data else None
    ckpt_dir = args.ckpt_dir or str(Path("checkpoints") / Path(args.hparams_file).stem)
    render_client = None
    if args.render_url and hp.Validation.get("render", False):
        from lets_face_it_tpu_torch.train.render_client import RenderClient

        render_client = RenderClient(args.render_url, hp)
    _, best_val = train(hp, seed=args.seed, ckpt_dir=ckpt_dir, log_dir=args.log_dir,
                        max_steps=args.max_steps, device=args.device,
                        corpus=corpus, resume_from=args.resume_from,
                        render_client=render_client)
    print(f"training done; best val_loss = {best_val:.4f}; checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
