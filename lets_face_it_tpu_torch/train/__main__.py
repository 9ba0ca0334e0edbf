"""Train the facial-gesture flow on the GPU.

    python -m lets_face_it_tpu_torch.train HPARAMS [--synthetic-data]
        [--max_steps N] [--batch_size B] [--max_epochs E] [--seed S]
        [--ckpt_dir DIR] [--dataset_root DIR] [--resume_from CKPT]
        [--device cuda]

HPARAMS is a YAML config (``hparams/final_model.yaml``, or an unmodified
reference one). ``--synthetic-data`` trains on the synthetic corpus built in
memory from ``--seed`` (``data/synthetic.py``) instead of the HDF5 store
``DATASET_ROOT/Data.file_name``. Metrics go to stdout as JSON lines;
checkpoints (``step_<n>.pt``, loadable by ``Generator.from_checkpoint``) to
``--ckpt_dir``. ``--device cpu`` runs the plain PyTorch versions of the
kernels.
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
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus, train
    from lets_face_it_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    overrides = {k: getattr(args, k) for k in ("batch_size", "max_epochs")
                 if getattr(args, k) is not None}
    hp = load_hparams(args.hparams_file, dataset_root=args.dataset_root,
                      overrides=overrides)
    corpus = synthetic_corpus(hp, args.seed) if args.synthetic_data else None
    ckpt_dir = args.ckpt_dir or str(Path("checkpoints") / Path(args.hparams_file).stem)
    _, best_val = train(hp, seed=args.seed, ckpt_dir=ckpt_dir,
                        max_steps=args.max_steps, device=args.device,
                        corpus=corpus, resume_from=args.resume_from)
    print(f"training done; best val_loss = {best_val:.4f}; checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
