"""Evaluate a checkpoint on the test split on the GPU (the port of the root
``run_test.py``): NLL, free-running generation and the per-modality
mismatched probes, saved as one ``.npz``.

    python -m lets_face_it_tpu_torch.run_test --ckpt CKPT [--hparams H.yaml]
        [--dataset_root DIR] [--out results/test_results.npz] [--seq_len 100]
        [--batch_size B] [--max_batches N] [--seed S] [--synthetic-data]
        [--device cuda]

CKPT is a port checkpoint (``<step>/checkpoint.pt`` of the trainer) or a reference
Lightning ``.ckpt``, loaded through ``Generator.from_checkpoint``.
``--synthetic-data`` evaluates on the test split of the synthetic corpus built
in memory from ``--seed`` (``data/synthetic.py``, the corpus the trainer's
``--synthetic-data`` builds from the same seed) instead of the HDF5 store
``DATASET_ROOT/Data.file_name``; ``--seed`` also seeds the draws.
``--device cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True,
                        help="port .pt checkpoint or reference Lightning .ckpt")
    parser.add_argument("--hparams", default=None)
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--out", default="results/test_results.npz")
    parser.add_argument("--seq_len", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--synthetic-data", action="store_true",
                        help="evaluate on the synthetic corpus built from --seed")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from lets_face_it_tpu_torch.sample.generate import Generator
    from lets_face_it_tpu_torch.train.evaluate import run_test, summarize
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus

    gen = Generator.from_checkpoint(args.ckpt, hparams_file=args.hparams,
                                    dataset_root=args.dataset_root,
                                    device=args.device)
    hp = gen.hp
    if args.batch_size:
        hp.batch_size = args.batch_size
    hp.Test = {"seq_len": args.seq_len}
    corpus = synthetic_corpus(hp, args.seed) if args.synthetic_data else None
    results = run_test(hp, gen.model, output_file=args.out, seed=args.seed,
                       max_batches=args.max_batches, corpus=corpus)
    print(f"saved {len(results)} batch results -> {args.out}")
    for k, v in summarize(results).items():
        print(f"  {k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
