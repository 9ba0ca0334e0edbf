"""Generate facial-gesture sequences from a checkpoint on the GPU.

    python -m lets_face_it_tpu_torch.generate --ckpt CKPT [--hparams H.yaml]
        [--dataset_root DIR] [--frames packed.npy] [--out generated.npy]
        [--eps 1.0] [--seed 0] [--seq_len 100] [--device cuda]

CKPT is a reference PyTorch-Lightning ``.ckpt`` or a ``torch.save``d state
dict in the reference's parameter names. ``--frames`` is a packed [T, 273]
matrix (layout in ``sample/generate.py``); without it a random conditioning
sequence is synthesized from ``--seed``. ``--device cpu`` runs the plain
PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--hparams", default=None)
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--frames", default=None)
    parser.add_argument("--out", default="generated.npy")
    parser.add_argument("--eps", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seq_len", type=int, default=100,
                        help="length of the synthesized smoke sequence")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np

    from lets_face_it_tpu_torch.sample.generate import Generator

    gen = Generator.from_checkpoint(args.ckpt, hparams_file=args.hparams,
                                    dataset_root=args.dataset_root,
                                    device=args.device)
    if args.frames:
        frames = np.load(args.frames)
    else:
        rng = np.random.default_rng(args.seed)
        frames = rng.standard_normal((args.seq_len, 273)).astype(np.float32)
        print(f"no --frames given; synthesized random conditioning "
              f"[{args.seq_len}, 273]")

    out = gen.generate(frames, eps=args.eps, seed=args.seed)
    np.save(args.out, out)
    print(f"generated {out.shape} -> {args.out} "
          f"(frames {out.shape[1]}, packed 106-D face layout)")


if __name__ == "__main__":
    main()
