"""Hyperparameter search on the GPU (the port of the root ``tune.py``).

    python -m lets_face_it_tpu_torch.tune HPARAMS [-n N] [--max_steps N]
        [--synthetic-data] [--dataset_root DIR] [--seed S]
        [--study_dir tuning_studies] [--sampler tpe|random] [--workers K]
        [--no-subprocess] [--device cuda]

Searches the space registered for the config's stem in the root
``hparam_tuning_configs`` registry (plain Python): each trial trains in a
``spawn`` subprocess on ``--device`` with out-of-memory batch halving and
loss/jerk pruning (``train/tuning.py``); the study is a JSON file under
``--study_dir``. ``--synthetic-data`` trains every trial on the synthetic
corpus built in memory from ``--seed`` (``data/synthetic.py``) instead of
the HDF5 store ``DATASET_ROOT/Data.file_name``. ``--workers K`` runs K
worker processes against the same flock-guarded study, each ``-n`` trials
with its own sampler seed, K*n in all; workers on one host share its card.
``--device cpu`` trains on the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import multiprocessing
from pathlib import Path


def _run_worker(hparams_file, dataset_root, n_trials, max_steps, seed,
                study_dir, device, sampler, use_subprocess, synthetic):
    from hparam_tuning_configs import hparam_configs
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus
    from lets_face_it_tpu_torch.train.tuning import Study
    from lets_face_it_tpu_torch.utils.device import resolve_device

    resolve_device(device)
    conf_name = Path(hparams_file).stem
    if conf_name not in hparam_configs:
        raise SystemExit(f"no search space registered for {conf_name!r}; "
                         f"known: {sorted(hparam_configs)}")
    space_fn = hparam_configs[conf_name].hparam_options
    hp = load_hparams(hparams_file, dataset_root=dataset_root)
    corpus = synthetic_corpus(hp, seed) if synthetic else None
    study = Study(conf_name, study_dir)
    study.optimize(hp, space_fn, n_trials=n_trials, max_steps=max_steps,
                   seed=seed, use_subprocess=use_subprocess, sampler=sampler,
                   device=device, corpus=corpus)
    return study


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("hparams_file")
    parser.add_argument("-n", "--n_trials", type=int, default=10)
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--synthetic-data", action="store_true",
                        help="train the trials on the synthetic corpus built "
                             "from --seed")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--study_dir", default="tuning_studies")
    parser.add_argument("--sampler", choices=["tpe", "random"], default="tpe")
    parser.add_argument("--workers", type=int, default=1,
                        help="concurrent worker processes sharing the study")
    parser.add_argument("--no-subprocess", action="store_true",
                        help="run trials in-process (debugging)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    def worker_args(seed):
        return (args.hparams_file, args.dataset_root, args.n_trials,
                args.max_steps, seed, args.study_dir, args.device,
                args.sampler, not args.no_subprocess, args.synthetic_data)

    if args.workers > 1:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_run_worker,
                             args=worker_args(args.seed + 1009 * i))
                 for i in range(args.workers)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        if any(p.exitcode != 0 for p in procs):
            raise SystemExit("one or more tuning workers failed")
        from lets_face_it_tpu_torch.train.tuning import Study

        study = Study(Path(args.hparams_file).stem, args.study_dir)
    else:
        study = _run_worker(*worker_args(args.seed))
    best = study.best_trial

    print(f"finished trials: {len(study.trials)}; study in {study.path}")
    for t in study.trials:
        value = t.get("value")
        print(f"  trial #{t['number']}: {t['state']}"
              + ("" if value is None else f", val_loss={value:.4f}"))
    if best:
        print(f"best trial #{best['number']}: val_loss={best['value']:.4f}")
        for k, v in best["params"].items():
            print(f"    {k}: {v}")
    else:
        print("no completed trials")


if __name__ == "__main__":
    main()
