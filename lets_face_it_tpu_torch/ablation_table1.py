"""The paper's Table-1 signature on the port (the counterpart of
``tools/ablation_table1.py``).

    python -m lets_face_it_tpu_torch.ablation_table1 [--device cuda]
        [--max_steps 900] [--configs final_model,no_speech,no_face,no_nll_trick]
        [--seed 1234] [--seeds_extra 1235,1236] [--precision 16]
        [--permutations 1] [--replay PATH] [--reference PATH]
        [--out runs/ablation_table1_torch.json]

With the negative-NLL trick, deranging the interlocutor collapses the
likelihood; without it the model trains as well but the gap nearly vanishes
(Table 1: 400.51 matched against 235.22 mismatched with the trick, 386.98
against 386.54 without). In the logged convention the gap is
``mismatched_nll/shuffled_batch/p2`` = matched - deranged NLL, so a model
that listens reads strongly negative.

Each config trains on the small planted-mimicry synthetic corpus
(``data/synthetic.py``, seed 1234, in memory: 4 train chunks of 160
frames, 324 windows of 80, 5 steps of 64 an epoch) with the tool's
settings: B=64, precision 16, StepLR every 300 epochs, a validation every
20 epochs (steps 100, 200, ..., 900), no free-run inference or
invertibility check at validation. The loop's validation computes the
wrong-context probes on the first val batch (``train/loop.py::run_validation``);
the JAX tool recomputes them in its hook on the same batch. Each validation
adds (step, val_loss, gap_p2) to the config's curve, and the record keeps
the signed gap of largest size (``extreme_gap_p2``). ``--seeds_extra``
trains the pair the claims compare (``final_model``, ``no_nll_trick``) once
more for each seed given, on the same corpus, and reports each run's curve,
best validation and extreme gap: these runs show the spread; the claims
read the ``--seed`` run. ``--precision 32`` trains at "highest" instead (no
bf16 operands, no TF32), to tell rounding from the trajectory's own course.
``--permutations P`` > 1 also reads, at each validation, the p2 gap on the
same first val batch under P more permutations, the i-th seeded from
(step, i) (``Validation.gap_permutations``), into the row's
``gap_p2_perms``: whether one probe's sign is the permutation's or the
model's. The training is the same as with P = 1.

``--replay PATH`` trains each config from a replay file
(``train/replay.py``; ``{config}`` in PATH stands for the config's name,
and without it only one config may be given): the initial weights, every
step's draws and every validation's probe permutations are the file's
(the JAX package's seed-1234 start, as
``tests/test_torch_table1_replay.py --write`` exports it). Each record
then also says ``"start": "jax"``, names the file and its seed, and keeps
every step's ``deranged`` flag and NLL (``fired_steps``, numbered from 1
as the step hook numbers them; ``step_nll``, ``step_grad_norm``: one host
read a step). ``--reference PATH`` (a record
of the JAX tool, ``runs/ablation_table1_jax_cpu.json``) puts that record's
``val_loss`` and ``gap_p2`` beside each validation of the same step, with
the differences (port - reference).
``tests/test_torch_ablation_table1.py`` pins the claims.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ALL_CONFIGS = ("final_model", "no_speech", "no_face", "no_nll_trick")
PAIR = ("final_model", "no_nll_trick")
GAP_KEY = "mismatched_nll/shuffled_batch/p2"
SEED = 1234
FIXTURE = ("small synthetic (4 train chunks x 160 frames, planted mimicry lag 8; "
           "data/synthetic.py in memory, seed 1234)")
MATMUL = {16: ("precision 16: the kernels' product operands bf16 with float32 sums; "
               "the eager products at torch's 'medium' (TF32 on the card)"),
          32: "precision 32: every product in float32 ('highest'; no TF32)"}
TRAINED_KERNELS = ("cond_gates", "seq_fwd", "seq_bwd")


def table1_hparams(hp, val_every: int = 20, precision: int = 16,
                   permutations: int = 1):
    """The tool's settings on ``hp``, in place (tools/ablation_table1.py:56-66),
    with the wrong-context probes computed by the loop's validation (the p2
    gap under ``permutations`` more permutations when above 1)."""
    hp.batch_size = 64
    hp.precision = precision
    hp.max_epochs = 100000            # bounded by max_steps
    hp.check_val_every_n_epoch = val_every
    hp.Optim["Schedule"]["args"]["step"]["step_size"] = 300
    hp.Validation.update(inference=False, check_invertion=False,
                         wrong_context_test=True)
    if permutations > 1:
        hp.Validation["gap_permutations"] = permutations
    hp.logger = False
    return hp


def require_kernels(spec) -> None:
    """Raise unless ``spec`` trains on the kernels (never the plain path)."""
    from lets_face_it_tpu_torch.model import seqglow

    if seqglow.training_path(spec) != "kernels":
        raise RuntimeError(f"this spec would train on the plain path: {spec}")


def index_batches(ds, batch_size: int, seed: int):
    """``ds``'s index batches epoch after epoch in the loop's order: shuffled
    by ``np.random.default_rng([seed, epoch])``, the last partial batch
    dropped."""
    import numpy as np

    epoch = 0
    while True:
        rng = np.random.default_rng([seed, epoch])
        yield from ds.epoch_index_batches(batch_size, rng=rng, shuffle=True,
                                          drop_last=True)
        epoch += 1


def kernel_launches() -> dict:
    """The training kernels' launch counters."""
    from lets_face_it_tpu_torch.ops import train_kernels

    return {name: getattr(train_kernels, name).launches for name in TRAINED_KERNELS}


def extreme_gap(curve: list) -> float:
    """The curve's gap of largest size, with its sign."""
    return max((r["gap_p2"] for r in curve), key=abs)


def run_config(name: str, *, max_steps: int = 900, device="cuda", seed: int = SEED,
               corpus=None, val_every: int = 20, hp=None, precision: int = 16,
               permutations: int = 1, replay=None):
    """Train ``hparams/<name>.yaml`` (or ``hp``) with the tool's settings for
    ``max_steps`` steps on ``corpus`` (default: the seed-1234 fixture) ->
    (the config's record, the final TrainState). The record holds the
    curve of (step, val_loss, gap_p2, and with ``permutations`` > 1 the
    p2 gaps of the other permutations, gap_p2_perms), its best validation,
    its extreme gap,
    the training kernels' launches of the run and its steps per second: the
    steps between validations over the time from the first step's hook to
    the last one's, the device synchronised at both (the step's own hook
    does not wait for the card). With ``replay`` (a path), the run starts
    from the file's weights and takes its draws (``train(replay=)``), and
    the record also keeps each step's NLL, gradient norm and the steps that
    trained on the deranged batch."""
    import torch

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.train.loop import (PERM_GAP_KEY, load_datasets,
                                                   synthetic_corpus, train)

    if hp is None:
        hp = load_hparams(REPO / "hparams" / f"{name}.yaml")
    hp = table1_hparams(hp, val_every, precision, permutations)
    require_kernels(FlowSpec.build(hp))
    if corpus is None:
        corpus = synthetic_corpus(hp, SEED)
    train_ds, _ = load_datasets(hp, corpus)
    period = val_every * max(train_ds.num_batches(hp.batch_size, drop_last=True), 1)
    on_card = torch.device(device).type == "cuda"
    curve, windows = [], []
    start = None
    per_step = {"step_nll": [], "step_grad_norm": [], "fired_steps": []}
    if replay is not None:
        from lets_face_it_tpu_torch.train.replay import open_replay

        replay = open_replay(replay)

    def on_step(step, metrics):
        nonlocal start
        if replay is not None:
            per_step["step_nll"].append(float(metrics["nll"]))
            per_step["step_grad_norm"].append(float(metrics["grad_norm"]))
            if float(metrics["deranged"]) == 1.0:
                per_step["fired_steps"].append(int(step))
        if start is None or step % period == 0:
            if on_card:
                torch.cuda.synchronize()
            now = time.perf_counter()
            if start is None:
                start = (step, now)
            else:
                windows.append((step - start[0], now - start[1]))
                start = None

    def on_validation(step, metrics):
        nonlocal start
        row = {"step": int(step), "val_loss": float(metrics["val_loss"]),
               "gap_p2": float(metrics[GAP_KEY])}
        if permutations > 1:
            row["gap_p2_perms"] = [float(metrics[f"{PERM_GAP_KEY}{i}"])
                                   for i in range(permutations)]
        curve.append(row)
        start = None
        print(f"[{name} seed {seed}] step {step}: val_loss {row['val_loss']:.2f} "
              f"gap(p2) {row['gap_p2']:+.3f}", flush=True)

    before = kernel_launches()
    t0 = time.perf_counter()
    state, _ = train(hp, seed=seed, max_steps=max_steps, device=device,
                     corpus=corpus, verbose=False, step_hook=on_step,
                     val_hook=on_validation, replay=replay)
    wall = time.perf_counter() - t0
    record = {
        "config": name,
        "use_negative_nll_loss": bool(hp.Train.get("use_negative_nll_loss", False)),
        "max_steps": max_steps,
        "seed": seed,
        "precision": precision,
        "wall_s": round(wall, 1),
        "steps_per_sec": (sum(n for n, _ in windows) / sum(t for _, t in windows)
                          if windows else None),
        "curve": curve,
        "best_val": min(curve, key=lambda r: r["val_loss"]) if curve else None,
        "extreme_gap_p2": extreme_gap(curve) if curve else None,
        "launches": {k: n - before[k] for k, n in kernel_launches().items()},
    }
    if replay is not None:
        record.update({"start": "jax", "replay": replay.path.name,
                       "replay_seed": replay.seed, **per_step})
    return record, state


def beside_reference(record: dict, reference: dict) -> None:
    """Each validation of ``record`` with the reference record's
    ``val_loss`` and ``gap_p2`` at the same step and the differences
    (record - reference), in place; a step the reference lacks gets none."""
    ref = {r["step"]: r for r in reference["curve"]}
    for row in record["curve"]:
        if row["step"] in ref:
            want = ref[row["step"]]
            row.update({"ref_val_loss": want["val_loss"], "ref_gap_p2": want["gap_p2"],
                        "d_val_loss": row["val_loss"] - want["val_loss"],
                        "d_gap_p2": row["gap_p2"] - want["gap_p2"]})


def spread_row(record: dict) -> dict:
    """An extra seed's run of a config: its curve, best validation and
    extreme gap (signed)."""
    return {k: record[k] for k in ("best_val", "extreme_gap_p2", "curve", "wall_s",
                                   "steps_per_sec")}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--max_steps", type=int, default=900)
    p.add_argument("--configs", default=",".join(ALL_CONFIGS))
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--seeds_extra", default="",
                   help="comma-separated seeds for the final_model/no_nll_trick pair")
    p.add_argument("--precision", type=int, choices=sorted(MATMUL), default=16)
    p.add_argument("--permutations", type=int, default=1,
                   help="p2 gaps under this many more permutations a validation")
    p.add_argument("--replay", default=None,
                   help="train from this replay file ({config} for the config's name)")
    p.add_argument("--reference", default=None,
                   help="a JAX tool record to put beside each validation")
    p.add_argument("--out", default=str(REPO / "runs" / "ablation_table1_torch.json"))
    args = p.parse_args(argv)
    configs = args.configs.split(",")
    if args.replay and (args.seeds_extra or ("{config}" not in args.replay
                                             and len(configs) > 1)):
        raise SystemExit("--replay takes one file a config ({config} in the path) "
                         "and no --seeds_extra")
    reference = (json.loads(Path(args.reference).read_text())
                 if args.reference else None)

    from lets_face_it_tpu_torch.bench import machine
    from lets_face_it_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    results = {**machine(device), "precision": args.precision,
               "matmul": MATMUL[args.precision],
               "seed": args.seed, "fixture": FIXTURE, "gap_key": GAP_KEY,
               **({"permutations": args.permutations,
                   "permutation_seeds": "torch.Generator seeded step * 1000003 + i"}
                  if args.permutations > 1 else {}),
               "deviations": [
                   "the probes come from the loop's validation "
                   "(Validation.wrong_context_test on), not from a hook",
                   "the corpus is built in memory, not read from HDF5"],
               "configs": {}, "extra_seeds": {}}
    if args.precision == 16:
        results["deviations"].append(
            "precision 16's eager products run at TF32 on the card")
    if args.replay:
        results.update(start="jax", replay=Path(args.replay).name)
        results["deviations"].append(
            "the initial weights, the step draws and the probe permutations are "
            "the replay file's (the JAX package's), not the port's seeded "
            "generators")
    if reference is not None:
        results["reference"] = {"file": Path(args.reference).name,
                                "device": reference.get("device")}
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def save():   # partial results survive an interrupted later run
        out_path.write_text(json.dumps(results, indent=1) + "\n")

    for name in configs:
        print(f"=== {name} ===", flush=True)
        replay = args.replay.format(config=name) if args.replay else None
        record, _ = run_config(
            name, max_steps=args.max_steps, device=device, seed=args.seed,
            precision=args.precision, permutations=args.permutations,
            replay=replay)
        if reference is not None and name in reference["configs"]:
            beside_reference(record, reference["configs"][name])
        results["configs"][name] = record
        save()
    for seed in [int(s) for s in args.seeds_extra.split(",") if s]:
        for name in PAIR:
            print(f"=== {name}, seed {seed} ===", flush=True)
            record, _ = run_config(name, max_steps=args.max_steps, device=device,
                                   seed=seed, precision=args.precision,
                                   permutations=args.permutations)
            results["extra_seeds"].setdefault(str(seed), {})[name] = spread_row(record)
            save()
    print(f"wrote {out_path}")
    for name, r in results["configs"].items():
        b = r["best_val"]
        print(f"{name:14s} trick={r['use_negative_nll_loss']} best-val step "
              f"{b['step']}: val {b['val_loss']:.2f} gap(p2) {b['gap_p2']:+.3f}, "
              f"extreme {r['extreme_gap_p2']:+.3f}")
    for seed, rows in results["extra_seeds"].items():
        for name, r in rows.items():
            print(f"seed {seed} {name}: best {json.dumps(r['best_val'])}, "
                  f"extreme {r['extreme_gap_p2']:+.3f}")


if __name__ == "__main__":
    main()
