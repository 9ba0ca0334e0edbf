"""Every step's gate of the negative-NLL trick over a Table-1 run (the
counterpart of ``tools/trick_gate_probe.py``).

    python -m lets_face_it_tpu_torch.trick_gate_probe [--device cuda]
        [--max_steps 900] [--val_every 100] [--out runs/trick_gate_probe_torch.json]

A step takes the deranged branch iff its coin < 0.1 and
``last_mismatched_nll > 0``, and a fired step sets ``last_mismatched_nll``
to -(its NLL) (reference lets_face_it_glow.py:38-53, ``train/state.py``).
The gate therefore closes only once a deranged batch's NLL reaches >= 0:
on a corpus the model fits well (NLL < 0 bits) it stays open, and about a
tenth of the steps keep doing gradient ascent on mismatched conditioning
after the val optimum.

This probe trains ``final_model`` as ``ablation_table1.py`` does (B=64,
precision 16, StepLR every 300 epochs, the seed-1234 fixture in memory)
with a step loop of its own on ``train/state.py::train_step``, batches in
the loop's order (``np.random.default_rng([1234, epoch])``, shuffled, the
last partial batch dropped). Each step records its ``deranged`` flag, its
NLL and loss, its coin, and whether the gate was open before it; the gate
variable is a device scalar, read once after each step (one host read a
step). The coin is drawn here, as ``train_step`` would draw it, and handed
in, so that the step's ``deranged`` flag (the device's select) can be held
against coin < 0.1 and the gate read before the step. Every
``val_every`` steps: the val NLL of the first val batch and its p2 gap
(``train/metrics.py::wrong_context_probes``). The JSON holds the per-100-step
windows, the validations and the summary, as the JAX tool writes them
(``tests/test_torch_trick_gate.py`` pins them).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np

from lets_face_it_tpu_torch.ablation_table1 import (FIXTURE, GAP_KEY, MATMUL, SEED,
                                                    index_batches, require_kernels,
                                                    table1_hparams)

REPO = Path(__file__).resolve().parent.parent
WINDOW = 100


def gate_steps(*, max_steps: int, device="cuda", corpus=None, val_every: int = 100,
               hp=None):
    """Train ``final_model`` (or ``hp``) with the Table-1 settings for
    ``max_steps`` steps, one ``train_step`` at a time -> (per-step records
    {deranged, nll, loss, coin, gate_open (the gate variable read after the
    step before, > 0), last (the gate variable after it)}, validations
    [{step, val_loss, gap_p2}], the final TrainState)."""
    import torch

    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.model.seqglow import SeqGlow
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.train import state as train_state
    from lets_face_it_tpu_torch.train.loop import (load_datasets, synthetic_corpus,
                                                   to_device)
    from lets_face_it_tpu_torch.train.metrics import wrong_context_probes
    from lets_face_it_tpu_torch.utils.device import resolve_device
    from lets_face_it_tpu_torch.utils.precision import (matmul_precision,
                                                        training_precision)

    device = resolve_device(device)
    if hp is None:
        hp = load_hparams(REPO / "hparams" / "final_model.yaml")
    hp = table1_hparams(hp)
    spec = FlowSpec.build(hp)
    require_kernels(spec)
    train_ds, val_ds = load_datasets(hp, corpus if corpus is not None
                                     else synthetic_corpus(hp, SEED))
    steps_per_epoch = max(train_ds.num_batches(hp.batch_size, drop_last=True), 1)
    model = SeqGlow.init(spec, torch.Generator().manual_seed(SEED)).to(device)
    state = train_state.TrainState.create(model, hp, steps_per_epoch, SEED)
    batches = index_batches(train_ds, hp.batch_size, SEED)
    val_batch = to_device(next(val_ds.epoch_batches(hp.batch_size, shuffle=False)),
                          device)

    @torch.no_grad()
    def validate(step):
        _, loss, _ = seqglow.sequence_nll(spec, state.model, val_batch)
        probes = wrong_context_probes(spec, state.model, val_batch, loss, hp.Mismatch,
                                      torch.Generator().manual_seed(step))
        return {"step": step, "val_loss": round(float(loss), 2),
                "gap_p2": round(float(probes[GAP_KEY]), 3)}

    per_step, validations, last = [], [], math.inf
    with matmul_precision(training_precision(hp)):
        for i in range(max_steps):
            batch = to_device(train_ds.get_batch(next(batches)), device)
            if i == 0:
                train_state.run_actnorm_init(spec, state, batch)
            x = batch["p1_face"]
            draws = train_state.draw_step(spec, state, state.global_batch(x.shape[0]),
                                          x.shape[1] - spec.cond.longest_history)
            m = train_state.train_step(spec, hp, state, batch, draws=draws)
            row = {k: float(m[k]) for k in ("deranged", "nll", "loss")}
            row["coin"], row["gate_open"] = draws.coin, last > 0
            last = row["last"] = float(state.last_mismatched_nll)
            per_step.append(row)
            if (i + 1) % val_every == 0:
                validations.append(validate(i + 1))
                v = validations[-1]
                rate = np.mean([r["deranged"] for r in per_step[-WINDOW:]])
                print(f"step {i + 1}: val {v['val_loss']:.1f} gap {v['gap_p2']:+.2f} "
                      f"fire_rate(last {WINDOW}) {rate:.3f}", flush=True)
    return per_step, validations, state


def summarize(per_step: list, validations: list) -> tuple[dict, list]:
    """(summary, per-100-step windows) in the JAX tool's schema."""
    windows = []
    for w0 in range(0, len(per_step), WINDOW):
        chunk = per_step[w0:w0 + WINDOW]
        dnlls = [r["nll"] for r in chunk if r["deranged"] > 0]
        windows.append({
            "steps": [w0 + 1, w0 + len(chunk)],
            "fire_rate": round(float(np.mean([r["deranged"] for r in chunk])), 3),
            "gate_open_frac": round(float(np.mean([r["gate_open"] for r in chunk])), 3),
            "deranged_nll_min": round(min(dnlls), 1) if dnlls else None,
            "deranged_nll_max": round(max(dnlls), 1) if dnlls else None,
        })
    dnlls = [r["nll"] for r in per_step if r["deranged"] > 0]
    best = min(validations, key=lambda r: r["val_loss"])
    last = validations[-1]
    summary = {
        "total_steps": len(per_step),
        "fired_steps": int(sum(r["deranged"] for r in per_step)),
        "fire_rate": round(float(np.mean([r["deranged"] for r in per_step])), 4),
        "gate_ever_closed": any(not r["gate_open"] for r in per_step),
        "any_deranged_nll_nonnegative": bool(dnlls and max(dnlls) >= 0),
        "deranged_nll_range": ([round(min(dnlls), 1), round(max(dnlls), 1)]
                               if dnlls else None),
        "best_val": best,
        "final_val": last,
        "post_optimum_regression_nats": round(last["val_loss"] - best["val_loss"], 1),
    }
    return summary, windows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--max_steps", type=int, default=900)
    p.add_argument("--val_every", type=int, default=100)
    p.add_argument("--out", default=str(REPO / "runs" / "trick_gate_probe_torch.json"))
    args = p.parse_args(argv)

    from lets_face_it_tpu_torch.bench import machine
    from lets_face_it_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    per_step, validations, _ = gate_steps(max_steps=args.max_steps, device=device,
                                          val_every=args.val_every)
    summary, windows = summarize(per_step, validations)
    out = {**machine(device), "config": "final_model", "batch_size": 64,
           "precision": 16, "matmul": MATMUL[16], "seed": SEED, "fixture": FIXTURE,
           "gate_reads": "last_mismatched_nll read on the host once a step, after it",
           "wall_s": round(time.perf_counter() - t0, 1),
           "summary": summary, "validations": validations, "windows": windows}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
