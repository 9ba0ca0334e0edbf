"""Training at precision 16 against precision 32: the convergence A/B of the
port (the counterpart of ``tools/precision_ab.py``).

    python -m lets_face_it_tpu_torch.precision_ab [--max_steps 5000]
        [--batch_size 256] [--steps_per_dispatch 1] [--n_train_chunks 400]
        [--frames_per_chunk 400] [--out runs/precision_ab_torch.json]
        [--device cuda]

Both arms train ``hparams/final_model.yaml`` from the same seed on the same
synthetic corpus, built in memory (``data/synthetic.py``; 400 train chunks of
400 frames, 8 val, 2 test, as the JAX tool's fixture): one at ``precision:
32`` (float32 products), one at ``precision: 16`` (bf16 operands in every
product of the kernels, float32 sums; eager products at torch's "medium").
Each validates at the end of every epoch and at the last step; the val-NLL
curves, the differences at the shared validation steps and the card's name
and power limit go to the JSON (``tests/test_torch_precision_ab.py`` reads
it). The arms run one after the other in this process: ``train`` sets and
restores the ambient precision itself.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SEED = 1234


def card_name(device) -> str:
    """``name, power limit`` of the card (nvidia-smi), or the device type."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run_arm(precision: int, *, max_steps: int, batch_size: int, corpus,
            device, steps_per_dispatch: int = 1) -> dict:
    """One arm: ``final_model`` at ``precision`` for ``max_steps`` steps ->
    {"precision", "curve": [{"step", "val_loss"}], "steps_per_sec" (host
    clock between the first and the last step), "wall_s"}."""
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.train.loop import train

    hp = load_hparams(REPO / "hparams" / "final_model.yaml", overrides={
        "precision": precision, "batch_size": batch_size, "max_epochs": 100000,
        "steps_per_dispatch": steps_per_dispatch, "logger": False})
    curve, marks = [], {}

    def on_step(step, _metrics):
        marks.setdefault("first", (step, time.perf_counter()))
        marks["last"] = (step, time.perf_counter())

    t0 = time.perf_counter()
    train(hp, seed=SEED, max_steps=max_steps, device=device, corpus=corpus,
          verbose=False, step_hook=on_step,
          val_hook=lambda step, m: curve.append(
              {"step": int(step), "val_loss": round(float(m["val_loss"]), 2)}))
    (s0, t_first), (s1, t_last) = marks["first"], marks["last"]
    return {"precision": precision, "curve": curve,
            "steps_per_sec": (s1 - s0) / (t_last - t_first) if s1 > s0 else None,
            "wall_s": round(time.perf_counter() - t0, 1)}


def summarize(arms: dict) -> dict:
    """The differences of the bf16 arm's val NLL from the f32 arm's at their
    shared validation steps (positive: bf16 higher, worse)."""
    f32c = {r["step"]: r["val_loss"] for r in arms["f32"]["curve"]}
    bf16c = {r["step"]: r["val_loss"] for r in arms["bf16"]["curve"]}
    shared = sorted(set(f32c) & set(bf16c))
    if not shared:
        raise ValueError("the arms share no validation step")
    deltas = {s: bf16c[s] - f32c[s] for s in shared}
    last = shared[-1]
    sps = (arms["f32"]["steps_per_sec"], arms["bf16"]["steps_per_sec"])
    return {
        "shared_val_steps": len(shared),
        "final_step": last,
        "final_val_f32": f32c[last],
        "final_val_bf16": bf16c[last],
        "final_delta_bits": round(deltas[last], 2),
        "max_abs_delta_bits": round(max(abs(d) for d in deltas.values()), 2),
        "final_delta_relative": round(deltas[last] / max(abs(f32c[last]), 1e-9), 5),
        "delta_relative_by_step": {str(s): round(d / max(abs(f32c[s]), 1e-9), 5)
                                   for s, d in deltas.items()},
        "throughput_ratio_bf16_over_f32": (round(sps[1] / sps[0], 3)
                                           if all(sps) else None),
    }


def run(*, max_steps: int, batch_size: int = 256, n_train_chunks: int = 400,
        frames_per_chunk: int = 400, n_val_chunks: int = 8,
        steps_per_dispatch: int = 1, device="cuda") -> dict:
    """Both arms on one synthetic corpus -> the artifact's dictionary."""
    from lets_face_it_tpu_torch.data.synthetic import dims_for, make_synthetic_corpus
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    hp = load_hparams(REPO / "hparams" / "final_model.yaml")
    corpus = make_synthetic_corpus(seed=SEED, dims=dims_for(hp.Data),
                                   n_train_chunks=n_train_chunks,
                                   n_val_chunks=n_val_chunks,
                                   n_test_chunks=2,
                                   frames_per_chunk=frames_per_chunk)
    arms = {}
    for precision, name in ((32, "f32"), (16, "bf16")):
        arms[name] = run_arm(precision, max_steps=max_steps,
                             batch_size=batch_size, corpus=corpus, device=device,
                             steps_per_dispatch=steps_per_dispatch)
        print(json.dumps({"arm": name, **arms[name]}), flush=True)
    return {"config": "final_model", "batch_size": batch_size, "seed": SEED,
            "max_steps": max_steps, "steps_per_dispatch": steps_per_dispatch,
            "fixture": f"synthetic {n_train_chunks} chunks x {frames_per_chunk} "
                       f"frames, {n_val_chunks} val, 2 test (data/synthetic.py, "
                       "in memory)",
            "card": card_name(device), "summary": summarize(arms), "arms": arms}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--max_steps", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--n_train_chunks", type=int, default=400)
    p.add_argument("--frames_per_chunk", type=int, default=400)
    p.add_argument("--out", default=str(REPO / "runs" / "precision_ab_torch.json"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(max_steps=args.max_steps, batch_size=args.batch_size,
              n_train_chunks=args.n_train_chunks,
              frames_per_chunk=args.frames_per_chunk,
              steps_per_dispatch=args.steps_per_dispatch, device=args.device)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")
    print(json.dumps(out["summary"], indent=1))


if __name__ == "__main__":
    main()
