"""The production rehearsal on the card: ``final_model`` trained for epochs
at B=256, killed on purpose in the middle of an epoch and resumed from its
last epoch checkpoint under ``supervise_train``, its validation curve
extracted (the port's counterpart of the JAX record
``runs/long_run_curve.json``).

    python -m lets_face_it_tpu_torch.long_run [--run_dir runs/long_run]
        [--ckpt_dir checkpoints/long_run] [--max_epochs 12] [--kill_at_step 13000]
        [--resume_only] [--out runs/long_run_curve_torch.json]
        [--device cuda] [--stall_timeout_s 900] [worker options]
    python -m lets_face_it_tpu_torch.long_run --worker --ckpt_dir DIR
        [--resume_from DIR] [worker options]

The worker trains ``--hparams`` (``hparams/final_model.yaml``) through
``train/loop.py::train`` on the JAX rehearsal's fixture built in memory
(``data/synthetic.py``; the run needs no ``h5py``): 1,600 train
chunks of 400 frames, 321 windows of 80 a chunk, 2,006 steps of 256 an
epoch as in the record, and 160 val chunks, from corpus seed 1234. It
trains from seed 1234 at precision 32 (the record ran float32) with the
device data cache on and 8 steps a CUDA graph, validates and writes a
checkpoint at every epoch, and prints the loop's JSON lines on stdout,
and its own: ``{"long_run":
"start"}`` (the checkpoint it resumes from), one ``{"long_run":
"validation"}`` after each validation (the epoch's steps and seconds
between two synchronisations of the card, the validation's seconds, the
device memory and each kernel's launches so far) and ``{"long_run":
"done"}``. Every run takes the training kernels: a spec that would train
on the plain path raises.

The parent launches the worker under ``supervise_train.supervise`` with
its stdout in ``RUN_DIR/segment_<n>.log``. Once the log passes
``--kill_at_step`` (in the middle of an epoch), it sends the worker
SIGTERM; the supervisor counts that as the one crash it may retry and
relaunches the worker with ``--resume_from``. Where a run ended early (a
smaller ``--max_epochs``, a process or machine lost), ``--resume_only``
continues it from ``--ckpt_dir`` as a new segment, to ``--max_epochs``.
At the end the parent appends a
``{"long_run": "segment_end"}`` line (exit code, wall seconds) to each
segment's log and writes the curve of all segments with
``extract_val_curve`` to ``--out``, with notes that give the fixture, the
precision and k, the kill and the checkpoint the resume came from, and
each segment's steps a second and wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# The JAX rehearsal's fixture: 1,600 train chunks of 400 frames (2,006
# steps of 256 an epoch); its val chunks and corpus seed are not recorded.
N_TRAIN_CHUNKS, N_VAL_CHUNKS, N_TEST_CHUNKS = 1600, 160, 2
FRAMES_PER_CHUNK, CORPUS_SEED, SEED = 400, 1234, 1234
BATCH, PRECISION, K_DISPATCH, MAX_EPOCHS = 256, 32, 8, 12
GIB = 1024**3
# (flag, type, default) of the worker's options, which the parent passes on
WORKER_OPTIONS = (
    ("--hparams", str, str(REPO / "hparams" / "final_model.yaml")),
    ("--device", str, "cuda"),
    ("--batch_size", int, BATCH),
    ("--steps_per_dispatch", int, K_DISPATCH),
    ("--max_epochs", int, MAX_EPOCHS),
    ("--stall_timeout_s", float, 900.0),
    ("--n_train_chunks", int, N_TRAIN_CHUNKS),
    ("--n_val_chunks", int, N_VAL_CHUNKS),
    ("--frames_per_chunk", int, FRAMES_PER_CHUNK),
    ("--log_every", int, 10),
)


def emit(event: str, **kw) -> None:
    print(json.dumps({"long_run": event, **kw}), flush=True)


def rehearsal_hparams(args):
    """``args.hparams`` with the rehearsal's settings."""
    from lets_face_it_tpu_torch.hparams import load_hparams

    hp = load_hparams(args.hparams)
    hp.batch_size = args.batch_size
    hp.precision = PRECISION
    hp.steps_per_dispatch = args.steps_per_dispatch
    hp.device_data_cache = "on"
    hp.max_epochs = args.max_epochs
    hp.check_val_every_n_epoch = 1
    hp.stall_timeout_s = args.stall_timeout_s
    hp.logger = False
    return hp


def rehearsal_corpus(hp, args):
    from lets_face_it_tpu_torch.data.synthetic import dims_for, make_synthetic_corpus

    return make_synthetic_corpus(
        n_train_chunks=args.n_train_chunks, n_val_chunks=args.n_val_chunks,
        n_test_chunks=N_TEST_CHUNKS, frames_per_chunk=args.frames_per_chunk,
        seed=CORPUS_SEED, dims=dims_for(hp.Data))


def run_worker(args) -> None:
    """One segment of the run: train to ``max_epochs``, from ``resume_from``
    when given."""
    import torch

    from lets_face_it_tpu_torch.ablation_table1 import require_kernels
    from lets_face_it_tpu_torch.bench import kernel_wrappers
    from lets_face_it_tpu_torch.device_cache_scale_probe import mem_stats, sync
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager
    from lets_face_it_tpu_torch.train.loop import load_datasets, train
    from lets_face_it_tpu_torch.utils.device import resolve_device

    def launches():
        return {name: fn.launches for name, fn in kernel_wrappers().items()}

    device = resolve_device(args.device)
    t_start = time.perf_counter()
    hp = rehearsal_hparams(args)
    require_kernels(FlowSpec.build(hp))
    corpus = rehearsal_corpus(hp, args)
    train_ds, val_ds = load_datasets(hp, corpus)
    spe = train_ds.num_batches(hp.batch_size, drop_last=True)
    k = max(1, args.steps_per_dispatch)
    resumed = CheckpointManager(args.resume_from).latest() if args.resume_from else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    emit("start", pid=os.getpid(), steps_per_epoch=spe, windows_train=len(train_ds),
         windows_val=len(val_ds), resume_from=None if resumed is None else str(resumed),
         resume_step=0 if resumed is None else int(resumed.parent.name),
         setup_s=time.perf_counter() - t_start)
    # an epoch's window: from the end of its first block to its last step,
    # the card synchronised at both ends (the steps' hooks do not wait)
    window = {"start": None, "steps": None, "s": None, "end_t": None}

    def on_step(step, _metrics):
        in_epoch = step % spe
        if window["start"] is None and in_epoch and in_epoch % k == 0:
            sync(device)
            window["start"] = (step, time.perf_counter())
        elif window["start"] is not None and in_epoch == 0:
            sync(device)
            now = time.perf_counter()
            window.update(steps=step - window["start"][0],
                          s=now - window["start"][1], start=None, end_t=now)

    def on_validation(step, _metrics):
        sync(device)
        now = time.perf_counter()
        emit("validation", step=int(step), window_steps=window["steps"], window_s=window["s"],
             val_s=None if window["end_t"] is None else now - window["end_t"],
             memory=mem_stats(device), launches=launches())
        window.update(steps=None, s=None, end_t=None)

    state, best = train(hp, seed=SEED, ckpt_dir=args.ckpt_dir, device=device,
                        corpus=corpus, resume_from=args.resume_from,
                        log_every=args.log_every, step_hook=on_step,
                        val_hook=on_validation)
    emit("done", step=state.step, best_val=best, memory=mem_stats(device),
         launches=launches(), wall_s=time.perf_counter() - t_start)


def read_events(log) -> list[dict]:
    """The ``long_run`` lines of a segment's log, in order."""
    out = []
    for line in Path(log).read_text().splitlines():
        if line.startswith('{"long_run"'):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def segment_summary(log) -> dict:
    """A segment's start and end steps, its kill, its steps a second over
    the epochs' windows, validation seconds, peak device memory and wall."""
    events = read_events(log)
    start = next((e for e in events if e["long_run"] == "start"), {})
    end = next((e for e in events if e["long_run"] == "segment_end"), {})
    vals = [e for e in events if e["long_run"] == "validation"]
    steps = sum(e["window_steps"] or 0 for e in vals)
    secs = sum(e["window_s"] or 0.0 for e in vals)
    val_s = [e["val_s"] for e in vals if e["val_s"] is not None]
    last_step = start.get("resume_step", 0)
    for line in Path(log).read_text().splitlines():
        if line.startswith('{"step"'):
            try:
                last_step = max(last_step, int(json.loads(line)["step"]))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
    peak = max((e["memory"]["peak_reserved"] for e in vals if e.get("memory")),
               default=None)
    return {"log": Path(log).name, "steps_per_epoch": start.get("steps_per_epoch"),
            "resume_from_step": start.get("resume_step"), "last_step": last_step,
            "killed_at_step": end.get("killed_at_step"), "exit_code": end.get("exit_code"),
            "wall_s": end.get("wall_s"), "validations": len(vals),
            "steps_per_sec": steps / secs if secs else None, "timed_steps": steps,
            "val_s_mean": sum(val_s) / len(val_s) if val_s else None,
            "peak_reserved_gib": None if peak is None else peak / GIB}


def notes_for(args, summaries: list[dict]) -> list[str]:
    spe = next((s["steps_per_epoch"] for s in summaries if s["steps_per_epoch"]), None)
    notes = [
        f"production rehearsal on the port: {Path(args.hparams).name} at full width, "
        f"precision {PRECISION} (float32 products, no TF32), "
        f"B={args.batch_size}, steps_per_dispatch k={args.steps_per_dispatch} (one CUDA "
        "graph a block of k steps), device data cache on; a validation and a checkpoint "
        "every epoch",
        f"fixture: the synthetic corpus built in memory (data/synthetic.py, seed "
        f"{CORPUS_SEED}): {args.n_train_chunks} train chunks x {args.frames_per_chunk} "
        f"frames ({spe} steps an epoch), {args.n_val_chunks} val chunks; the JAX record's "
        "1,600 x 400-frame fixture gives the same steps an epoch, and states neither its "
        "val chunks nor its corpus seed",
        f"depth cut: {args.max_epochs} epochs"
        + (f" = {args.max_epochs * spe:,} steps" if spe else "")
        + ", the JAX record's first segment (longrun_a, to its epoch-12 checkpoint); "
          "the record ran 30 epochs (60,180 steps)",
    ]
    for i, s in enumerate(summaries):
        if s["killed_at_step"] is not None and spe:
            nxt = summaries[i + 1] if i + 1 < len(summaries) else None
            resumed = (f"; resumed under supervise_train with --resume_from from the "
                       f"epoch-{nxt['resume_from_step'] // spe} checkpoint (step "
                       f"{nxt['resume_from_step']:,}) in {nxt['log']}"
                       if nxt and nxt["resume_from_step"] else "")
            notes.append(f"{s['log']} killed DELIBERATELY (SIGTERM from the parent) at "
                         f"step ~{s['killed_at_step']:,}, mid-epoch "
                         f"{s['killed_at_step'] // spe + 1}{resumed}")
    for s in summaries:
        sps = s["steps_per_sec"]
        notes.append(
            f"{s['log']}: steps {s['resume_from_step'] or 0:,}-{s['last_step']:,}, "
            + (f"{sps:.3f} steps/s over {s['timed_steps']:,} steps (the card synchronised "
               "at each epoch window's ends, validations excluded), " if sps else "")
            + (f"validations {s['val_s_mean']:.1f} s each, " if s["val_s_mean"] else "")
            + (f"peak device memory reserved {s['peak_reserved_gib']:.2f} GiB, "
               if s["peak_reserved_gib"] is not None else "")
            + (f"wall {s['wall_s']:.1f} s" if s["wall_s"] is not None else "wall not recorded"))
    notes.append("resume replays the (seed, epoch) shuffle, the step generator and "
                 "the optimizer state, so each segment continues the uninterrupted "
                 "run's trajectory (chip_smoke.py step 23 holds a kill/resume equal "
                 "to an uninterrupted run bit for bit)")
    return notes


def checkpoint_differences(a, b) -> list[str]:
    """The entries of two checkpoint files that differ: the model's
    tensors, the optimizer's state and rates, the step generator, the meta
    (empty when the two are equal bit for bit)."""
    import torch

    pa, pb = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
    diffs = [f"state_dict.{k}" for k in sorted(set(pa["state_dict"]) | set(pb["state_dict"]))
             if k not in pa["state_dict"] or k not in pb["state_dict"]
             or not torch.equal(pa["state_dict"][k], pb["state_dict"][k])]
    sa, sb = pa["optimizer"]["state"], pb["optimizer"]["state"]
    if set(sa) != set(sb):
        diffs.append("optimizer.state keys")
    for i in sorted(set(sa) & set(sb)):
        for key in sorted(set(sa[i]) | set(sb[i])):
            va, vb = sa[i].get(key), sb[i].get(key)
            if va is None or vb is None or not torch.equal(torch.as_tensor(va).cpu(),
                                                          torch.as_tensor(vb).cpu()):
                diffs.append(f"optimizer.state.{i}.{key}")
    lrs = [[float(g["lr"]) for g in p["optimizer"]["param_groups"]] for p in (pa, pb)]
    if lrs[0] != lrs[1]:
        diffs.append("optimizer.param_groups.lr")
    if not torch.equal(pa["generator"], pb["generator"]):
        diffs.append("generator")
    if pa["meta"] != pb["meta"]:
        diffs.append("meta")
    return diffs


def run_parent(args) -> int:
    from lets_face_it_tpu_torch import extract_val_curve, supervise_train
    from lets_face_it_tpu_torch.bench import machine
    from lets_face_it_tpu_torch.utils.device import resolve_device

    about = machine(resolve_device(args.device))
    run_dir = Path(args.run_dir)
    ckpt_dir = Path(args.ckpt_dir or REPO / "checkpoints" / "long_run")
    logs = sorted(run_dir.glob("segment_*.log"), key=lambda p: int(p.stem.split("_")[1]))
    if args.resume_only:
        if not logs or not supervise_train.has_checkpoint(ckpt_dir):
            raise SystemExit(f"--resume_only: no run under {run_dir} with a checkpoint "
                             f"in {ckpt_dir}")
    elif logs or supervise_train.has_checkpoint(ckpt_dir):
        raise SystemExit(f"{run_dir} already holds a run: continue it with --resume_only")
    run_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "lets_face_it_tpu_torch.long_run", "--worker",
           "--ckpt_dir", str(ckpt_dir)]
    for flag, _, _ in WORKER_OPTIONS:
        cmd += [flag, str(getattr(args, flag[2:]))]
    if args.resume_only:
        cmd += ["--resume_from", str(ckpt_dir)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
    kill = {"at": None if args.resume_only else args.kill_at_step, "done": []}

    def launch(full) -> int:
        """One worker: its stdout into the next segment's log (validations
        echoed), SIGTERM once a logged step passes the kill step."""
        log = run_dir / f"segment_{len(logs) + 1}.log"
        logs.append(log)
        killed = None
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen(full, stdout=subprocess.PIPE, text=True, env=env,
                                    cwd=REPO)
            try:
                for line in proc.stdout:
                    f.write(line)
                    f.flush()
                    if not line.startswith("{"):
                        continue
                    try:
                        obj = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if "val_loss" in obj or "long_run" in obj:
                        print(line, end="", flush=True)
                    if (kill["at"] is not None and killed is None and not kill["done"]
                            and "train_loss" in obj and obj["step"] >= kill["at"]):
                        proc.send_signal(signal.SIGTERM)
                        killed = int(obj["step"])
                        kill["done"].append(killed)
                        print(json.dumps({"long_run": "kill", "step": killed,
                                          "log": log.name}), flush=True)
                rc = proc.wait()
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            end = {"long_run": "segment_end", "exit_code": rc,
                   "wall_s": time.perf_counter() - t0, "killed_at_step": killed}
            f.write(json.dumps(end) + "\n")
        print(json.dumps(end), flush=True)
        return rc

    rc = supervise_train.supervise(cmd, ckpt_dir, backoff_s=0.0, launch=launch,
                                   retry_crashes=0 if kill["at"] is None else 1)
    summaries = [segment_summary(log) for log in logs]
    unplanned = [s["log"] for s in summaries
                 if s["exit_code"] not in (0, None) and s["killed_at_step"] is None]
    curve = extract_val_curve.extract(logs, notes_for(args, summaries), about)
    curve["segments_summary"] = summaries
    path = extract_val_curve.write(args.out, curve)
    print(f"wrote {path}: {len(logs)} segment(s), "
          f"{sum(s['n_validations'] for s in curve['segments'])} validations", flush=True)
    if unplanned:
        print(f"long_run: {unplanned} ended without a planned kill (exit {rc})",
              file=sys.stderr)
        return rc or 1
    if rc != 0:
        return rc
    if kill["at"] is not None and not kill["done"]:
        print(f"long_run: the run ended before step {kill['at']}; nothing was killed",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worker", action="store_true",
                   help="run one segment in this process (the parent's child)")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoints, <dir>/<step>/checkpoint.pt, about 212 MB each at "
                        "final_model (default checkpoints/long_run)")
    p.add_argument("--resume_from", default=None, help="(worker) checkpoint directory")
    p.add_argument("--run_dir", default=str(REPO / "runs" / "long_run"),
                   help="(parent) the segments' logs")
    p.add_argument("--kill_at_step", type=int, default=None,
                   help="(parent) SIGTERM the worker once its log passes this step")
    p.add_argument("--resume_only", action="store_true",
                   help="(parent) continue the run in RUN_DIR from --ckpt_dir")
    p.add_argument("--out", default=str(REPO / "runs" / "long_run_curve_torch.json"))
    for flag, kind, default in WORKER_OPTIONS:
        p.add_argument(flag, type=kind, default=default)
    args = p.parse_args(argv)
    if args.worker:
        if not args.ckpt_dir:
            p.error("--worker needs --ckpt_dir")
        run_worker(args)
        return 0
    return run_parent(args)


if __name__ == "__main__":
    sys.exit(main())
