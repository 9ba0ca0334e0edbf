"""Supervise an unattended training run: relaunch it when it stalls, stop
when it crashes (the counterpart of ``tools/supervise_train.py``).

    python -m lets_face_it_tpu_torch.supervise_train --ckpt_dir checkpoints/run \
        [--max_stalls 100] [--retry_crashes 0] [--backoff_s 30] -- \
        python -m lets_face_it_tpu_torch.train hparams/final_model.yaml \
        --ckpt_dir checkpoints/run --stall_timeout_s 900

The command after ``--`` runs as given. When it exits with the stall code
(17, ``utils/watchdog.py``: no step finished within ``--stall_timeout_s``),
it is launched again with ``--resume_from <ckpt_dir>`` appended (once),
but only when that directory holds a committed checkpoint, so that a
stall before the first save starts afresh instead of failing to restore.
A clean exit (0) ends supervision. Any other exit code is a crash and ends
it too, unless ``--retry_crashes N`` allows N of them (a deterministic
failure would only loop). Events go to stdout as JSON lines.

A committed checkpoint is what the port's trainer can restore:
``<ckpt_dir>/<step>/checkpoint.pt`` (``train/checkpoint.py::CheckpointManager``).
``save_checkpoint`` makes the step's directory just before it moves the
file in, so a kill in between leaves an empty numbered directory; the JAX
tool's rule (any numbered directory, orbax's layout) would count it, and
the relaunch would fail with "no checkpoint under".
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager
from lets_face_it_tpu_torch.utils.watchdog import STALL_EXIT_CODE


def log(event: str, **kw) -> None:
    print(json.dumps({"supervisor": event, **kw}), flush=True)


def has_checkpoint(ckpt_dir) -> bool:
    """True iff ``ckpt_dir`` holds a checkpoint the trainer can restore."""
    return bool(CheckpointManager(ckpt_dir).all_steps())


def supervise(cmd: list[str], ckpt_dir, *, max_stalls: int = 100,
              retry_crashes: int = 0, backoff_s: float = 30.0,
              launch=subprocess.call) -> int:
    """Run ``cmd`` under supervision; returns the final exit code.
    ``launch(cmd) -> exit code`` runs one attempt (``subprocess.call``)."""
    stalls = crashes = attempt = 0
    while True:
        attempt += 1
        full = list(cmd)
        if attempt > 1 and "--resume_from" not in full:
            if has_checkpoint(ckpt_dir):
                full += ["--resume_from", str(ckpt_dir)]
            else:
                log("no_checkpoint_yet", ckpt_dir=str(ckpt_dir))
        log("launch", attempt=attempt, cmd=full)
        rc = launch(full)
        if rc == 0:
            log("done", attempt=attempt)
            return 0
        if rc == STALL_EXIT_CODE:
            stalls += 1
            log("stalled", attempt=attempt, stalls=stalls)
            if stalls > max_stalls:
                log("giving_up", reason="max_stalls", stalls=stalls)
                return rc
        else:
            crashes += 1
            log("crashed", attempt=attempt, exit_code=rc, crashes=crashes)
            if crashes > retry_crashes:
                log("giving_up", reason="crash", exit_code=rc)
                return rc
        time.sleep(backoff_s)   # a stalled device or host may need time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt_dir", required=True,
                    help="checkpoint directory appended as --resume_from on "
                         "relaunches (the command's --ckpt_dir)")
    ap.add_argument("--max_stalls", type=int, default=100)
    ap.add_argument("--retry_crashes", type=int, default=0,
                    help="also relaunch after this many other failures "
                         "(default 0: a crash is a bug)")
    ap.add_argument("--backoff_s", type=float, default=30.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- followed by the training command")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no training command given (put it after --)")
    sys.exit(supervise(cmd, args.ckpt_dir, max_stalls=args.max_stalls,
                       retry_crashes=args.retry_crashes, backoff_s=args.backoff_s))


if __name__ == "__main__":
    main()
