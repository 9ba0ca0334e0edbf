"""The validation curve of a training run's JSON-lines stdout logs, as a
compact artifact (the counterpart of ``tools/extract_val_curve.py``).

    python -m lets_face_it_tpu_torch.extract_val_curve LOG [LOG2 ...]
        --out runs/long_run_curve_torch.json [--note "kill at step N ..."]
        [--device cuda]

The trainer prints one JSON object a logged step and one a validation
(``train/loop.py::MetricLogger.scalars``). This keeps the validation rows
(the objects that carry ``val_loss``) of each log as one segment, with the
notes given (kill and resume annotations), so that a run interrupted and
resumed reads as one reviewable curve. The schema is the JAX tool's,
``{"notes": [...], "segments": [{"log", "n_validations", "rows"}]}``, with
the card's name, power limit and host added on top (``device``,
``power_limit_w``, ``host``), as the port's other ``runs/*_torch.json``
files carry them. ``--device cpu`` records the CPU instead.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parse_log(path) -> list[dict]:
    """The validation rows of a JSON-lines log, in order: lines that parse
    as a JSON object carrying ``val_loss``; any other line (a step row, a
    warning, a truncated last line) is skipped."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "val_loss" in obj:
            rows.append(obj)
    return rows


def extract(logs, notes, about: dict) -> dict:
    """The curve of ``logs`` (one segment each, in the order given) with
    ``notes`` and the machine record ``about`` (``bench.machine``)."""
    segments = []
    for log in logs:
        rows = parse_log(log)
        segments.append({"log": Path(log).name, "n_validations": len(rows),
                         "rows": rows})
    return {**about, "notes": list(notes), "segments": segments}


def write(out, curve: dict) -> Path:
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(curve, indent=1) + "\n")
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("logs", nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--note", action="append", default=[])
    p.add_argument("--device", default="cuda",
                   help="the device whose name and power limit the record carries")
    args = p.parse_args(argv)

    from lets_face_it_tpu_torch.bench import machine
    from lets_face_it_tpu_torch.utils.device import resolve_device

    curve = extract(args.logs, args.note, machine(resolve_device(args.device)))
    path = write(args.out, curve)
    total = sum(s["n_validations"] for s in curve["segments"])
    print(f"wrote {path}: {len(curve['segments'])} segment(s), {total} validations")


if __name__ == "__main__":
    main()
